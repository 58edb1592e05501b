"""The kernel builder's Python side, on the CPU: what keys a library
(the source, the headers beside it, the flags) and the reading of
nvcc's `-Xptxas -v` report."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernAPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernAPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernBPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernBPf
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 368 bytes cmem[0]
"""


def _src(tmp_path, body="// kernel\n"):
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    src = csrc / "k.cu"
    src.write_text(body)
    return src


@pytest.mark.parametrize("edit", ["source", "header", "new header", "none"])
def test_library_is_keyed_by_source_and_headers(tmp_path, monkeypatch,
                                                edit):
    """An edit to the source or to any header beside it in csrc/ names a
    new library (so it is rebuilt); nothing else does."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    src = _src(tmp_path)
    (src.parent / "a.cuh").write_text("// helpers\n")
    before = build.library_path(src)
    if edit == "source":
        src.write_text("// kernel, edited\n")
    elif edit == "header":
        (src.parent / "a.cuh").write_text("// helpers, edited\n")
    elif edit == "new header":
        (src.parent / "b.h").write_text("// more\n")
    after = build.library_path(src)
    assert (after != before) == (edit != "none")
    assert after.parent == tmp_path / "out" and after.name.startswith("k-")


def test_headers_are_those_beside_the_source(tmp_path):
    src = _src(tmp_path)
    for name in ("b.cuh", "a.h", "notes.txt"):
        (src.parent / name).write_text("")
    assert [p.name for p in build.headers(src)] == ["a.h", "b.cuh"]
    shipped = {s.stem: [h.name for h in build.headers(s)]
               for s in build.sources()}
    assert shipped["flash_attention"] == ["sm90.cuh"]


def test_ptxas_report_reads_registers_smem_and_spills(tmp_path):
    lib = tmp_path / "k-0123.so"
    assert build.ptxas_report(lib) == []
    (tmp_path / "k-0123.so.log").write_text(PTXAS_LOG)
    assert build.ptxas_report(lib) == [
        {"function": "_Z6kernAPf", "spill_stores": 0, "spill_loads": 0,
         "registers": 94, "smem_bytes": 16},
        {"function": "_Z6kernBPf", "spill_stores": 8, "spill_loads": 12,
         "registers": 255, "smem_bytes": 0}]
