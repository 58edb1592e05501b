"""Time the chunked-WKV kernels against variants of themselves, in turns,
on one GPU.

    python3 tools/wkv_variants.py [--only NAME ...]

Each variant is a copy of `wkv_intra.cu` or `wkv_intra_bwd.cu` (with the
`wkv.cuh` beside them) with text edits (the script raises if an edit's
anchor is gone), built with the port's nvcc flags into a temporary
directory and bound in place of the wrapper's library, so the wrappers'
own calls run it. nvcc's `-Xptxas -v` figures (registers, shared memory,
spills) and the blocks an SM holds
(`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) are printed for each
build; `committed` is the source as it stands.
Variants whose name starts with `no_` drop a part of the work and
compute a wrong result: they show what that part costs (`no_compute`
leaves the loads and stores), and are not held to the plain version;
the others are (`chip_smoke.WKV_FWD_TOL` / `WKV_BWD_TOL`, two calls
bit-equal). A build that nvcc refuses is reported and skipped.

At rwkv6-1.6b's training microbatch (2, 32, 4,096, 64; c 128; the
trained decays of `chip_smoke.wkv_inputs`) each kernel and its variants
run in order and then reversed (`--turns` times). One JSON line a run,
with the device ms (`torch.profiler`, as `chip_smoke.py`'s
`device_ms`), after the card's nvidia-smi line.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/wkv/csrc"
sys.path.insert(0, str(ROOT / "tools"))

from gate_variants import bind  # noqa: E402

FORWARD = {
    "no_off": [("for (int q = 0; q < kQ; ++q) {",
                "for (int q = 0; q < 0; ++q) {")],
    "no_diag": [("for (int qq = 0; qq < 2; ++qq) {",
                 "for (int qq = 0; qq < 0; ++qq) {")],
    "no_factors": [(
        "for (int e = threadIdx.x; e < (nsub - 1) * kSlice * kSub; e += kOff)",
        "for (int e = threadIdx.x; e < 0; e += kOff)")],
    # the slice loops fully unrolled, and the n loop of a float4 rolled
    "unrolled": [("#pragma unroll 1\n", "#pragma unroll\n")],
    "w_rolled": [("#pragma unroll\n        for (int w = 0; w < 4; ++w) {",
                  "#pragma unroll 1\n        for (int w = 0; w < 4; ++w) {")],
    "one_block_an_sm": [("__launch_bounds__(kThreads, 2)",
                         "__launch_bounds__(kThreads, 1)")],
}
FORWARD["no_compute"] = (FORWARD["no_off"] + FORWARD["no_diag"]
                         + FORWARD["no_factors"])
BACKWARD = {
    "no_pair": [("""        for (int j = 0; j < kSub; ++j) {
          const float E""", """        for (int j = 0; j < 0; ++j) {
          const float E""")],
    "no_diag": [("for (int j = 1; j < kSub; ++j) {",
                 "for (int j = 1; j < 0; ++j) {")],
    "no_epilogue": [(
        "#pragma unroll\n  for (int q = 0; q < kMaxChunk / kWarps; ++q) {",
        "#pragma unroll\n  for (int q = 0; q < 0; ++q) {")],
    "two_blocks_an_sm": [("constexpr int kBlocksPerSM = 3;",
                          "constexpr int kBlocksPerSM = 2;")],
    "four_blocks_an_sm": [("constexpr int kBlocksPerSM = 3;",
                           "constexpr int kBlocksPerSM = 4;")],
}
BACKWARD["no_compute"] = BACKWARD["no_pair"] + BACKWARD["no_diag"]


#: appended to each build: the blocks of its kernel an SM holds
OCCUPANCY = {
    "wkv_intra": ("wkv_intra_kernel", "kThreads", "kSmemBytes"),
    "wkv_intra_bwd": ("wkv_intra_bwd_kernel", "kThreads",
                      "kSmemFloats * sizeof(float)"),
}


def build_variant(build, out: Path, stem: str, name: str, edits) -> Path:
    src = (CSRC / f"{stem}.cu").read_text()
    kernel, threads, smem = OCCUPANCY[stem]
    src += (f"\nextern \"C\" int wkv_occupancy(int* blocks) {{\n"
            f"  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor("
            f"blocks, {kernel}, {threads}, {smem}));\n}}\n")
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: anchor not found in {stem}.cu")
        src = src.replace(old, new)
    cu = out / f"{stem}-{name}.cu"
    cu.write_text(src)
    lib = out / f"{stem}-{name}.so"
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        print(f"{stem}-{name}: nvcc failed, skipped\n{res.stdout}"
              f"{res.stderr}"[:2000], flush=True)
        return None
    Path(str(lib) + ".log").write_text(res.stdout + res.stderr)
    return lib


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", nargs="+", default=None,
                   help="variants to run (default: all and the committed "
                        "source)")
    p.add_argument("--turns", type=int, default=1,
                   help="times to run the order and its reverse")
    a = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv import ops, ref
    if not torch.cuda.is_available():
        sys.exit("wkv_variants.py needs a CUDA GPU; none is visible")
    dev = torch.device("cuda")
    cs.card()
    libs = build.build_all()
    B, H, S, N, c = 2, 32, 4096, 64, 128
    x = cs.wkv_inputs(B, H, S, N, c, 31, dev)
    dA = cs._randn((B, H, S // c, c, c), 45, dev)
    want_A = ref.wkv_intra_plain(*x, c)
    want_g = ref.wkv_intra_bwd_plain(*x, dA, c)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        shutil.copy(CSRC / "wkv.cuh", out)
        for kern, stem, variants in ((ops.kernel, "wkv_intra", FORWARD),
                                     (ops.bwd_kernel, "wkv_intra_bwd",
                                      BACKWARD)):
            built = {}
            for name, edits in {"committed": [], **variants}.items():
                if a.only is None or name in a.only:
                    lib = build_variant(build, out, stem, name, edits)
                    if lib is not None:
                        built[name] = lib
            for name, lib in built.items():
                cs.emit(kernel=stem, variant=name,
                        ptxas=build.ptxas_report(lib))
            names = list(built)
            for name in (names + names[::-1]) * a.turns:
                bind(kern, built[name])
                if stem == "wkv_intra":
                    call = lambda: (ops.wkv_intra(*x, c),)  # noqa: E731
                    tol, wants = cs.WKV_FWD_TOL, (want_A,)
                else:
                    call = lambda: ops.wkv_intra_bwd(*x, dA, c)  # noqa
                    tol, wants = cs.WKV_BWD_TOL, want_g
                got = call()
                errs = [float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(got, wants)]
                if not name.startswith("no_") and (max(errs) > tol or not all(
                        torch.equal(g, h) for g, h in zip(got, call()))):
                    raise AssertionError(f"{stem} {name}: errors {errs}, "
                                         f"or two calls differ")
                del got
                ms = cs.device_ms(call, f"{stem}_kernel")
                blocks = ctypes.c_int(0)
                kern._lib.wkv_occupancy(ctypes.byref(blocks))
                cs.emit(kernel=stem, variant=name, errs=errs, device_ms=ms,
                        blocks_an_sm=blocks.value)
            bind(kern, libs[stem])


if __name__ == "__main__":
    main()
