"""Time the MoE gate's training kernels against variants of themselves,
in turns, on one GPU.

    python3 tools/gate_variants.py

Each variant is a copy of `moe_gate.cu` or `moe_gate_bwd.cu` with one
text edit (the script raises if an edit's anchor is gone), built with
the port's nvcc flags into a temporary directory and bound in place of
the wrapper's library, so the wrappers' own calls run it:

* `fence_ticket`: the forward's ticket drawn with a fence and a relaxed
  `atomicAdd` (and a second fence in the last block) in place of one
  acquire-release atomic;
* `full_norm`: the backward's renormalisation sums over all 32 lanes and
  its two quotients as IEEE divisions (`/`), as before the redesign;
* `approx_p`: the backward's softmax quotient as v times the refined
  reciprocal, without the residual correction (p within an ulp of the
  forward's), and the renormalisation as one quotient of
  (g - gs / s) by s.

At 8,192 x 128, k 8, float32 and bfloat16, each kernel and its variants
run in order and then reversed; each result is held to the plain version
(the mean within `chip_smoke.GATE_TOL`, d logits within it in float32
and within 2e-2 in bfloat16). One JSON line a run, with the device ms
(`torch.profiler`, as `chip_smoke.py`'s `device_ms`), after the card's
nvidia-smi line.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/moe_gate/csrc"

FORWARD = {
    "fence_ticket": [(
        """        unsigned drawn;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                     : "=r"(drawn) : "l"(ticket) : "memory");
        last = drawn == gridDim.x - 1;""",
        """        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        if (last) __threadfence();""")],
}
BACKWARD = {
    "full_norm": [(
        """    float s = raw, gs = in.g * raw;
    for (int o = span >> 1; o > 0; o >>= 1) {
      s += __shfl_xor_sync(FULL, s, o);
      gs += __shfl_xor_sync(FULL, gs, o);
    }
    const float sc = fmaxf(s, 1e-9f), sc2 = sc * sc;
    const float q = quotient(in.g, sc, refined_rcp(sc));
    d_raw = s >= 1e-9f ? q - quotient(gs, sc2, refined_rcp(sc2)) : q;""",
        """    const float s = warp_sum(raw);
    const float gs = warp_sum(in.g * raw);
    const float sc = fmaxf(s, 1e-9f);
    d_raw = s >= 1e-9f ? in.g / sc - gs / (sc * sc) : in.g / sc;""")],
    "approx_p": [(
        "  softmax_row<EPL>(p);  // 0 past E",
        """  {
    float m = p[0];
#pragma unroll
    for (int i = 1; i < EPL; ++i) m = fmaxf(m, p[i]);
    const float mx = float_of(__reduce_max_sync(FULL, key_of(m + 0.f)));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      p[i] = expf(p[i] - mx);
      sum += p[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    const float r = refined_rcp(sum);
#pragma unroll
    for (int i = 0; i < EPL; ++i) p[i] *= r;
  }"""), (
        """    const float sc = fmaxf(s, 1e-9f), sc2 = sc * sc;
    const float q = quotient(in.g, sc, refined_rcp(sc));
    d_raw = s >= 1e-9f ? q - quotient(gs, sc2, refined_rcp(sc2)) : q;""",
        """    const float sc = fmaxf(s, 1e-9f), r = refined_rcp(sc);
    d_raw = quotient(s >= 1e-9f ? in.g - quotient(gs, sc, r) : in.g, sc,
                     r);""")],
}


def build_variant(build, out: Path, stem: str, name: str, edits) -> Path:
    src = (CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: anchor not found in {stem}.cu")
        src = src.replace(old, new)
    cu = out / f"{name}.cu"
    cu.write_text(src)
    lib = out / f"{name}.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    return lib


def bind(kern, lib: Path):
    """Point a `build.CudaKernel` at another library of its interface."""
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, kern.entry)
    fn.argtypes, fn.restype = [*kern.argtypes, ctypes.c_void_p], ctypes.c_int
    err = getattr(dll, kern.errors)
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kern._lib, kern._fn, kern._err = dll, fn, err


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_gate import ops, ref
    if not torch.cuda.is_available():
        sys.exit("gate_variants.py needs a CUDA GPU; none is visible")
    dev = torch.device("cuda")
    cs.card()
    libs = build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        shutil.copy(CSRC / "gate_rows.cuh", out)
        fwd_libs = {"committed": libs["moe_gate"], **{
            n: build_variant(build, out, "moe_gate", n, e)
            for n, e in FORWARD.items()}}
        bwd_libs = {"committed": libs["moe_gate_bwd"], **{
            n: build_variant(build, out, "moe_gate_bwd", n, e)
            for n, e in BACKWARD.items()}}
        T, E, k = 8192, 128, 8
        for dt in (torch.float32, torch.bfloat16):
            logits = cs._randn((T, E), T + E + 7, dev, dt, 0.7)
            gtp, gpm = cs._randn((T, k), 21, dev), cs._randn((E,), 22, dev)
            want = ref.moe_gate_plain(logits, k, None, True, prob_mean=True)
            wg = ref.moe_gate_grads_plain(logits, k, None, True, gtp, gpm)
            top_e = want[1].contiguous()
            tol = cs.GATE_TOL if dt == torch.float32 else 2e-2
            names = list(fwd_libs)
            for name in names + names[::-1]:
                bind(ops.kernel, fwd_libs[name])
                fwd = lambda: ops.moe_gate(logits, k, None, True,  # noqa
                                           prob_mean=True)
                pm = fwd()[3]
                err = float((pm - want[3]).abs().max())
                if err > cs.GATE_TOL or bool(ops._scratch(dev).any()):
                    raise AssertionError(f"forward {name}: mean err {err}")
                cs.emit(kernel="moe_gate_prob_mean", variant=name,
                        dtype=str(dt).split(".")[-1], prob_mean_err=err,
                        device_ms=cs.device_ms(fwd))
            bind(ops.kernel, libs["moe_gate"])
            names = list(bwd_libs)
            for name in names + names[::-1]:
                bind(ops.bwd_kernel, bwd_libs[name])
                bwd = lambda: ops.moe_gate_bwd(logits, top_e, gtp, gpm,  # noqa
                                               True)
                g = bwd()
                err = float((g.float() - wg).abs().max() / wg.abs().max())
                if err > tol or not torch.equal(g, bwd()):
                    raise AssertionError(f"backward {name}: err {err}")
                cs.emit(kernel="moe_gate_bwd", variant=name,
                        dtype=str(dt).split(".")[-1], max_abs_err=err,
                        device_ms=cs.device_ms(bwd, "moe_gate_bwd_kernel"))
            bind(ops.bwd_kernel, libs["moe_gate_bwd"])


if __name__ == "__main__":
    main()
