"""Time the MoE gate's grid choices on one GPU, in turns.

    python3 tools/gate_grid.py

The gate's wrapper launches `grid_plan(T, SMs)` blocks: one for each
`WARPS` rows, at most `BLOCKS_PER_SM` an SM (a persistent grid). This
script times the kernel on the device (`torch.profiler`, as
`chip_smoke.py`'s `device_ms`) at the serve path's prefill shapes
(8,192 x 128, k 8, float32 and bfloat16) and at 65,536 rows with
BLOCKS_PER_SM of 1 to 4, and at decode's 16 rows with the grid forced to
one block (the plan) or two, each choice held to the plain version and
the choices run in order and then reversed. The training calls (the
forward with the probability mean, and the backward, which takes the
same `grid_plan`) at 8,192 x 128, k 8, in both dtypes, with
BLOCKS_PER_SM of 1 to 4, in the same turns. One JSON line a run, after
the card's nvidia-smi line.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.moe_gate import ops, ref
    if not torch.cuda.is_available():
        sys.exit("gate_grid.py needs a CUDA GPU; none is visible")
    dev = torch.device("cuda")
    cs.card()
    plan, per_sm = ops.grid_plan, ops.BLOCKS_PER_SM
    runs = [(T, dt, "blocks_per_sm", n) for T, dt in (
        (8192, torch.float32), (8192, torch.bfloat16),
        (65536, torch.float32)) for n in (1, 2, 3, 4)]
    runs += [(16, torch.float32, "forced_blocks", n) for n in (1, 2)]
    for T, dt, knob, n in runs + runs[::-1]:
        logits = cs._randn((T, 128), T + 128, dev, dt, 0.7)
        bias = torch.zeros(128, device=dev)
        if knob == "forced_blocks":
            ops.grid_plan = lambda t, sms, n=n: n
        else:
            ops.grid_plan, ops.BLOCKS_PER_SM = plan, n
        call = lambda: ops.moe_gate(logits, 8, bias=bias)  # noqa: E731
        got, want = call(), ref.moe_gate_plain(logits, 8, bias, True)
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                and float((got[0] - want[0]).abs().max()) <= cs.GATE_TOL):
            raise AssertionError(f"moe_gate at T={T}, {knob}={n} differs "
                                 f"from its plain version")
        cs.emit(T=T, E=128, k=8, dtype=str(dt).split(".")[-1], **{knob: n},
                blocks=ops.grid_plan(T, ops._sm_count(dev)),
                kernel_device_ms=cs.device_ms(call, "moe_gate_kernel"))
    ops.grid_plan = plan
    train = [(dt, n) for dt in (torch.float32, torch.bfloat16)
             for n in (1, 2, 3, 4)]
    for dt, n in train + train[::-1]:
        ops.BLOCKS_PER_SM = n
        T, E, k = 8192, 128, 8
        logits = cs._randn((T, E), T + E + 7, dev, dt, 0.7)
        gtp, gpm = cs._randn((T, k), 21, dev), cs._randn((E,), 22, dev)
        fwd = lambda: ops.moe_gate(logits, k, None, True,  # noqa: E731
                                   prob_mean=True)
        top_e = fwd()[1]
        bwd = lambda: ops.moe_gate_bwd(logits, top_e, gtp, gpm,  # noqa
                                       True)
        want = ref.moe_gate_grads_plain(logits, k, None, True, gtp, gpm)
        err = float((bwd().float() - want).abs().max() / want.abs().max())
        if err > (cs.GATE_TOL if dt == torch.float32 else 2e-2):
            raise AssertionError(f"moe_gate_bwd at blocks_per_sm={n} "
                                 f"differs from its plain version: {err}")
        cs.emit(T=T, E=E, k=k, dtype=str(dt).split(".")[-1],
                blocks_per_sm=n, blocks=ops.grid_plan(T, ops._sm_count(dev)),
                prob_mean_device_ms=cs.device_ms(fwd),
                bwd_device_ms=cs.device_ms(bwd, "moe_gate_bwd_kernel"),
                bwd_err=err)
    ops.BLOCKS_PER_SM = per_sm


if __name__ == "__main__":
    main()
