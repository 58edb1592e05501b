"""Wrappers of the hand-written fused MoE gate (`csrc/moe_gate.cu`) and
its backward (`csrc/moe_gate_bwd.cu`).

On a CUDA tensor it checks its inputs, allocates the outputs,
launches the kernel on the current stream and counts the launch: a call
is one operation on the device. The blocks add their histograms into
`counts`, which must be zero when the kernel starts; each launch zeroes
the `counts` of the next call at the same expert count (`_counts`), so
no memset runs but on the first call at an expert count. A launch CUDA
refuses raises. On a CPU tensor it runs the plain version (`ref.py`),
and only then: there is no fallback from the card to the plain code.

With `prob_mean` the forward also returns the (E,) mean of the
probabilities over the rows (the aux loss's `frac_probs`) from the same
one kernel: each block adds its rows' sums, as fixed-point integers,
into a device-wide accumulator and draws a ticket, and the last block
divides the exact total by T (`csrc/moe_gate.cu`), so the mean is the
same in every run. The accumulators and the ticket live in one scratch
buffer a device (`_scratch`) that each such launch leaves zero for the
next, under the same one-stream ordering as `_counts`. A call whose
logits need a gradient goes through `MoEGate`, a
`torch.autograd.Function` whose backward is the backward kernel
(persistent blocks, a warp a row at a time): gradients flow into top_p
and the mean; the ids and counts have none, and the bias selects only.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPES, check, on_cuda
from repro_torch.kernels.moe_gate import ref

#: the largest expert count the kernel holds in registers
MAX_E = 512
#: the largest k (one pick per lane of a warp)
MAX_K = 32
#: rows in flight a block, a warp each (WARPS of csrc/moe_gate.cu and
#: csrc/moe_gate_bwd.cu)
WARPS = 16
#: the most blocks a call keeps on each SM: the grid is persistent, and
#: fewer blocks add fewer histograms into the counts
BLOCKS_PER_SM = 2

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel(
    "moe_gate", "moe_gate_launch",
    [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    errors="moe_gate_error_string")

bwd_kernel = build.CudaKernel(
    "moe_gate_bwd", "moe_gate_bwd_launch",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    errors="moe_gate_bwd_error_string")


def grid_plan(T: int, sms: int) -> int:
    """Blocks of a call over T rows on a card of `sms` SMs: one for each
    WARPS rows, at most BLOCKS_PER_SM an SM (their warps then walk the
    rows by grid stride), and at least one, which writes the zero
    histogram when T = 0."""
    return max(1, min(-(-T // WARPS), sms * BLOCKS_PER_SM))


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


#: {(device, E): int32 (E,) that the last launch at E zeroed}
_ZEROED = {}


def _counts(device, E: int):
    """(counts, next): this call's int32 (E,) counts, zeroed by the last
    launch at this E on the device (by `torch.zeros` on the first), and
    a fresh one for this launch to zero for the next call. The caller
    owns `counts` from then on. Reuse assumes the calls that share a
    device are ordered on one stream: a call on another stream could
    find its counts not yet zeroed."""
    counts = _ZEROED.pop((device, E), None)
    if counts is None:
        counts = torch.zeros(E, dtype=torch.int32, device=device)
    nxt = torch.empty(E, dtype=torch.int32, device=device)
    _ZEROED[(device, E)] = nxt
    return counts, nxt


#: uint64 accumulators a probability-mean launch spreads its blocks'
#: atomics over (csrc/moe_gate.cu COPIES)
COPIES = 8
#: {device: the probability-mean launches' scratch}
_SCRATCH = {}


def _scratch(device):
    """The device's scratch of the probability-mean launches: COPIES x
    MAX_E uint64 accumulators and a ticket (int64 words), zeroed once
    here and left zero by every launch."""
    t = _SCRATCH.get(device)
    if t is None:
        t = _SCRATCH[device] = torch.zeros(COPIES * MAX_E + 1,
                                           dtype=torch.int64, device=device)
    return t


def _check(logits, k: int, bias):
    on_cuda("moe_gate", logits)
    if logits.dim() != 2:
        raise ValueError(f"logits: expected (T, E), got {tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= E <= MAX_E:
        raise ValueError(f"E={E} outside the kernel's 1..{MAX_E}")
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"k={k} outside 1..min(E, {MAX_K})")
    dev = logits.device
    check("logits", logits, DTYPES, (T, E), dev)
    if bias is not None:
        check("bias", bias, (torch.float32,), (E,), dev)
    return T, E


def _forward(logits, k: int, bias, norm_topk: bool, prob_mean: bool):
    T, E = _check(logits, k, bias)
    dev = logits.device
    top_p = torch.empty((T, k), dtype=torch.float32, device=dev)
    top_e = torch.empty((T, k), dtype=torch.int32, device=dev)
    counts, nxt = _counts(dev, E)
    blocks = grid_plan(T, _sm_count(dev))
    pm = scratch = None
    if prob_mean:
        pm = torch.empty(E, dtype=torch.float32, device=dev)
        scratch = _scratch(dev).data_ptr()
    kernel.launch(logits.data_ptr(),
                  None if bias is None else bias.data_ptr(), T, E, k,
                  int(norm_topk), DTYPES[logits.dtype], blocks,
                  top_p.data_ptr(), top_e.data_ptr(), counts.data_ptr(),
                  nxt.data_ptr(), None if pm is None else pm.data_ptr(),
                  scratch)
    return (top_p, top_e, counts) + ((pm,) if prob_mean else ())


def moe_gate_bwd(logits, top_e, g_top_p, g_prob_mean, norm_topk: bool):
    """d logits of the gate for the gradients g_top_p (T, k) float32 of
    top_p and g_prob_mean (E,) float32 of the probability mean (either
    may be None: zero), given the forward's picks top_e. A warp
    recomputes a row's softmax, builds d probs in registers (g_top_p
    through the renormalisation, plus g_prob_mean / T) and writes
    p * (d probs - sum(p * d probs)); the grid is `grid_plan`'s, the
    rows walked by grid stride. Returns logits' shape and dtype."""
    T, E = _check(logits, top_e.shape[1], None)
    k = top_e.shape[1]
    dev = logits.device
    check("top_e", top_e, (torch.int32,), (T, k), dev)
    if g_top_p is not None:
        check("g_top_p", g_top_p, (torch.float32,), (T, k), dev)
    if g_prob_mean is not None:
        check("g_prob_mean", g_prob_mean, (torch.float32,), (E,), dev)
    dlogits = torch.empty_like(logits)
    bwd_kernel.launch(logits.data_ptr(), top_e.data_ptr(),
                      None if g_top_p is None else g_top_p.data_ptr(),
                      None if g_prob_mean is None else g_prob_mean.data_ptr(),
                      T, E, k, int(norm_topk), DTYPES[logits.dtype],
                      grid_plan(T, _sm_count(dev)), dlogits.data_ptr())
    return dlogits


class MoEGate(torch.autograd.Function):
    """The gate as a differentiable op on the card: outputs (top_p,
    top_e, counts[, prob_mean]); backward by `moe_gate_bwd`."""

    @staticmethod
    def forward(ctx, logits, bias, k, norm_topk, prob_mean):
        out = _forward(logits, k, bias, norm_topk, prob_mean)
        ctx.mark_non_differentiable(out[1], out[2])
        ctx.save_for_backward(logits, out[1])
        ctx.norm_topk = norm_topk
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_top_p, g_top_e, g_counts, g_prob_mean=None):
        logits, top_e = ctx.saved_tensors
        return (moe_gate_bwd(logits, top_e, _f32(g_top_p), _f32(g_prob_mean),
                             ctx.norm_topk), None, None, None, None)


def _f32(t):
    """An output gradient as the kernel takes it (None: zero)."""
    return None if t is None else t.float().contiguous()


def moe_gate(logits, k: int, bias=None, norm_topk: bool = True,
             prob_mean: bool = False):
    """Softmax over experts, top-k of probs + bias (ties to the lower
    id), the unbiased probabilities of the picks (renormalised to sum 1
    when `norm_topk`) and the per-expert pick counts.

    logits: (T, E) float32 or bfloat16; bias: (E,) float32 or None.
    Returns (top_p (T, k) float32, top_e (T, k) int32, counts (E,)
    int32), and with `prob_mean` the (E,) float32 mean of the
    probabilities too. Differentiable in logits when they need a
    gradient."""
    if logits.device.type == "cpu":
        return ref.moe_gate_plain(logits, k, bias, norm_topk, prob_mean)
    if torch.is_grad_enabled() and logits.requires_grad:
        return MoEGate.apply(logits, bias, k, norm_topk, prob_mean)
    return _forward(logits, k, bias, norm_topk, prob_mean)
