"""Wrapper of the hand-written flash-decode kernel
(`csrc/flash_decode.cu`: split-K over the cache and the merge of the
splits in one launch).

On a CUDA tensor it checks its inputs, allocates the output, launches
on the current stream and counts the launch; a launch CUDA refuses
raises. The float32 partials and the merge tickets live in a workspace
allocated once per device and grown only when a larger shape arrives
(`workspace`), so a call allocates nothing else. On a CPU tensor it
runs the plain version (`ref.py`), and only then: there is no fallback
from the card to the plain code.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPES, check, on_cuda
from repro_torch.kernels.flash_decode import ref

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: the largest query group per KV head
MAX_G = 8
#: cache rows per tile (csrc/flash_decode.cu TILE)
CHUNK = 64
#: blocks a call aims for: 8 blocks of 128 threads on each of 132 SMs
SPLIT_BLOCKS = 8 * 132
#: the most splits of one (batch, KV head) (csrc/flash_decode.cu)
MAX_SPLITS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel(
    "flash_decode", "flash_decode_launch",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P,
     _P], errors="flash_decode_error_string")

#: {device: (float32 partials, int32 tickets)}, reused by every call
_WORKSPACE = {}


def split_plan(B: int, Hkv: int, pos: int):
    """(splits, tiles a split) for the cache rows 0..pos of each of the
    B * Hkv (batch, KV head) pairs: the rows are cut into CHUNK-row
    tiles, a pair gets at most SPLIT_BLOCKS // (B * Hkv) (and at most
    MAX_SPLITS) splits of whole tiles, and no split is empty."""
    n_tiles = pos // CHUNK + 1
    per_pair = max(1, min(MAX_SPLITS, SPLIT_BLOCKS // max(1, B * Hkv)))
    tps = -(-n_tiles // min(n_tiles, per_pair))
    return -(-n_tiles // tps), tps


def workspace_floats(B: int, Hkv: int, D: int, n_split: int) -> int:
    """float32 partials a call needs: (m, l, acc) of MAX_G heads for each
    split of each (batch, KV head) pair; none with a single split."""
    return 0 if n_split == 1 else B * Hkv * n_split * MAX_G * (D + 2)


def workspace(device, n_floats: int, n_tickets: int):
    """The device's workspace with room for `n_floats` partials and
    `n_tickets` tickets, grown (never shrunk) as shapes arrive. The
    tickets start at 0 and every call leaves them at 0. Reuse assumes
    the calls that share a device are ordered on one stream: two calls
    in flight at once on two streams would share the partials and the
    tickets."""
    part, tick = _WORKSPACE.get(device, (None, None))
    if part is None or part.numel() < n_floats:
        part = torch.empty(max(n_floats, 1), dtype=torch.float32,
                           device=device)
    if tick is None or tick.numel() < n_tickets:
        tick = torch.zeros(max(n_tickets, 1), dtype=torch.int32,
                           device=device)
    _WORKSPACE[device] = (part, tick)
    return part, tick


def flash_decode(q, k_cache, v_cache, pos: int):
    """Attention of one query token per sequence to the cached positions
    0..pos. q: (B, Hq, D); caches: (B, S, Hkv, D) with Hkv dividing Hq
    (query head h reads KV head h // (Hq // Hkv)); pos: a Python int,
    0 <= pos < S. One dtype, float32 or bfloat16. Returns (B, Hq, D)."""
    pos = int(pos)
    if q.device.type == "cpu":
        return ref.flash_decode_plain(q, k_cache, v_cache, pos)
    on_cuda("flash_decode", q)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("flash_decode: q is (B, Hq, D), caches "
                         "(B, S, Hkv, D)")
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    if Hkv < 1 or H % Hkv or H // Hkv > MAX_G:
        raise ValueError(f"{H} query heads over {Hkv} KV heads: the group "
                         f"must be whole and at most {MAX_G}")
    if not 0 <= pos < S:
        raise ValueError(f"pos={pos} outside the cache's 0..{S - 1}")
    dev = q.device
    check("q", q, DTYPES, (B, H, D), dev)
    check("k_cache", k_cache, (q.dtype,), (B, S, Hkv, D), dev)
    check("v_cache", v_cache, (q.dtype,), (B, S, Hkv, D), dev)
    n_split, tps = split_plan(B, Hkv, pos)
    part, tick = workspace(dev, workspace_floats(B, Hkv, D, n_split),
                           B * Hkv)
    out = torch.empty_like(q)
    kernel.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), B,
                  S, Hkv, H // Hkv, D, pos, DTYPES[q.dtype], D ** -0.5,
                  n_split, tps, part.data_ptr(), tick.data_ptr(),
                  out.data_ptr())
    return out
