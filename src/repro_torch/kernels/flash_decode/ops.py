"""Wrapper of the hand-written flash-decode kernel
(`csrc/flash_decode.cu`: a split-K partial pass and a combine pass,
launched together).

On a CUDA tensor it checks its inputs, allocates the output and the
float32 partials with `torch.empty`, launches on the current stream and
counts the launch; a launch CUDA refuses raises. On a CPU tensor
it runs the plain version (`ref.py`), and only then: there is no
fallback from the card to the plain code.
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
#: cache rows per split (csrc/flash_decode.cu CHUNK)
CHUNK = 64

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel(
    "flash_decode", "flash_decode_launch",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P,
     _P], errors="flash_decode_error_string")


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
    G = H // Hkv
    check("q", q, DTYPES, (B, H, D), dev)
    check("k_cache", k_cache, (q.dtype,), (B, S, Hkv, D), dev)
    check("v_cache", v_cache, (q.dtype,), (B, S, Hkv, D), dev)
    n_split = -(-S // CHUNK)
    part_m = torch.empty((B * Hkv, n_split, G), dtype=torch.float32,
                         device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * Hkv, n_split, G, D), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    kernel.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), B,
                  S, Hkv, G, D, pos, DTYPES[q.dtype], D ** -0.5,
                  part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                  out.data_ptr())
    return out
