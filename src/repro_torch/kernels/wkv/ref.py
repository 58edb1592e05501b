"""Plain PyTorch versions of the chunked-WKV intra-chunk kernels.

`wkv_intra_plain` builds the term as the reference's `chunk_step` does
(`src/repro/models/rwkv6.py:117-120`): for each chunk the (B, H, c, c,
N) exponentials, the entries on or above the diagonal selected away by
`torch.where` (never multiplied by a 0/1 mask: their exponent is
positive and may be inf), times r and k, summed over N. One chunk's
tensor exists at a time. `wkv_intra_bwd_plain` writes out the gradients
the backward kernel computes, from the same masked exponentials:

    dr[t, n] = sum_{i<t} dA[t, i] k[i, n] e[t, i, n]
    dk[i, n] = sum_{t>i} dA[t, i] r[t, n] e[t, i, n]
    dl_prev = r dr,  dl = -k dk

The CPU path runs both (also in float64, for the tests) and
`chip_smoke.py` holds the kernels to them on the card.
"""
from __future__ import annotations

import torch


def _exps(lpc, lc):
    """(B, H, c, c, N): exp(l_prev[t] - l[i]) for i < t, else 0."""
    c = lpc.shape[2]
    tri = torch.ones((c, c), dtype=torch.bool, device=lpc.device).tril(-1)
    return torch.where(tri[:, :, None],
                       torch.exp(lpc[:, :, :, None, :] - lc[:, :, None, :, :]),
                       0.0)


def _chunks(chunk: int, *ts):
    """Each (B, H, S, N) tensor cut into its S / chunk chunks."""
    return zip(*(t.split(chunk, 2) for t in ts))


def wkv_intra_plain(r, k, l_prev, l, chunk: int):
    """A (B, H, S / chunk, chunk, chunk): A[t, i] = sum_n r[t, n] k[i, n]
    exp(l_prev[t, n] - l[i, n]) for i < t within each chunk, else 0.
    r, k, l_prev, l: (B, H, S, N)."""
    out = []
    for rc, kc, lpc, lc in _chunks(chunk, r, k, l_prev, l):
        rk = _exps(lpc, lc) * rc[:, :, :, None, :]
        out.append((rk * kc[:, :, None, :, :]).sum(-1))
        del rk  # at most two (B, H, c, c, N) tensors at once
    return torch.stack(out, 2)


def wkv_intra_bwd_plain(r, k, l_prev, l, dA, chunk: int):
    """(dr, dk, dl_prev, dl), each (B, H, S, N), for the gradient dA
    (B, H, S / chunk, chunk, chunk) of `wkv_intra_plain`."""
    drs, dks = [], []
    for j, (rc, kc, lpc, lc) in enumerate(_chunks(chunk, r, k, l_prev, l)):
        m = _exps(lpc, lc) * dA[:, :, j, :, :, None]
        drs.append((m * kc[:, :, None, :, :]).sum(3))
        dks.append((m * rc[:, :, :, None, :]).sum(2))
        del m
    dr, dk = torch.cat(drs, 2), torch.cat(dks, 2)
    return dr, dk, r * dr, -k * dk
