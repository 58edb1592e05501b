"""Carry parameters and state from the reference (`repro`) to the port.

The reference's pytrees, taken to numpy with `np.asarray`, become the
port's nested dicts of tensors with the same keys, shapes and dtypes:
the parameters, `extras` (`router_bias`, `placement`) and caches of
`repro.models.lm` (GQA's {"k", "v"} pairs, or MLA's latent arrays, a
bare array under each stack's name; RWKV6's stacked carry {"state",
"shift_a", "shift_f"}; zamba2's {"mamba": {"ssm", "conv"}, "attn_k",
"attn_v"}) and of `repro.models.encdec` ({"self": {"k", "v"}, "cross":
{"k", "v"}}, each (L, B, S, Hkv, Dh)), and the GAIA-MoE state of
`repro.core.gaia_moe` (its `ptr` and `step` as Python ints).

JAX hands bfloat16 out as `ml_dtypes.bfloat16` numpy arrays, which
`torch.from_numpy` refuses. They are told by `dtype.name == "bfloat16"`
and reinterpreted bit for bit (uint16 view), so `ml_dtypes` is never
imported.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    # torch shares the buffer: copy one that is read-only (JAX's are)
    a = np.require(np.asarray(a), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts of numpy arrays (parameters, extras, any of the
    caches above) -> the same of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def gaia_state_from_numpy(state, device="cpu"):
    """The reference's GAIA-MoE state -> the port's (host `ptr` and
    `step`)."""
    out = {k: tensor_from_numpy(v, device) for k, v in state.items()
           if k not in ("ptr", "step")}
    out["ptr"], out["step"] = int(state["ptr"]), int(state["step"])
    return out
