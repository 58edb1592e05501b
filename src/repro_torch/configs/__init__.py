"""Config registry: ``get_arch(name)`` / ``ARCHS`` / ``SHAPES``, the
port's copy of `repro.configs` for the architectures it runs.

The port runs the dense families (`yi-9b`, `tinyllama-1.1b`, `yi-6b`,
`qwen2-7b`) and `qwen3-moe-30b-a3b`. The reference's other registered
architectures raise `NotImplementedError` naming the ROADMAP.md item
that brings them; an unknown name raises `KeyError`, as there.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (qwen2_7b, qwen3_moe_30b_a3b,
                                 tinyllama_1_1b, yi_6b, yi_9b)
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES  # noqa: F401

#: where the families this slice does not run come from
LATER = ("ROADMAP.md queue 1, item 11 (the LM/MoE stack: dense, MLA, "
         "rwkv6, mamba2, encoder-decoder and vision families)")

_PORTED = (yi_9b, tinyllama_1_1b, yi_6b, qwen2_7b, qwen3_moe_30b_a3b)
ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _PORTED}
_SMOKES = {m.CONFIG.name: m.smoke_config for m in _PORTED}

#: the reference's registered architectures that are not ported yet
NOT_PORTED = ("deepseek-v3-671b", "rwkv6-1.6b", "internvl2-2b",
              "seamless-m4t-medium", "zamba2-1.2b")


def _known(name: str) -> None:
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; see "
                                  f"{LATER}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{sorted(ARCHS) + sorted(NOT_PORTED)}")


def get_arch(name: str) -> ArchConfig:
    _known(name)
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    _known(name)
    return _SMOKES[name]()
