"""Config registry: ``get_arch(name)`` / ``get_shape(name)`` / ``ARCHS`` /
``SHAPES``, the port's copy of `repro.configs` for the architectures it
runs.

The port runs every architecture the reference registers: the dense
families (`yi-9b`, `tinyllama-1.1b`, `yi-6b`, `qwen2-7b`),
`qwen3-moe-30b-a3b`, `deepseek-v3-671b`, the recurrent families
(`rwkv6-1.6b`, `zamba2-1.2b`), the encoder-decoder
`seamless-m4t-medium` and the vision-token `internvl2-2b`. An unknown
name raises `KeyError`, as there.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_v3_671b, internvl2_2b, qwen2_7b,
                                 qwen3_moe_30b_a3b, rwkv6_1_6b,
                                 seamless_m4t_medium, tinyllama_1_1b, yi_6b,
                                 yi_9b, zamba2_1_2b)
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES  # noqa: F401

_PORTED = (yi_9b, tinyllama_1_1b, yi_6b, qwen2_7b, qwen3_moe_30b_a3b,
           deepseek_v3_671b, rwkv6_1_6b, zamba2_1_2b, seamless_m4t_medium,
           internvl2_2b)
ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _PORTED}
_SMOKES = {m.CONFIG.name: m.smoke_config for m in _PORTED}

#: the reference's registered architectures that are not ported yet
NOT_PORTED = ()


def _known(name: str) -> None:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def get_arch(name: str) -> ArchConfig:
    _known(name)
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    _known(name)
    return _SMOKES[name]()


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
