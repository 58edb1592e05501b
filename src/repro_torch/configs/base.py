"""Architecture / shape / run configuration, the port's copy of
`repro.configs.base` (same classes, field names, defaults and derived
properties, so a test builds both from one dict of fields).

Every assigned architecture gets one module in this package defining a
``CONFIG`` (full published scale, exercised only via the dry-run) and a
``smoke_config()`` (reduced same-family config that runs one real step on
CPU in the test suite).

The shape grid (train_4k / prefill_32k / decode_32k / long_500k) is shared
by all LM-family architectures; per-arch applicability of ``long_500k`` is
recorded on the config (``supports_long_context``) and documented in
DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (seq_len x global_batch + which step it lowers)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0  # per-expert FFN hidden dim
    num_shared_experts: int = 0
    d_shared: int = 0  # shared-expert FFN hidden dim
    first_k_dense: int = 0  # leading layers that stay dense (DeepSeek-V3)
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    # aux-loss-free balancing (DeepSeek-V3): learned per-expert bias added to
    # routing scores, updated outside the gradient.
    aux_free_bias: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block parameters (Zamba2)."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 128
    # decay LoRA ranks (RWKV-6 "Finch" data-dependent decay)
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- family-specific sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # encoder-decoder (seamless-m4t): n_layers applies to each side
    encoder_decoder: bool = False
    # hybrid (zamba2): shared attention block applied every `shared_every`
    # mamba layers, weights shared across invocations.
    shared_every: int = 0
    # vlm: number of vision-frontend tokens prepended (patch embeds are a stub)
    n_vision_tokens: int = 0
    # audio/vlm stub frontend: inputs are precomputed frame/patch embeddings
    embed_frontend: bool = False
    # multi-token prediction depth (DeepSeek-V3 MTP) — extra loss head
    mtp_depth: int = 0
    # does full attention appear anywhere? (decides long_500k applicability)
    supports_long_context: bool = False
    has_decoder: bool = True
    source: str = ""

    # ---------------- derived -----------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards 16-way cleanly."""
        v = self.vocab_size
        return ((v + 255) // 256) * 256

    def shapes(self) -> Tuple[str, ...]:
        """Shape cells applicable to this architecture."""
        cells = ["train_4k", "prefill_32k"]
        if self.has_decoder:
            cells.append("decode_32k")
            if self.supports_long_context:
                cells.append("long_500k")
        return tuple(cells)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for reporting
        and for the MODEL_FLOPS roofline term."""
        d, v = self.d_model, self.padded_vocab
        n = v * d * (1 if self.tie_embeddings else 2)  # embed + lm head
        n += self._block_params() * self.n_layers * (2 if self.encoder_decoder else 1)
        if self.shared_every:
            n += self._attn_params() + 3 * self.d_model * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        dense_block = self._attn_params()
        act = self.padded_vocab * d * 2
        routed = 3 * d * m.d_expert * m.top_k
        shared = 3 * d * m.d_shared * m.num_shared_experts
        router = d * m.num_experts
        moe_layers = self.n_layers - m.first_k_dense
        act += moe_layers * (dense_block + routed + shared + router)
        act += m.first_k_dense * (dense_block + 3 * d * self.d_ff)
        return act

    def _attn_params(self) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        if self.mla is not None:
            c = self.mla
            qh = c.qk_nope_head_dim + c.qk_rope_head_dim
            p = d * c.q_lora_rank + c.q_lora_rank * self.n_heads * qh
            p += d * (c.kv_lora_rank + c.qk_rope_head_dim)
            p += c.kv_lora_rank * self.n_heads * (c.qk_nope_head_dim + c.v_head_dim)
            p += self.n_heads * c.v_head_dim * d
            return p
        if self.family == "ssm" and self.rwkv is not None:
            # rwkv6 time-mix: r,k,v,g,o projections + decay loras
            return (5 * d * d + d * self.rwkv.decay_lora * 2
                    + 5 * d * self.rwkv.mix_lora * 2)
        if self.ssm is not None:
            di = self.ssm.expand * d
            return d * (2 * di + 2 * self.n_heads * self.ssm.d_state) + di * d
        return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

    def _block_params(self) -> int:
        d = self.d_model
        if self.ssm is not None:
            # hybrid (zamba2): mamba blocks carry no MLP; d_ff lives in the
            # shared attention block, counted once in param_count().
            return self._attn_params()
        if self.family == "ssm" and self.rwkv is not None:
            return self._attn_params() + 2 * d * self.d_ff + d * self.d_ff
        if self.moe is not None:
            m = self.moe
            ff = (3 * d * m.d_expert * m.num_experts
                  + 3 * d * m.d_shared * m.num_shared_experts)
            ff += d * m.num_experts
            return self._attn_params() + ff
        return self._attn_params() + 3 * d * self.d_ff


# registry is populated by repro.configs.__init__
