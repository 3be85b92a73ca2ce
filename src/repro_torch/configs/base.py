"""`ModelConfig`: the single source of truth a model is built from, and
`TrainConfig`: the optimizer, schedule and loop settings of a run.

Copies of ``repro.configs.base.ModelConfig`` and ``TrainConfig`` (that
module imports JAX through ``repro.core.quant``), with the same fields
and defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attn-free)
    n_kv_heads: int              # GQA kv heads
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads

    # Block flavour
    ffn: str = "swiglu"          # swiglu | relu2 | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    causal: bool = True
    rope_theta: float = 10000.0
    attn_window: int = 0         # 0 = full attention; >0 = sliding window
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False
    tie_embeddings: bool = False

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_shard: str = "expert"

    # Hybrid (recurrentgemma)
    block_pattern: Tuple[str, ...] = ()
    rnn_width: int = 0
    conv_width: int = 4
    local_window: int = 2048

    # SSM (rwkv6)
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # Modality frontend stubs
    num_prefix_embeds: int = 0
    frontend: str = "none"       # none | patch_stub | frame_stub
    frontend_dim: int = 0

    # Numerics / technique integration
    dtype: str = "bfloat16"
    quant: Optional[QuantConfig] = None
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = True
    logits_softcap: float = 0.0

    # Perf-iteration knobs
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    attn_shard: str = "heads"
    rwkv_chunk: int = 64
    kv_cache_quant: bool = False # int8 KV cache

    def __post_init__(self):
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    def with_quant(self, quant: QuantConfig) -> "ModelConfig":
        return dataclasses.replace(self, quant=quant)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head): JAX's
        formula, the MoE branch included (E experts' FFNs and the (d, E)
        router a layer)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.num_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,o ≈ 5 d²) + decay lora + channel-mix
            per = 5 * d * d + 2 * d * self.rwkv_decay_lora + 2 * d * f
            return emb + L * per
        nq, nkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        ffn = 3 * d * f if self.ffn in ("swiglu", "geglu") else 2 * d * f
        if self.moe_experts:
            ffn = self.moe_experts * ffn + d * self.moe_experts
        if self.block_pattern:
            # hybrid: recurrent blocks replace attention in 2/3 of layers
            n_attn = sum(1 for b in self._expanded_pattern() if b == "attn")
            n_rec = L - n_attn
            rec = 2 * d * self.rnn_width + self.rnn_width * d + 3 * self.rnn_width
            return emb + n_attn * (attn + ffn) + n_rec * (rec + ffn)
        return emb + L * (attn + ffn)

    def active_param_count(self) -> int:
        """MoE: the parameters a token touches (its top-k experts); the
        whole count for every other family."""
        if not self.moe_experts:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        per_expert = (3 if self.ffn in ("swiglu", "geglu") else 2) * d * f
        return self.param_count() - L * (self.moe_experts - self.moe_top_k) * per_expert

    def _expanded_pattern(self) -> Tuple[str, ...]:
        if not self.block_pattern:
            return tuple("attn" for _ in range(self.num_layers))
        out = []
        while len(out) < self.num_layers:
            out.extend(self.block_pattern)
        return tuple(out[: self.num_layers])


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    lr_min_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient-accumulation splits
    grad_compress_bits: int = 0  # 0 = off; 8 → int8 block-quantized gradients
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
