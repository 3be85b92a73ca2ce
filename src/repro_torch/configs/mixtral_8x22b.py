"""mixtral-8x22b — MoE decoder, 8 experts top-2, sliding-window attention.

A copy of ``repro.configs.mixtral_8x22b`` [arXiv:2401.04088;
hf:mistralai/Mixtral-8x22B]: 56 layers, d_model 6144, 48 query heads over
8 KV heads of 128, d_ff 16384 per expert, vocab 32768 with an untied
head, a 4096-token sliding window (a 4096-slot ring cache at decode).
Every expert product runs on the port's ``expert_matmul`` kernel on the
card; the full config names the expert-parallel layout (``moe_shard``),
which one card reads only as the key of its expert leaves
(``experts_ep``; the reduced config's ``experts_tp``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    ffn="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    attn_window=4096,
    moe_experts=8,
    moe_top_k=2,
    moe_shard="expert",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        ffn="swiglu",
        norm="rmsnorm",
        attn_window=16,
        moe_experts=4,
        moe_top_k=2,
        moe_shard="ffn",
    )
