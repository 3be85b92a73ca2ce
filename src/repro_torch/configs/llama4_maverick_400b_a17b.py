"""llama4-maverick-400b-a17b — MoE decoder, 128 experts top-1.

A copy of ``repro.configs.llama4_maverick_400b_a17b`` [hf:meta-llama/
Llama-4-*]: 48 layers, d_model 5120, 40 query heads over 8 KV heads of
128, d_ff 8192 per expert, vocab 202048 with an untied head, 128 experts,
top-1 routing, qk-norm; the text backbone only, every layer MoE. A
decode step routes a few rows to a few of the 128 experts, and the
port's ``expert_matmul`` kernel reads only those experts' weights.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    ffn="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=500000.0,
    moe_experts=128,
    moe_top_k=1,
    moe_shard="expert",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        ffn="swiglu",
        norm="rmsnorm",
        qk_norm=True,
        moe_experts=8,
        moe_top_k=1,
        moe_shard="expert",
    )
