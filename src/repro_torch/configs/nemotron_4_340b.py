"""nemotron-4-340b — dense GQA transformer, squared-ReLU FFN.

A copy of ``repro.configs.nemotron_4_340b`` [arXiv:2402.16819]: 96
layers, d_model 18432, 96 query heads over 8 KV heads of 192, d_ff 73728,
vocab 256000 with an untied head, layernorm, RoPE. The largest assigned
arch: one card holds it at full width with its depth cut.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    ffn="relu2",
    norm="layernorm",
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke",
        family="dense",
        num_layers=3,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab=512,
        ffn="relu2",
        norm="layernorm",
    )
