"""nemotron-4-15b — dense GQA transformer, squared-ReLU FFN.

[arXiv:2402.16819] 32L, d_model 6144, 48 Q heads, 8 KV heads (GQA),
d_ff 24576, vocab 256000. Nemotron-4 uses squared-ReLU MLPs (2 matrices),
RoPE, LayerNorm, untied embeddings, no biases.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    ffn="relu2",
    norm="layernorm",
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        ffn="relu2",
        norm="layernorm",
    )
