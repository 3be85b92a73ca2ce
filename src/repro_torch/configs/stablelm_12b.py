"""stablelm-12b — dense GQA transformer with per-head QK norm.

[hf:stabilityai/stablelm-2-12b] 40L, d_model 5120, 32 Q heads, 8 KV heads,
d_ff 13824, vocab 100352. StableLM-2 uses LayerNorm, SwiGLU and per-head
qk-layernorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    ffn="swiglu",
    norm="layernorm",
    qk_norm=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        ffn="swiglu",
        norm="layernorm",
        qk_norm=True,
    )
