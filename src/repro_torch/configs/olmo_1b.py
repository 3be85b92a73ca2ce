"""olmo-1b — dense MHA transformer with non-parametric LayerNorm.

[arXiv:2402.00838; hf:allenai/OLMo-1B] 16L, d_model 2048, 16 heads
(kv=16 → MHA), d_ff 8192, vocab 50304. Non-parametric LayerNorm (no
scale/bias), SwiGLU, tied embeddings, no biases.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    ffn="swiglu",
    norm="nonparam_ln",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        ffn="swiglu",
        norm="nonparam_ln",
        tie_embeddings=True,
    )
