"""hubert-xlarge — encoder-only audio transformer (wav2vec2-style backbone).

A copy of ``repro.configs.hubert_xlarge`` (arXiv:2106.07447): 48 layers,
d_model 1280, 16 heads of 80 (MHA), GELU d_ff 5120, layernorm,
bidirectional attention (``causal=False``), an untied 504-wide
cluster-target head. The CNN feature extractor is a stub: precomputed
frame embeddings (512 wide) go through ``frame_proj``. Encoder-only, so
the serve CLI refuses it, as the JAX package's does.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    ffn="gelu",
    norm="layernorm",
    causal=False,
    frontend="frame_stub",
    frontend_dim=512,  # w2v2/HuBERT conv feature-extractor width
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        family="encoder",
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=32,
        ffn="gelu",
        norm="layernorm",
        causal=False,
        frontend="frame_stub",
        frontend_dim=16,
    )
