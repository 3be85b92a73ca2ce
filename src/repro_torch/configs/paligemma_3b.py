"""paligemma-3b — VLM: stub SigLIP patch frontend + gemma decoder backbone.

A copy of ``repro.configs.paligemma_3b`` (arXiv:2407.07726;
hf:google/paligemma-3b): 18 layers, d_model 2048, 8 query heads over 1 KV
head of 256 (MQA), GeGLU d_ff 16384, vocab 257216 with a tied head. The
modality frontend is a stub: 256 precomputed patch embeddings (1152 wide,
SigLIP-So400m's width) go through ``patch_proj`` and come before the
text, and attention is prefix-LM (bidirectional over the image prefix,
causal over the text), computed by the port's flash kernel on the card.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    ffn="geglu",
    norm="rmsnorm",
    num_prefix_embeds=256,
    frontend="patch_stub",
    frontend_dim=1152,  # SigLIP-So400m embedding width
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=512,
        head_dim=16,
        ffn="geglu",
        norm="rmsnorm",
        num_prefix_embeds=8,
        frontend="patch_stub",
        frontend_dim=32,
        tie_embeddings=True,
    )
