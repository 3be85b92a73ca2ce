"""rwkv6-3b — "Finch": attention-free RNN with data-dependent decay.

A copy of ``repro.configs.rwkv6_3b`` (arXiv:2404.05892;
hf:RWKV/rwkv-6-world-3b): 32 layers, d_model 2560 (40 heads of 64),
d_ff 8960 (channel-mix with squared ReLU), vocab 65536. The wkv6 mixer
runs through the port's CUDA kernel on the card.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    ffn="relu2",
    norm="layernorm",
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=128,
        vocab=512,
        ffn="relu2",
        norm="layernorm",
        rwkv_head_dim=16,
        rwkv_decay_lora=8,
    )
