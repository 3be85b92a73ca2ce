"""recurrentgemma-9b — Griffin hybrid: RG-LRU recurrence + local attention.

A copy of ``repro.configs.recurrentgemma_9b`` (arXiv:2402.19427): 38
layers as 12 x (rglru, rglru, attn) plus a remainder of 2 recurrent
layers, d_model 4096, rnn_width 4096, 16 query heads of 256 over 1 KV
head (MQA), GeGLU d_ff 12288, vocab 256000 with an untied head, local
attention window 2048 (a 2048-slot ring cache), conv width 4. The
RG-LRU runs through the port's ``rglru`` kernel on the card.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    ffn="geglu",
    norm="rmsnorm",
    block_pattern=("rglru", "rglru", "attn"),
    rnn_width=4096,
    conv_width=4,
    local_window=2048,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=512,
        head_dim=16,
        ffn="geglu",
        norm="rmsnorm",
        block_pattern=("rglru", "rglru", "attn"),
        rnn_width=64,
        conv_width=4,
        local_window=16,
    )
