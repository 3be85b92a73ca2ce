"""The port's attention paths share one tile routine: what the CPU can
check of it.

On the card every attention kernel folds keys into a row's online
softmax in 32-key tiles at absolute positions (``csrc/attend_tile.cuh``),
so chunked prefill is bitwise whole-prompt prefill and static decode
bitwise continuous decode; ``chip_smoke.py`` gates that on the H100. Here:
the contiguous-decode entry the static engine now calls is, on the CPU,
exactly its plain version ``common.decode_attention``; a pool block size
that the tile cannot take is refused on every device, so no block size
silently changes the kernels' order.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import TILE, check_block_size
from repro_torch.models import build_model
from repro_torch.models import common as cm
from repro_torch.models.kv_cache import PagedKVCache, quantize_kv
from repro_torch.serving import ContinuousScheduler

RNG = np.random.default_rng(17)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group", [1, 2])
def test_contiguous_decode_entry_is_its_plain_version(int8, group):
    """``ops.decode_attention`` on CPU tensors: bitwise
    ``common.decode_attention`` on a ragged bf16 or int8 cache (empty
    slots -1, one row with no key)."""
    B, S, NKV, H = 3, 40, 2, 16
    q = torch.from_numpy(RNG.standard_normal((B, 1, NKV * group, H))).to(torch.bfloat16)
    k = torch.from_numpy(RNG.standard_normal((B, S, NKV, H)).astype(np.float32))
    v = torch.from_numpy(RNG.standard_normal((B, S, NKV, H)).astype(np.float32))
    lens = torch.tensor([33, 7, 0])
    slots = torch.arange(S)[None].expand(B, S)
    kpos = torch.where(slots < lens[:, None], slots, -1).to(torch.int32)
    pos = (lens - 1).clamp(min=0).to(torch.int32)
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    got = ops.decode_attention(q, k, v, kpos, pos, k_scale=ks, v_scale=vs)
    want = cm.decode_attention(q, k, v, kpos, pos, k_scale=ks, v_scale=vs)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("bs", [1, 2, 4, 8, 16, 32, 64, 128])
def test_block_sizes_the_tile_takes(bs):
    check_block_size(bs)
    cache = PagedKVCache.init(1, 2, 3, bs, 2, 1, 8, device="cpu")
    assert cache.block_size == bs and (TILE % bs == 0 or bs % TILE == 0)


@pytest.mark.parametrize("bs", [3, 12, 24, 48, 100])
def test_block_sizes_the_tile_cannot_take_raise(bs):
    """A block size that neither divides nor tiles the 32-key tile raises
    in the pool, the scheduler and the serve CLI, on the CPU as on the
    card."""
    with pytest.raises(ValueError, match="32-key tile"):
        PagedKVCache.init(1, 2, 3, bs, 2, 1, 8, device="cpu")
    cfg = get_reduced_config("olmo-1b")
    params = build_model(cfg).init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="32-key tile"):
        ContinuousScheduler(cfg, params, block_size=bs, max_ctx=max(bs, 8) * 4,
                            device="cpu")
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="32-key tile"):
        serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--continuous",
                    "--block-size", str(bs), "--requests", "1", "--max-new", "2"])
