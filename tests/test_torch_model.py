"""The port's transformer (chunked prefill + paged decode) held against
the JAX model on a float32 copy of the reduced olmo-1b config.

Weights are JAX's, packed by JAX under the serving policy and carried
across with ``repro_torch.convert.params_from_numpy``. The two sides
compute the packed linear layers differently — the port contracts the
integer codes (the kernel route), the JAX model the dequantized floats —
so logits agree at float32 rounding, not bitwise: atol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.core.quantized_linear import quantize_params_for_serving
from repro.models import build_model as jax_build
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.models import transformer as ttf
from torch_parity import to_numpy_tree

ATOL = 1e-3
TABLE = [[1, 2, 3, -1], [4, 5, -1, -1]]
PROMPTS = {0: np.arange(10) * 7 % 512, 1: (np.arange(5) * 13 + 3) % 512}


def _configs(kv_int8):
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    tcfg = dataclasses.replace(torch_reduced("olmo-1b"), dtype="float32",
                               kv_cache_quant=kv_int8)
    return jcfg, tcfg


def _chunks(n, lc):
    return [(s, min(lc, n - s)) for s in range(0, n, lc)]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_chunks_and_decode_match_jax(kv_int8):
    jcfg, tcfg = _configs(kv_int8)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jparams = quantize_params_for_serving(params, jax_policy("w4a8;wo=w8a8"),
                                          min_size=1024)
    tparams = convert.params_from_numpy(to_numpy_tree(jparams), "cpu")

    jcache = jtf.init_paged_cache(jcfg, batch=2, num_blocks=9, block_size=4,
                                  max_blocks=4)
    jcache = dataclasses.replace(jcache, kv=dataclasses.replace(
        jcache.kv, block_table=jnp.asarray(TABLE, jnp.int32)))
    tcache = ttf.init_paged_cache(tcfg, 2, 9, 4, 4, device="cpu")
    tcache.kv.block_table.copy_(torch.tensor(TABLE))
    jchunk = jax.jit(jtf.prefill_chunk, static_argnums=(1,))
    jdecode = jax.jit(jtf.decode_step, static_argnums=(1,))

    lc = 8
    for slot, prompt in PROMPTS.items():
        blocks = np.asarray([b for b in TABLE[slot] if b >= 0], np.int32)
        for start, t in _chunks(len(prompt), lc):
            toks = np.zeros((1, lc), np.int32)
            toks[0, :t] = prompt[start:start + t]
            jcache, lj = jchunk(jparams, jcfg, jcache, {
                "tokens": jnp.asarray(toks), "lengths": jnp.asarray([t], jnp.int32),
                "start": jnp.int32(start), "slot": jnp.int32(slot),
                "blocks": jnp.asarray(blocks)})
            tcache, lt = ttf.prefill_chunk(tparams, tcfg, tcache, {
                "tokens": torch.from_numpy(toks.astype(np.int64)), "lengths": [t],
                "start": start, "slot": slot, "blocks": torch.from_numpy(blocks)})
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == [10, 5]

    cur = np.asarray([[3], [5]], np.int32)
    for _ in range(3):
        jcache, lj = jdecode(jparams, jcfg, jcache, jnp.asarray(cur))
        tcache, lt = ttf.decode_step(tparams, tcfg, tcache, torch.from_numpy(cur))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
        cur = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == [13, 8]
    # The pools hold the same K/V: float32 values to rounding, int8 codes
    # within one step (a value within rounding of a half-code boundary).
    jk = np.asarray(jcache.kv.k)
    tk = tcache.kv.k.numpy()
    live = [b for row in TABLE for b in row if b >= 0]
    diff = np.abs(tk[:, live].astype(np.float32) - jk[:, live].astype(np.float32))
    assert diff.max() <= (1 if kv_int8 else ATOL)


def test_init_draws_large_leaves_in_bounded_slices(monkeypatch):
    """A leaf up to ``DRAW_BYTES`` of float32 is one draw (the values of
    one ``torch.randn`` call); a larger one is drawn slice by slice along
    its first dim, each slice at most ``DRAW_BYTES``, into a tensor of the
    leaf's dtype with the same law."""
    from repro_torch.models import common as tcm

    gen = torch.Generator().manual_seed(3)
    one = tcm.normal_init(gen, (4, 32, 48), 0.5, torch.bfloat16)
    want = (torch.randn((4, 32, 48), generator=torch.Generator().manual_seed(3)) * 0.5)
    assert torch.equal(one, want.to(torch.bfloat16))
    sizes = []
    real = torch.randn
    monkeypatch.setattr(tcm, "DRAW_BYTES", 4 * 32 * 48 * 3)
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: sizes.append(shape) or real(
        shape, **kw))
    big = tcm.normal_init(torch.Generator().manual_seed(3), (8, 32, 48), 0.5, torch.bfloat16)
    assert sizes == [(3, 32, 48), (3, 32, 48), (2, 32, 48)]
    assert big.shape == (8, 32, 48) and big.dtype == torch.bfloat16
    assert abs(big.float().std().item() - 0.5) < 0.02
