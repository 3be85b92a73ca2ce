"""The port's optimizer and gradient compression held against the JAX
package: AdamW (``optim.adamw``) step by step on the cases of
``tests/test_optim.py``, the cosine schedule, global-norm clipping, and
the int8 error-feedback compression of ``parallel.collectives``.

Every comparison is bitwise on identical float32 inputs: the port
computes JAX's expressions op by op (its sqrt correctly rounded, as
XLA's is), so nothing here needs a tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.optim import adamw as jadamw
from repro.parallel import collectives as jcoll
from repro_torch import tree as tr
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import adamw
from repro_torch.parallel import collectives

RNG = np.random.default_rng(21)


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _equal(jtree, ttree):
    for k in jtree:
        a = np.asarray(jtree[k], np.float32)
        b = ttree[k].float().numpy()
        assert np.array_equal(a, b), (k, np.abs(a - b).max())


@pytest.mark.parametrize("kw", [
    dict(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0),     # the quadratic
    dict(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10),      # decay split
    dict(lr=3e-3, warmup_steps=4, total_steps=20, weight_decay=0.1),     # the CLI's shape
])
def test_adamw_steps_bitwise_jax(kw):
    """Ten AdamW steps on a matrix, a vector and a scalar leaf from random
    gradients: params, both moments, the step and lr bitwise JAX's. Both
    take one linear schedule (the cosine's float32 cos rounds apart by an
    ulp in the two packages, ``test_cosine_schedule_matches_jax``)."""
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    p0 = {"mat": RNG.standard_normal((6, 40)).astype(np.float32),
          "vec": RNG.standard_normal(7).astype(np.float32),
          "s": np.float32(0.5)}
    jp, tp = _jax(p0), _torch(p0)
    js, ts = jadamw.init_state(jp), adamw.init_state(tp)
    for _ in range(10):
        g = {k: RNG.standard_normal(np.shape(v)).astype(np.float32) for k, v in p0.items()}
        jp, js, jlr = jadamw.apply_updates(jp, _jax(g), js, jtc,
                                           lambda s: kw["lr"] * (s / 10))
        tp, ts, tlr = adamw.apply_updates(tp, _torch(g), ts, tc,
                                          lambda s: kw["lr"] * (s / 10))
        assert float(jlr) == float(tlr)
        _equal(jp, tp)
        _equal(js.mu, ts.mu)
        _equal(js.nu, ts.nu)
        assert int(js.step) == int(ts.step) and ts.step.dtype == torch.int32


def test_adamw_converges_on_quadratic():
    tc = TrainConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(params)
    lr_fn = adamw.cosine_schedule(tc)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.apply_updates(params, g, state, tc, lr_fn)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_weight_decay_only_on_matrices():
    tc = TrainConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10)
    params = {"mat": torch.ones((4, 4)), "vec": torch.ones((4,))}
    zero_g = tr.map_tree(torch.zeros_like, params)
    p2, _, _ = adamw.apply_updates(params, zero_g, adamw.init_state(params), tc)
    assert float((p2["vec"] - 1.0).abs().max()) < 1e-7
    assert float(p2["mat"].max()) < 1.0


def test_update_is_in_place_and_bf16_cast_back():
    """The step writes into the given tensors (the port's one departure:
    no second copy of the state at full width); a bf16 leaf stays bf16,
    its update computed in float32 and cast back as JAX does."""
    tc = TrainConfig(lr=0.1, warmup_steps=0, total_steps=10)
    w = RNG.standard_normal((3, 5)).astype(np.float32)
    g = RNG.standard_normal((3, 5)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    ts = adamw.init_state(tp)
    before = tp["w"]
    jp, js, _ = jadamw.apply_updates(jp, {"w": jnp.asarray(g, jnp.bfloat16)},
                                     jadamw.init_state(jp), JaxTrainConfig(**vars(tc)))
    tp, ts2, _ = adamw.apply_updates(tp, {"w": torch.from_numpy(g).to(torch.bfloat16)},
                                     ts, tc)
    assert tp["w"] is before and ts2.mu["w"] is ts.mu["w"]
    assert tp["w"].dtype == torch.bfloat16 and ts2.mu["w"].dtype == torch.float32
    _equal(jp, tp)
    _equal(js.mu, ts2.mu)


def test_large_leaf_updates_by_slices_bitwise():
    """A leaf past the slice size is updated a slice of its first dim at a
    time; elementwise, so the values are the one-shot update's."""
    tc = TrainConfig(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.1)
    w = RNG.standard_normal((5, 3, 8)).astype(np.float32)
    g = RNG.standard_normal((5, 3, 8)).astype(np.float32)
    out = []
    for elems in (1 << 25, 48):          # one shot; slices of 2 layers
        old, adamw._UPDATE_ELEMS = adamw._UPDATE_ELEMS, elems
        try:
            p = {"w": torch.from_numpy(w.copy())}
            p, st, _ = adamw.apply_updates(p, {"w": torch.from_numpy(g)},
                                           adamw.init_state(p), tc)
            out.append((p["w"], st.nu["w"]))
        finally:
            adamw._UPDATE_ELEMS = old
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_clip_by_global_norm_bitwise_jax():
    g = {"a": np.full((10,), 3.0, np.float32), "b": np.full((10,), 4.0, np.float32)}
    clipped, norm = adamw.clip_by_global_norm(_torch(g), 1.0)
    np.testing.assert_allclose(float(norm), float(np.sqrt(250.0)), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(clipped)), 1.0, rtol=1e-5)
    rnd = {"x": RNG.standard_normal((17, 9)).astype(np.float32),
           "y": RNG.standard_normal(33).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        jc, jn = jadamw.clip_by_global_norm(_jax(rnd), max_norm)
        tc_, tn = adamw.clip_by_global_norm(_torch(rnd), max_norm)
        assert float(jn) == float(tn)
        _equal(jc, tc_)


@pytest.mark.parametrize("warm,total,floor", [(10, 100, 0.1), (0, 50, 0.0), (4, 20, 0.1)])
def test_cosine_schedule_matches_jax(warm, total, floor):
    """JAX's expression op by op; float32 cos is not correctly rounded in
    either package (XLA's and PyTorch's CPU cos part by an ulp on some
    arguments, a few ulps of the result where cos is near 0), so within
    2e-7 of lr = 1; the warmup and the floor exactly."""
    tc = TrainConfig(lr=1.0, warmup_steps=warm, total_steps=total, lr_min_ratio=floor)
    jlr = jadamw.cosine_schedule(JaxTrainConfig(**vars(tc)))
    tlr = adamw.cosine_schedule(tc)
    for s in range(0, total + 6):
        a, b = np.float32(jlr(jnp.asarray(s))), tlr(s).numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-7)
        if s <= warm or s >= total:
            assert a == b, s
        assert float(tlr(torch.tensor(s, dtype=torch.int32))) == float(b)


def test_cosine_schedule_shape():
    tc = TrainConfig(lr=1.0, warmup_steps=10, total_steps=100, lr_min_ratio=0.1)
    lr = adamw.cosine_schedule(tc)
    assert float(lr(0)) < 0.11
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert float(lr(55)) < 1.0
    assert abs(float(lr(100)) - 0.1) < 1e-6


def test_moments_are_fp32_and_param_shaped():
    st = adamw.init_state({"w": torch.ones((3, 5), dtype=torch.bfloat16)})
    assert st.mu["w"].dtype == torch.float32 and st.mu["w"].shape == (3, 5)
    assert st.nu["w"] is not st.mu["w"]


@pytest.mark.parametrize("n,bits,block", [(37 * 19, 8, 256), (5, 8, 256), (1000, 4, 64),
                                          (256, 8, 256)])
def test_quantize_block_bitwise_jax(n, bits, block):
    x = (RNG.standard_normal(n) * 3).astype(np.float32)
    x[:3] = 0.0
    jq, js = jcoll.quantize_block(jnp.asarray(x), bits, block)
    tq, ts = collectives.quantize_block(torch.from_numpy(x), bits, block)
    assert np.array_equal(np.asarray(jq), tq.numpy()) and tq.dtype == torch.int8
    assert np.array_equal(np.asarray(js), ts.numpy())
    shape = (n,)
    assert np.array_equal(np.asarray(jcoll.dequantize_block(jq, js, shape, block)),
                          collectives.dequantize_block(tq, ts, shape, block).numpy())


def test_compress_gradients_bitwise_jax():
    """Three rounds of error-feedback compression (the error carried):
    codes, scales, new error and decompressed gradients bitwise JAX's,
    for a float32 matrix, a zero vector and a bf16 leaf; wire bytes
    equal."""
    g0 = {"a": (RNG.standard_normal((37, 19)) * 3).astype(np.float32),
          "b": np.zeros(5, np.float32),
          "c": RNG.standard_normal((4, 70)).astype(np.float32)}
    jg = {**_jax(g0), "c": jnp.asarray(g0["c"], jnp.bfloat16)}
    tg = {**_torch(g0), "c": torch.from_numpy(g0["c"]).to(torch.bfloat16)}
    je, te = jcoll.init_error(jg), collectives.init_error(tg)
    assert all(te[k].dtype == torch.float32 for k in te)
    for _ in range(3):
        jcomp, je, jdeq = jcoll.compress_gradients(jg, je)
        tcomp, te, tdeq = collectives.compress_gradients(tg, te)
        for k in g0:
            assert np.array_equal(np.asarray(jcomp[k][0]), tcomp[k][0].numpy())
            assert np.array_equal(np.asarray(jcomp[k][1]), tcomp[k][1].numpy())
            assert tdeq[k].dtype == tg[k].dtype
        _equal(je, te)
        _equal(jdeq, tdeq)
    assert jcoll.compressed_bytes(jg) == collectives.compressed_bytes(tg)
