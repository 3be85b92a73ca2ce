"""Core numerics of the PyTorch port held against the JAX package.

Integers bitwise: packed weight bytes, weight codes and scales (the MAE
clipping search included), the fused matmul's int32 accumulator and its
per-row activation scales. The policy grammar packs the same parameter
paths at the same precisions. Float outputs of ``qmatmul`` are compared
at rtol 1e-6: both sides compute ``acc * xs * ws`` per element from the
same integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.core import bitplane as jbp
from repro.core import quant as jq
from repro.core import quantized_linear as jql
from repro.core.precision import parse_policy_spec as jax_policy
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro_torch import convert
from repro_torch.core import bitplane as tbp
from repro_torch.core import quant as tq
from repro_torch.core import quantized_linear as tql
from repro_torch.core.precision import parse_policy_spec as torch_policy
from repro_torch.kernels import ops as tops
from torch_parity import assert_packed_equal, leaves, to_numpy_tree

RNG = np.random.default_rng(11)


def test_mae_fracs_are_jax_linspace():
    assert np.array_equal(tq.MAE_FRACS, np.asarray(jnp.linspace(0.35, 1.0, 32)))


@pytest.mark.parametrize("axis", [1, 0, None])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_mae_optimal_scale_bitwise(bits, axis):
    """The MAE clip search picks JAX's scale on every input: its mean sums
    in XLA-CPU's order (``tq.xla_mean``), so near-tied candidates break
    the same way. 200 seeds of the packing test's input shape; the JAX
    side runs them as one vmapped batch (a kept leading dim leaves each
    reduction's order as it is)."""
    xs = np.stack([(np.random.default_rng(seed).standard_normal((64, 40)) * 0.05)
                   .astype(np.float32) for seed in range(200)])
    want = np.asarray(jax.vmap(lambda x: jq.mae_optimal_scale(x, bits, True, axis=axis))(
        jnp.asarray(xs)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # 200 small searches: pool start-up dominates
    try:
        got = np.stack([tq.mae_optimal_scale(torch.from_numpy(x), bits, True, axis=axis)
                        .numpy() for x in xs])
    finally:
        torch.set_num_threads(threads)
    bad = [seed for seed in range(200) if not np.array_equal(want[seed], got[seed])]
    assert not bad, f"seeds {bad} pick another scale than JAX"


@pytest.mark.parametrize("shape,dims", [((64, 40), (0,)), ((64, 40), (0, 1)),
                                        ((2048, 40), (0,)), ((50000,), (0,)),
                                        ((3, 70, 33), (1, 2))])
def test_xla_mean_bitwise(shape, dims):
    a = np.random.default_rng(len(shape) + sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(jnp.mean(jnp.asarray(a), axis=dims))
    assert np.array_equal(want, tq.xla_mean(torch.from_numpy(a), dims).numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_bytes_bitwise(bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    q = RNG.integers(lo, hi, (64, 24)).astype(np.int32)
    want = np.asarray(jbp.pack_weights(jnp.asarray(q), bits, axis=0))
    got = tbp.pack_weights(torch.from_numpy(q), bits, axis=0)
    assert np.array_equal(want, got.numpy())
    back = tbp.unpack_weights(got, bits, axis=0).numpy()
    assert np.array_equal(back, np.asarray(jbp.unpack_weights(jnp.asarray(want), bits, axis=0)))
    assert np.array_equal(back, q)


@pytest.mark.parametrize("bits,axis", [(2, 1), (4, 1), (8, 1), (4, None)])
def test_quantize_tensor_codes_and_scales_bitwise(bits, axis):
    w = (RNG.standard_normal((64, 48)) * 0.05).astype(np.float32)
    qj, sj = jq.quantize_tensor(jnp.asarray(w), bits, True, axis=axis)
    qt, st = tq.quantize_tensor(torch.from_numpy(w), bits, True, axis=axis)
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("spec", ["w4a8", "w2a6", "w8a8", "w4a8r25"])
def test_pack_weight_bitwise(spec):
    # Seed 112 is one of the inputs on which a mean in another order than
    # XLA's flipped a near-tied w2 candidate.
    w = (np.random.default_rng(112).standard_normal((64, 40)) * 0.05).astype(np.float32)
    cfg_j = jax_policy(spec).default
    cfg_t = torch_policy(spec).default
    assert_packed_equal(jql.pack_weight(jnp.asarray(w), cfg_j),
                        tql.pack_weight(torch.from_numpy(w), cfg_t), spec)


def test_policy_spec_and_matched_paths():
    spec = "w4a8;wo=w8a8;ffn/w_up=w2a8"
    pj, pt = jax_policy(spec), torch_policy(spec)
    assert pj.describe() == pt.describe()
    for path in ("blocks/wq", "blocks/wo", "blocks/ffn/w_up", "blocks/ffn/w_down"):
        cj, ct = pj.for_path(path), pt.for_path(path)
        assert (cj.w_bits, cj.a_bits, cj.mixed_ratio_8b) == (
            ct.w_bits, ct.a_bits, ct.mixed_ratio_8b), path


def test_quantize_params_for_serving_packs_the_same_leaves():
    """The reduced olmo-1b tree packed by both packages under one policy:
    the same paths pack, at the same precisions, to the same bytes."""
    cfg = jax_reduced("olmo-1b")
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    spec = "w4a8;wo=w8a8"
    packed_j = jql.quantize_params_for_serving(params, jax_policy(spec), min_size=1024)
    tparams = convert.params_from_numpy(to_numpy_tree(params), "cpu")
    packed_t = tql.quantize_params_for_serving(tparams, torch_policy(spec), min_size=1024)
    packed_j_np = to_numpy_tree(packed_j)
    lj, lt = dict(leaves(packed_j_np)), dict(leaves(packed_t))
    kinds = {}
    for path, leaf in lt.items():
        if isinstance(leaf, tql.PackedWeight):
            kinds[path] = leaf.bits
    assert kinds == {"blocks/wq": 4, "blocks/wk": 4, "blocks/wv": 4,
                     "blocks/wo": 8, "blocks/ffn/w_gate": 4,
                     "blocks/ffn/w_up": 4, "blocks/ffn/w_down": 4}
    jtree = jax.tree_util.tree_flatten_with_path(
        packed_j, is_leaf=lambda x: isinstance(x, jql.PackedWeight))[0]
    for jpath, jleaf in jtree:
        path = "/".join(str(p.key) for p in jpath)
        if isinstance(jleaf, jql.PackedWeight):
            assert_packed_equal(jleaf, lt[path], path)
    # Unpacked leaves (embedding) are carried verbatim.
    assert np.array_equal(np.asarray(lj["embed"], np.float32),
                          lt["embed"].to(torch.float32).numpy())
    assert tql.packed_weight_bytes(packed_t) == jql.packed_weight_bytes(packed_j)


@pytest.mark.parametrize("spec,plane_lo", [("w4a8", 0), ("w8a8", 1),
                                           ("w2a4", 0), ("w4a8r25", 0)])
def test_qmatmul_matches_jax_kernel_route(spec, plane_lo):
    """qmatmul against JAX `_serve_matmul(use_kernel=True)` (interpret
    Pallas): accumulator and activation scales bitwise, outputs within
    rtol 1e-6."""
    x = RNG.standard_normal((6, 64)).astype(np.float32)
    w = (RNG.standard_normal((64, 40)) * 0.05).astype(np.float32)
    pj = jql.pack_weight(jnp.asarray(w), jax_policy(spec).default)
    if plane_lo:
        pj = jql.PackedWeight(pj.packed, pj.scale, pj.bits, pj.k, pj.n8,
                              pj.packed8, pj.a_bits, pj.act_signed, plane_lo)
    pt = convert.params_from_numpy(to_numpy_tree(pj), "cpu")
    xj, xt = jnp.asarray(x), torch.from_numpy(x)

    acc_j, s_j = jops.fused_quantize_matmul(
        xj, jql.unpack_weight(pj, apply_plane_lo=False), a_bits=pj.a_bits,
        act_signed=pj.act_signed, w_plane_lo=plane_lo)
    kw = dict(a_bits=pt.a_bits, act_signed=pt.act_signed, w_plane_lo=plane_lo)
    acc_t, s_t = tops.fused_quantize_matmul(xt, pt.packed, w_bits=pt.bits, **kw)
    if pt.n8:
        acc8, s8 = tops.fused_quantize_matmul(xt, pt.packed8, w_bits=8, **kw)
        assert torch.equal(s8, s_t)
        acc_t = torch.cat([acc8, acc_t], dim=1)
    assert np.array_equal(np.asarray(acc_j), acc_t.numpy())
    assert np.array_equal(np.asarray(s_j), s_t.numpy())

    y_j = np.asarray(jql._serve_matmul(xj, pj, None, use_kernel=True))
    y_t = tql.qmatmul(xt, pt).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-6, atol=1e-7)
