"""The MoE layer of the port (``models/moe.py``) and its kernel's plain
version, held against the JAX package on the CPU.

``moe_apply``'s output and aux loss against JAX's ``moe_apply`` on the
reduced mixtral-8x22b (top-2, ``experts_tp``) and llama4-maverick (top-1,
``experts_ep``) at N = 1, 7 and 64 tokens: float32 within 1e-5, bf16
within 3.1e-2 absolute, 2 ulps of bf16 in [2, 4) where the largest
outputs lie (the expert FFN's gate, up and hidden rows are each rounded
to bf16, after sums taken in another order than XLA's; 1.6e-2 seen). The routing (top-k indices and
weights, the stable sort, the keep mask, the destinations) is bitwise
the one JAX's code computes, also at N = 64 where llama4 drops tokens
(JAX's ``test_moe_capacity_drops_are_bounded`` case), and under a
router that ties experts on purpose (the lower index wins, as
``jax.lax.top_k``). The capacity is JAX's over a grid of (N, k, E,
factor), read from the buffer shape of JAX's traced ``moe_apply``.
``init_moe``'s tree has JAX's paths, shapes and dtypes; the converter
carries JAX's MoE trees byte for byte; ``param_count`` and
``active_param_count`` are JAX's for all ten archs; ``expert_matmul``'s
plain version is the einsum with zero rows past the counts, and the
kernel's ctypes signature follows its C source.
"""
import ctypes
import dataclasses
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.kernels import build, expert_matmul, ops, ref
from repro_torch.models import build_model, moe
from torch_parity import leaves, np_of, to_numpy_tree

MOE_ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]
F32_TOL = 1e-5
BF16_TOL = 2 * 2.0 ** -6


def _cfgs(arch, dtype="float32", **over):
    return (dataclasses.replace(jax_reduced(arch), dtype=dtype, **over),
            dataclasses.replace(get_reduced_config(arch), dtype=dtype, **over))


@pytest.fixture(scope="module")
def layers():
    """Per (arch, dtype): (JAX cfg, JAX moe params of one layer, port cfg,
    the same params in the port), built once."""
    out = {}
    for arch in MOE_ARCHS:
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _cfgs(arch, dtype)
            jp = jmoe.init_moe(jax.random.PRNGKey(6), jcfg)
            out[arch, dtype] = (jcfg, jp, tcfg,
                                convert.params_from_numpy(to_numpy_tree(jp), "cpu"))
    return out


def _x(n, d, dtype, seed=0):
    """(1, n, d) rows in both packages; at n = 64 JAX's own drop case's
    rows (``jax.random.normal(PRNGKey(6))``)."""
    if n == 64:
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (1, n, d), jnp.float32))
    else:
        x = np.random.default_rng(seed).standard_normal((1, n, d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))


@partial(jax.jit, static_argnums=2)
def _jax_routing(params, x, cfg):
    """The routing arrays of JAX's ``moe_apply`` (its lines, unchanged):
    gate weights and indices, the sort order, keep and dest."""
    N, d = x.shape[0] * x.shape[1], x.shape[2]
    E, K = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(N, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], axis=-1)
    gate_w, gate_idx = jax.lax.top_k(probs, K)
    if K > 1:
        gate_w = gate_w / jnp.sum(gate_w, axis=-1, keepdims=True)
    cap = int(-(-N * K // E) * cfg.moe_capacity_factor)
    cap = max(8, -(-cap // 8) * 8)
    flat_expert = gate_idx.reshape(-1)
    order = jnp.argsort(flat_expert)
    se = flat_expert[order]
    counts = jnp.bincount(flat_expert, length=E)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]])
    pos_in_e = jnp.arange(N * K, dtype=jnp.int32) - starts[se].astype(jnp.int32)
    keep = pos_in_e < cap
    dest = jnp.where(keep, se * cap + pos_in_e, E * cap)
    return gate_w, gate_idx, order, keep, dest


def _check_routing(jp, tp, jx, tx, jcfg, tcfg):
    gw, gi, order, keep, dest = map(np.asarray, _jax_routing(jp, jx, jcfg))
    r = moe.route(tx.reshape(-1, tx.shape[-1]), tp["router"], tcfg)
    cap = _jax_cap(jcfg, jx.shape[1])
    assert r.cap == cap
    assert np.array_equal(r.gate_idx.numpy(), gi)
    np.testing.assert_allclose(r.gate_w.numpy(), gw, atol=1e-6, rtol=0)
    assert np.array_equal(r.order.numpy(), order)
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.dest.numpy(), dest)
    kept = np.bincount(gi.reshape(-1), minlength=tcfg.moe_experts).clip(max=cap)
    assert np.array_equal(r.counts.numpy(), kept)
    return r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,factor", [(1, 1.25), (7, 1.25), (64, 1.25), (64, 1.0)],
                         ids=["N1", "N7", "N64", "N64-drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(layers, arch, n, factor, dtype):
    """out and aux against JAX's ``moe_apply``; the routing bitwise JAX's.
    N = 64 takes the rows of JAX's drop case; there no expert overflows at
    the configs' capacity factor 1.25 (cap 40 for mixtral's loads of
    38/30/29/31, 16 for llama4's at most 11), so the case runs again at
    factor 1.0 (cap 32 and 8), where 6 and 9 assignments drop, and their
    slots come out zero in both packages."""
    jcfg, jp, tcfg, tp = layers[arch, dtype]
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=factor)
    jx, tx = _x(n, tcfg.d_model, dtype)
    jout, jaux = jax.jit(jmoe.moe_apply, static_argnums=2)(jp, jx, jcfg)
    tout, taux = moe.moe_apply(tp, tx, tcfg)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape and taux.dtype == torch.float32
    atol, rtol = (F32_TOL, F32_TOL) if dtype == "float32" else (BF16_TOL, 0)
    np.testing.assert_allclose(np_of(tout), np.asarray(jout.astype(jnp.float32)), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    r = _check_routing(jp, tp, jx, tx, jcfg, tcfg)
    drops = int((~r.keep).sum())
    assert (drops > 0) == (factor == 1.0)
    # A token whose every slot dropped comes out zero in both.
    gone = np.setdiff1d(np.arange(n), r.order.numpy()[r.keep.numpy()] // tcfg.moe_top_k)
    assert not np.asarray(jout.astype(jnp.float32))[0, gone].any()
    assert not np_of(tout)[0, gone].any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_go_to_the_lower_index(layers, arch):
    """A router whose columns repeat makes every token tie those experts:
    the port picks JAX's (the lower index), and the output follows."""
    jcfg, jp, tcfg, _ = layers[arch, "float32"]
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    jp = {**jp, "router": jnp.asarray(router)}
    tp = convert.params_from_numpy(to_numpy_tree(jp), "cpu")
    jx, tx = _x(24, tcfg.d_model, "float32", seed=3)
    r = _check_routing(jp, tp, jx, tx, jcfg, tcfg)
    idx = r.gate_idx.numpy()
    assert (idx == 1).any() and not (idx == 3).any()
    jout, _ = jax.jit(jmoe.moe_apply, static_argnums=2)(jp, jx, jcfg)
    np.testing.assert_allclose(moe.moe_apply(tp, tx, tcfg)[0].numpy(), np.asarray(jout),
                               atol=F32_TOL, rtol=F32_TOL)


def _jax_cap(cfg, n):
    """The capacity JAX's ``moe_apply`` gives the buffer: the middle dim of
    its expert products in the traced computation."""
    p = jax.eval_shape(partial(jmoe.init_moe, cfg=cfg), jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((1, n, cfg.d_model), jnp.float32)
    jaxpr = jax.make_jaxpr(partial(jmoe.moe_apply, cfg=cfg))(p, x)
    caps = set()

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general" and eqn.outvars[0].aval.ndim == 3:
                caps.add(eqn.outvars[0].aval.shape[1])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    assert len(caps) == 1, caps
    return caps.pop()


@pytest.mark.parametrize("experts,k", [(4, 2), (8, 1), (128, 1), (8, 2)])
def test_capacity_is_jaxs(experts, k):
    """``moe.capacity`` over N in {1, 7, 64, 100, 1280} and factors 1.0,
    1.25, 2.0 and 16 is the buffer depth of JAX's traced ``moe_apply``."""
    base = dataclasses.replace(jax_reduced("mixtral-8x22b"), moe_experts=experts,
                               moe_top_k=k, d_model=16, d_ff=16)
    for factor in (1.0, 1.25, 2.0, 16.0):
        cfg = dataclasses.replace(base, moe_capacity_factor=factor)
        for n in (1, 7, 64, 100, 1280):
            assert moe.capacity(n, k, experts, factor) == _jax_cap(cfg, n), (n, factor)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_has_jaxs_moe_layout(arch):
    """The port's init (bf16, as served) has JAX's paths, shapes and
    dtypes: ``blocks/moe/router`` (L, d, E) float32, the experts (L, E, d,
    f) under ``experts_tp`` (mixtral reduced) or ``experts_ep``, no dense
    ``ffn``."""
    jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
    jl = {p: a for p, a in leaves(jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0)))}
    tl = dict(leaves(build_model(tcfg).init(seed=0, device="cpu")))
    assert sorted(tl) == sorted(jl)
    for p, a in tl.items():
        assert tuple(a.shape) == jl[p].shape and str(a.dtype)[6:] == jl[p].dtype.name, p
    group = "experts_tp" if arch.startswith("mixtral") else "experts_ep"
    E, d, f, L = tcfg.moe_experts, tcfg.d_model, tcfg.d_ff, tcfg.num_layers
    assert tl["blocks/moe/router"].shape == (L, d, E)
    assert tl["blocks/moe/router"].dtype == torch.float32
    assert tl[f"blocks/moe/{group}/w_gate"].shape == (L, E, d, f)
    assert tl[f"blocks/moe/{group}/w_down"].shape == (L, E, f, d)
    assert not any(p.startswith("blocks/ffn") for p in tl)
    assert moe.expert_group(tcfg) == group


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_converter_carries_moe_trees(arch):
    """JAX's bf16 MoE params cross into the port byte for byte (the
    router in float32, the stacked experts in bf16)."""
    raw = jax.jit(jax_build(jax_reduced(arch)).init)(jax.random.PRNGKey(1))
    tl = dict(leaves(convert.params_from_numpy(to_numpy_tree(raw), "cpu")))
    moe_paths = [p for p, _ in leaves(raw) if p.startswith("blocks/moe/")]
    assert len(moe_paths) == 4
    for p, a in leaves(raw):
        t = tl[p]
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16)), p
        else:
            assert np.array_equal(t.numpy(), np.asarray(a)), p


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_are_jaxs(arch):
    """``param_count`` and ``active_param_count`` of all ten archs, full
    and reduced, are JAX's (the MoE branch: E experts' FFNs and the router
    a layer; a token touches its top-k)."""
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_reduced_config(arch), jax_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()


def test_expert_matmul_plain_version():
    """``ref.expert_matmul_ref`` is the einsum with each expert's rows at
    or past its count zero (also a count past cap, and inf in a dead row
    of xe), in xe's dtype; ``ops.expert_matmul`` runs it on the CPU and
    counts no launch."""
    rng = np.random.default_rng(5)
    xe = torch.from_numpy(rng.standard_normal((4, 8, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 24, 16)).astype(np.float32))
    counts = torch.tensor([0, 3, 8, 11], dtype=torch.int32)
    xe[1, 5] = float("inf")
    want = torch.einsum("ecd,edf->ecf", xe, w)
    ops.reset_launch_counts()
    for got in (ref.expert_matmul_ref(xe, w, counts), ops.expert_matmul(xe, w, counts)):
        assert got.dtype == torch.float32 and got.shape == (4, 8, 16)
        for e, c in enumerate([0, 3, 8, 8]):
            assert torch.equal(got[e, :c], want[e, :c])
            assert not got[e, c:].any()
    xb, wb = xe.to(torch.bfloat16), w.to(torch.bfloat16)
    got = ops.expert_matmul(xb, w, counts)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[2], torch.einsum("cd,df->cf", xb[2], wb[2]))
    assert ops.launch_counts()["expert_matmul"] == 0


def test_expert_matmul_kernel_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors only (no fallback);
    its plan is dense_matmul's slice plan of (K, N) and a tiling by cap."""
    xe = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((2, 16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        expert_matmul.launch(xe, w, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="bfloat16"):
        expert_matmul.launch(xe.float(), w, torch.zeros(2, dtype=torch.int32))
    from repro_torch.kernels import dense_matmul

    for cap, K, N in ((8, 5120, 8192), (400, 6144, 16384), (8, 16384, 6144)):
        S, sk, bm = expert_matmul.launch_plan(cap, K, N)
        assert (S, sk) == (dense_matmul.plan(K, N), dense_matmul.slice_k(K, N))
        assert bm == (128 if cap > 64 else 64)


def test_expert_matmul_argtypes_match_the_source():
    """The wrapper's ctypes argtypes follow the C entry's parameters one
    for one, and the source is in the build list."""
    src = (build.CSRC / "expert_matmul.cu").read_text()
    params = re.search(r'extern "C" int expert_matmul\(([^)]*)\)', src).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert expert_matmul.ARGTYPES == want
    assert "expert_matmul" in build.KERNELS and "expert_matmul" in ops.launch_counts()


def test_a_one_layer_stack_larger_than_a_draw_is_drawn(monkeypatch):
    """A stacked leaf whose first dim is 1 (one layer, as llama4-maverick
    serves cut to ``--layers 1``) and whose size passes ``DRAW_BYTES`` is
    drawn as the leaf below it, in that leaf's slices. Before the repair
    ``normal_init`` sliced such a leaf into one slice of itself and
    recursed without end, allocating the whole leaf at each level (on the
    card: out of memory drawing llama4's 10 GiB expert leaf)."""
    from repro_torch.models import common as cm

    monkeypatch.setattr(cm, "DRAW_BYTES", 64)
    one = cm.normal_init(torch.Generator().manual_seed(4), (1, 3, 8), 0.5, torch.bfloat16)
    below = cm.normal_init(torch.Generator().manual_seed(4), (3, 8), 0.5, torch.bfloat16)
    assert one.shape == (1, 3, 8) and one.dtype == torch.bfloat16
    assert torch.equal(one[0], below) and bool(torch.isfinite(one).all())
