"""MoE training in the port held against the JAX package on the CPU.

The reduced mixtral-8x22b (top-2, ``experts_tp``, a 16-token window) and
llama4-maverick (top-1, ``experts_ep``) in float32 with JAX's weights
carried across: ``train_loss``'s total, ``loss`` and ``aux_loss`` (the
router's Switch loss summed over the layers) and every leaf's gradient,
router and experts included, at capacity factor 1.25 and at 1.0, where
tokens are dropped; mixtral under QAT ``w4a8`` (against JAX unscanned, as
``test_torch_train.py`` holds the dense families: its scanned body turns
``absmax / qmax`` into a reciprocal product); two steps of
``make_train_step``. Then the expert product's gradient: the plain
``expert_matmul_bwd_ref`` against autograd through ``expert_matmul_ref``
(rows past the count holding non-zeros, an expert with count 0), the
``ExpertMatmul`` Function's wiring on the card's route (its launches
swapped for the plain versions), the backward entries' ctypes signatures
against the source, and the train CLI on an MoE arch.

Tolerances. Model level: each leaf's gradient within 1e-5 of its max
|gradient| (float32 sums in another order), the total and the loss within
1e-6 relative, the aux loss within 1e-6 (it averages probabilities; JAX's
own ``moe_apply`` aux is held within 1e-6 in ``test_torch_moe.py``). The
routing is checked bitwise first (every layer's top-k choices and kept
rows equal JAX's on these batches), so no expert flip stands behind a
difference. Train steps: loss 1e-6 and grad norm 1e-5 relative, params
1e-4 (AdamW moves each parameter by about lr, so a near-zero gradient's
sign decides its update). Under QAT the attention projections' activation
codes can move by one at a rounding boundary (see
``test_torch_train.py``): the same 1e-5 of max |g| held there holds here.
"""
import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.launch.dryrun import _parse_quant as jax_quant
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.train.loop import init_train_state as jax_init_state
from repro.train.loop import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch import tree as tr
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import parse_quant_token
from repro_torch.data import DataIterator
from repro_torch.kernels import build, expert_matmul, ops, ref, registry
from repro_torch.models import build_model, moe
from repro_torch.train.loop import init_train_state, make_train_step
from torch_parity import to_numpy_tree

MOE_ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]
GRAD_TOL = 1e-5
B, T = 4, 32


def _cfgs(arch, factor=1.25, qat=None, **over):
    over = dict(dtype="float32", moe_capacity_factor=factor, **over)
    jcfg = dataclasses.replace(jax_reduced(arch), **over)
    tcfg = dataclasses.replace(get_reduced_config(arch), **over)
    if qat:
        jcfg, tcfg = jcfg.with_quant(jax_quant(qat)), tcfg.with_quant(parse_quant_token(qat))
    return jcfg, tcfg


def _port_params(jparams):
    return convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


def _batch(tcfg, i=0):
    return DataIterator(tcfg, global_batch=B, seq_len=T, seed=1, branch=4).batch_at(i)


def _jax_routes(monkeypatch):
    """Record the top-k indices of every ``jax.lax.top_k`` call JAX's
    ``moe_apply`` makes while a jitted function traced under it runs (a
    callback on its output): the forward's layers in order first, then
    remat's recomputation in the backward."""
    seen = []
    top_k = jax.lax.top_k

    def recording(probs, k):
        out = top_k(probs, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), out[1])
        return out

    monkeypatch.setattr(jmoe.jax.lax, "top_k", recording)
    return seen


def _port_routes(monkeypatch):
    """Record every ``moe.route`` call's (top-k indices, keep) of the port."""
    seen = []
    route = moe.route

    def recording(xt, router, cfg):
        r = route(xt, router, cfg)
        seen.append((r.gate_idx.detach().numpy().copy(), r.keep.numpy().copy()))
        return r

    monkeypatch.setattr(moe, "route", recording)
    return seen


def _loss_and_grads(model, params, batch):
    live = tr.map_tree(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = model.train_loss(live, batch)
    grads = torch.autograd.grad(total, tr.leaves(live), allow_unused=True)
    return total, metrics, [torch.zeros_like(p) if g is None else g
                            for p, g in zip(tr.leaves(live), grads)]


def _check_grads(jg, tg):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        a, key = np.asarray(a), jax.tree_util.keystr(path)
        err = np.abs(a - b.numpy()).max()
        assert err <= GRAD_TOL * max(np.abs(a).max(), 1e-30), (key, err, np.abs(a).max())


@pytest.fixture(scope="module")
def jax_models():
    """Per arch: (JAX model, JAX params), the params drawn once."""
    out = {}
    for arch in MOE_ARCHS:
        jm = jax_build(_cfgs(arch)[0])
        out[arch] = jm.init(jax.random.PRNGKey(0))
    return out


@pytest.mark.parametrize("factor", [1.25, 1.0], ids=["cap1.25", "cap1.0-drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_loss_and_grads_match_jax(jax_models, arch, factor, monkeypatch):
    """The total, loss, aux loss and every leaf's gradient of a
    data-pipeline batch, float32, JAX's weights carried across; the
    routing of every layer first held bitwise JAX's (top-k and kept rows),
    and at factor 1.0 some tokens dropped."""
    jcfg, tcfg = _cfgs(arch, factor)
    jparams = jax_models[arch]
    jm, tm = jax_build(jcfg), build_model(tcfg)
    batch = _batch(tcfg)
    jidx = _jax_routes(monkeypatch)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jax.effects_barrier()
    monkeypatch.undo()
    routes = _port_routes(monkeypatch)
    tl, tmet, tg = _loss_and_grads(tm, _port_params(jparams), batch)
    # In each package the forward's routes, then remat's recomputation of
    # each block in the backward, which routes alike.
    L = tcfg.num_layers
    assert tcfg.remat and len(routes) == 2 * L and len(jidx) >= L
    for (idx, keep), j in zip(routes[:L], jidx[:L]):
        assert np.array_equal(idx, j)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(routes[L:], routes[L - 1::-1]))
    dropped = sum(int((~keep).sum()) for _, keep in routes[:L])
    assert dropped > 0 or factor > 1.0, dropped
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["loss"].detach()), float(jmet["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["aux_loss"].detach()), float(jmet["aux_loss"]),
                               rtol=0, atol=1e-6)
    assert float(tmet["aux_loss"].detach()) > 0 and tmet["aux_loss"].dtype == torch.float32
    assert float(tl.detach()) == pytest.approx(
        float(tmet["loss"].detach()) + 0.01 * float(tmet["aux_loss"].detach()), rel=1e-7)
    _check_grads(jg, tg)


def test_mixtral_qat_loss_and_grads_match_jax_unscanned(jax_models):
    """Under QAT w4a8 the attention projections are fake-quantized and the
    experts and router are not (JAX's ``_expert_ffn`` calls no
    ``linear``): the total and every gradient against JAX with
    ``scan_layers=False``, run op by op (without remat, which changes no
    bit on either side and doubles JAX's eager time)."""
    arch = "mixtral-8x22b"
    jcfg, tcfg = _cfgs(arch, qat="w4a8", scan_layers=False, remat=False)
    jparams = jax_models[arch]
    jm, tm = jax_build(jcfg), build_model(tcfg)
    batch = _batch(tcfg)
    (jl, jmet), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet, tg = _loss_and_grads(tm, _port_params(jparams), batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["aux_loss"].detach()), float(jmet["aux_loss"]),
                               atol=1e-6)
    _check_grads(jg, tg)
    # The QAT loss differs from the unquantized one: the projections are fake-quantized.
    plain, _, _ = _loss_and_grads(build_model(_cfgs(arch)[1]), _port_params(jparams), batch)
    assert float(plain.detach()) != float(tl.detach())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_jax(jax_models, arch):
    """Two steps of ``make_train_step`` from JAX's weights on the data
    pipeline's batches: loss, grad norm and params against JAX's jitted
    step (the aux loss in the total, every expert and the router
    updated)."""
    jcfg, tcfg = _cfgs(arch)
    base = dict(lr=1e-2, warmup_steps=2, total_steps=30, log_every=5, checkpoint_every=10)
    tc, jtc = TrainConfig(**base), JaxTrainConfig(**base)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jax_models[arch]
    js, ts = jax_init_state(jparams, jtc), init_train_state(_port_params(jparams), tc)
    first = [p.clone() for p in tr.leaves(ts.params)]
    jstep, tstep = jax.jit(jax_train_step(jm, jtc)), make_train_step(tm, tc)
    for i in range(2):
        b = _batch(tcfg, i)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, b)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["aux_loss"]), float(jmet["aux_loss"]), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(js.params), tr.leaves(ts.params)):
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-4
    moved = {tr.path_str(p): not torch.equal(a, b) for (p, a), b in
             zip(tr.flatten_with_path(ts.params), first)}
    assert all(v for k, v in moved.items() if "moe" in k), moved


def test_remat_changes_no_bit_in_moe_training():
    """``cfg.remat`` checkpoints each block, the aux loss among its
    outputs: the total, the aux loss and every gradient bitwise those
    without it."""
    _, tcfg = _cfgs("mixtral-8x22b")
    params = build_model(tcfg).init(seed=0, device="cpu")
    batch = _batch(tcfg)
    out = [_loss_and_grads(build_model(dataclasses.replace(tcfg, remat=remat)), params, batch)
           for remat in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1]["aux_loss"], out[1][1]["aux_loss"])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


def test_forward_hidden_keeps_one_value_and_serving_drops_the_aux():
    """The public ``forward_hidden`` returns the hidden states alone, as
    before; the aux reaches ``train_loss`` only."""
    from repro_torch.models import transformer

    _, tcfg = _cfgs("llama4-maverick-400b-a17b")
    params = build_model(tcfg).init(seed=0, device="cpu")
    batch = {"tokens": torch.as_tensor(_batch(tcfg)["tokens"])}
    with torch.no_grad():
        h = transformer.forward_hidden(params, tcfg, batch)
        h2, aux = transformer._forward_hidden_aux(params, tcfg, batch)
    assert isinstance(h, torch.Tensor) and h.shape == (B, T, tcfg.d_model)
    assert torch.equal(h, h2) and aux.shape == () and float(aux) > 0
    dense = get_reduced_config("olmo-1b")
    dparams = build_model(dense).init(seed=0, device="cpu")
    with torch.no_grad():
        assert transformer._forward_hidden_aux(dparams, dense, batch)[1] is None


# -- the expert product's gradient -----------------------------------------------

def _bwd_inputs(E, cap, K, N, counts, seed=3):
    rng = np.random.default_rng(seed)
    xe = torch.from_numpy(rng.standard_normal((E, cap, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32) * K ** -0.5)
    dy = torch.from_numpy(rng.standard_normal((E, cap, N)).astype(np.float32))
    return xe, w, dy, torch.tensor(counts, dtype=torch.int32)


@pytest.mark.parametrize("E,cap,K,N,counts", [
    (4, 16, 24, 40, [5, 0, 16, 9]), (3, 8, 64, 16, [8, 8, 1]), (2, 24, 8, 8, [0, 0])],
    ids=["mixed", "full", "all-empty"])
def test_expert_matmul_bwd_ref_matches_autograd(E, cap, K, N, counts):
    """dx and dw of the plain backward against autograd through
    ``expert_matmul_ref`` (float64 for the reference): rows past the count
    hold non-zeros in xe and dy and change nothing; dx is zero past the
    count, an expert with count 0 gets dw = 0; float32 sums, outputs in
    xe's / w's dtype."""
    xe, w, dy, c = _bwd_inputs(E, cap, K, N, counts)
    x64, w64 = xe.double().requires_grad_(True), w.double().requires_grad_(True)
    y = ref.expert_matmul_ref(x64, w64, c)
    gx, gw = torch.autograd.grad(y, (x64, w64), dy.double())
    dx, dw = ref.expert_matmul_bwd_ref(xe, w, dy, c)
    assert dx.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), gx.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), gw.numpy(), rtol=0, atol=1e-5)
    live = torch.arange(cap)[None] < c[:, None]
    assert (dx[~live] == 0).all()
    for e, n in enumerate(counts):
        if n == 0:
            assert (dw[e] == 0).all()
    # NaN past the count (the kernel's own mask) changes no bit.
    nan = torch.tensor(float("nan"))
    xn = torch.where(live[..., None], xe, nan)
    dn = torch.where(live[..., None], dy, nan)
    dx2, dw2 = ref.expert_matmul_bwd_ref(xn, w, dn, c)
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw)
    bx, bw = ref.expert_matmul_bwd_ref(xe.bfloat16(), w.bfloat16(), dy.bfloat16(), c)
    assert bx.dtype == bw.dtype == torch.bfloat16


@pytest.fixture
def experts_as_plain(monkeypatch):
    """The card's route of ``ops.expert_matmul`` (``ops._backend`` forced
    to cuda) with the kernel's three launches swapped for plain versions
    that, like a kernel, record no gradient of their own and count their
    launches."""
    cuda = registry.get_registry().resolve("cuda", torch.device("cuda"), "expert_matmul")
    monkeypatch.setattr(ops, "_backend", lambda t, name, backend: cuda)

    def fwd(xe, w, counts):
        expert_matmul.launches += 1
        with torch.no_grad():
            return ref.expert_matmul_ref(xe, w, counts)

    def dx(dy, w, counts):
        expert_matmul.bwd_launches += 1
        rows = torch.zeros((w.shape[0], dy.shape[1], w.shape[1]), dtype=dy.dtype)
        return ref.expert_matmul_bwd_ref(rows, w, dy, counts)[0]

    def dw(xe, dy, counts):
        expert_matmul.bwd_launches += 1
        return ref.expert_matmul_bwd_ref(xe, torch.zeros((xe.shape[0], xe.shape[2],
                                                          dy.shape[2]), dtype=xe.dtype),
                                         dy, counts)[1]

    monkeypatch.setattr(expert_matmul, "launch", fwd)
    monkeypatch.setattr(expert_matmul, "launch_dx", dx)
    monkeypatch.setattr(expert_matmul, "launch_dw", dw)
    ops.reset_launch_counts()
    return cuda


def test_expert_matmul_records_its_gradient_on_the_card_route(experts_as_plain):
    """On the card's route a bf16 product under autograd runs the
    ``ExpertMatmul`` Function (a kernel records no gradient: without it the
    expert weights would get none, silently), whose backward launches dX
    and dW once each; the gradients equal autograd through the plain
    version. Without grad the kernel is called directly."""
    xe, w, dy, c = _bwd_inputs(4, 16, 24, 40, [5, 0, 16, 9])
    xe, w, dy = xe.bfloat16().requires_grad_(True), w.bfloat16().requires_grad_(True), \
        dy.bfloat16()
    y = ops.expert_matmul(xe, w, c)
    assert y.grad_fn is not None and "ExpertMatmul" in type(y.grad_fn).__name__
    gx, gw = torch.autograd.grad(y, (xe, w), dy)
    assert ops.launch_counts()["expert_matmul"] == 1
    assert ops.launch_counts()["expert_matmul_bwd"] == 2
    rx, rw = ref.expert_matmul_bwd_ref(xe.detach(), w.detach(), dy, c)
    assert torch.equal(gx, rx) and torch.equal(gw, rw)
    with torch.no_grad():
        y2 = ops.expert_matmul(xe, w, c)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())
    # Only the leaf that needs a gradient gets its launch.
    ops.reset_launch_counts()
    y3 = ops.expert_matmul(xe.detach(), w, c)
    torch.autograd.grad(y3, w, dy)
    assert ops.launch_counts()["expert_matmul_bwd"] == 1


def test_moe_layer_gradients_on_the_card_route(experts_as_plain):
    """A bf16 ``moe_apply`` layer under autograd on the card's route: the
    three expert products run the Function, and every leaf's gradient
    (router, the three expert leaves, x) equals the plain route's."""
    _, tcfg = _cfgs("mixtral-8x22b")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    p = {k: v for k, v in build_model(tcfg).init(seed=2, device="cpu")["blocks"]["moe"].items()}
    layer = tr.map_tree(lambda a: a[0].detach().clone(), p)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)).bfloat16()

    def grads():
        live = tr.map_tree(lambda a: a.detach().requires_grad_(True), layer)
        xl = x.detach().requires_grad_(True)
        out, aux = moe.moe_apply(live, xl, tcfg)
        loss = (out.float() ** 2).sum() + aux
        return torch.autograd.grad(loss, [*tr.leaves(live), xl])

    card = grads()
    assert ops.launch_counts()["expert_matmul"] == 3
    assert ops.launch_counts()["expert_matmul_bwd"] == 6
    reference = registry.get_registry().resolve("reference", torch.device("cpu"),
                                                "expert_matmul")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_backend", lambda t, name, backend: reference)
        plain = grads()
    for a, b in zip(card, plain):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * max(scale, 1e-30)


@pytest.mark.parametrize("entry", sorted(expert_matmul.BWD_ARGTYPES))
def test_expert_matmul_bwd_argtypes_match_the_source(entry):
    """Each backward entry's ctypes argtypes follow its C parameters one
    for one, and the source is in the build list."""
    src = (build.CSRC / "expert_matmul_bwd.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert expert_matmul.BWD_ARGTYPES[entry] == want
    assert "expert_matmul_bwd" in build.KERNELS and "expert_matmul_bwd" in ops.launch_counts()


def test_expert_matmul_bwd_refuses_cpu_and_float32():
    """The backward entries validate as ``launch`` does and never fall back
    to the plain version."""
    xe, w, dy, c = _bwd_inputs(2, 8, 16, 24, [3, 8])
    with pytest.raises(ValueError, match="bfloat16"):
        expert_matmul.launch_dx(dy, w, c)
    with pytest.raises(ValueError, match="CUDA"):
        expert_matmul.launch_dw(xe.bfloat16(), dy.bfloat16(), c)
    with pytest.raises(ValueError, match="multiples of 8"):
        expert_matmul.launch_dx(dy[..., :20].bfloat16(), w[..., :20].bfloat16(), c)
    with pytest.raises(ValueError, match="do not fit"):
        expert_matmul.launch_dw(xe.bfloat16(), dy[:, :4].bfloat16(), c)
    with pytest.raises(ValueError, match="counts"):
        expert_matmul.launch_dx(dy.bfloat16(), w.bfloat16(), c[:1])


def test_backward_schedules_never_read_the_counts():
    """The backward's blocks follow (E, cap, K, N) alone: dX's row tiles
    by the forward's rule, dW's 128 x 128 tiles, the ring within the
    card's shared memory. Each C entry derives its grid and shared bytes
    from the shape and these, by the expressions pinned here."""
    sx = expert_matmul.schedule_dx(8, 1280, 6144, 16384)
    sw = expert_matmul.schedule_dw(8, 1280, 6144, 16384)
    s4 = expert_matmul.schedule_dx(128, 40, 5120, 8192)
    assert (sx.bm, sw.bm, s4.bm) == (128, 128, 64)
    for s in (sx, sw, s4):
        assert 2 <= s.stages <= expert_matmul.BWD_MAX_STAGES
        assert expert_matmul.bwd_smem_bytes(s.bm, s.stages) <= expert_matmul.SMEM
    src = (build.CSRC / "expert_matmul_bwd.cu").read_text()
    assert re.findall(r"const dim3 grid\(([^;]*)\);", src) == [
        "(K + kBN - 1) / kBN, (cap + bm - 1) / bm, E",
        "(N + kBN - 1) / kBN, (K + 2 * kRows - 1) / (2 * kRows), E"]
    assert "return 1024LL + (long long)stages * (wgs * kBox + kBN * 128 + 16);" in src
    assert "constexpr int kBN = 128;" in src and "constexpr int kBox = 64 * 128;" in src
    assert expert_matmul.BWD_BN == 128
    assert expert_matmul.bwd_smem_bytes(128, 3) == 1024 + 3 * (2 * 64 * 128 + 128 * 128 + 16)


@pytest.mark.parametrize("shape", [(1, 8, 6144, 16384), (2, 128, 5120, 8192), (16, 2048, 8192),
                                   (1, 1 << 26), (3, 100), ()])
def test_adamw_slices_cover_a_leaf_once_in_bounded_pieces(shape):
    """AdamW updates a leaf a slice at a time: the slices cover every
    element once and hold at most ``_UPDATE_ELEMS`` each, also for an MoE
    expert leaf of one or two layers, whose one layer alone is larger."""
    import math

    from repro_torch.optim import adamw

    t = torch.zeros(shape, dtype=torch.int8) if math.prod(shape) < 1 << 28 else None
    sizes = []
    for s in adamw._slices(shape):
        if t is not None:
            t[s] += 1
            sizes.append(t[s].numel())
        elif s is not ...:
            sizes.append(math.prod(
                (len(range(*i.indices(d))) if isinstance(i, slice) else 1)
                for i, d in zip(s, shape)) * math.prod(shape[len(s):]))
    assert sum(sizes) == math.prod(shape) or not shape
    assert max(sizes) <= max(adamw._UPDATE_ELEMS, math.prod(shape) if len(sizes) == 1 else 0)
    if t is not None:
        assert bool((t == 1).all())


def test_train_cli_trains_an_moe_arch_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch mixtral-8x22b --reduced
    --steps 2`` on the CPU: JAX's printed lines, two steps, finite
    losses."""
    from repro_torch.launch import train

    train.main(["--arch", "mixtral-8x22b", "--reduced", "--steps", "2", "--device", "cpu",
                "--seq", "32"])
    out = capsys.readouterr().out
    assert "arch: mixtral-8x22b-smoke" in out
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\d+\.\d+)  gnorm", out, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 logged steps, final loss" in out
