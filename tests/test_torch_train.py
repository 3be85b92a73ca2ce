"""Training in the port held against the JAX package on the CPU: the
fake-quant straight-through estimator, ``qmatmul``'s fake mode,
``cross_entropy``, the transformer families' ``train_loss`` and its
gradients, ``make_train_step`` (microbatches, compression), the runner
(loss falls, resume, straggler monitor), the train CLI and serve --ckpt
(a JAX-written checkpoint served with JAX's greedy tokens), the autograd
plumbing of the flash and ``dense_matmul`` kernels (their kernels
swapped for the plain versions, as the card's path runs them). The
recurrent families (rwkv6-3b, recurrentgemma-9b) are cases of the model
and step tests here; their kernels' backward algebra and Functions are in
``test_torch_train_recurrent.py``.

Tolerances. ``fake_quant`` and ``qmatmul(mode="fake")``: bitwise, the
same float32 expressions as JAX's eager ``custom_vjp``. Model level, in
float32: 1e-5 of each leaf's max |gradient| (sums in another order);
rwkv6's ``u`` 5e-5 (its gradient sums B·T products dout_t · v_t r_t k_t
that cancel: JAX's own float32 gradient of it is 2.2e-5 of max |g| from
JAX's float64 one, the port's 2.8e-5). Under QAT the reference is JAX
with ``scan_layers=False`` (its ops run one by one, as the port's do), and
for Griffin, which scans its groups whatever that flag says, JAX under
``jax.disable_jit()``: JAX's scanned body is one XLA computation in which
``absmax / qmax`` becomes ``absmax * (1 / qmax)``, which moves some
activation codes by one (ROADMAP Queue 3), and one code moves a weight's
gradient by up to tens of percent. Train steps: loss 1e-6 and
grad norm 1e-5 relative, params 1e-4 (AdamW moves each parameter by
about lr, so a near-zero gradient's sign decides its update). With
int8-compressed gradients, and under QAT once the first update has moved
the weights, a code flipped at a rounding boundary moves some elements'
updates by up to lr: there fewer than 1 % of elements part by more than
1e-4 (0.006 % and 0.15 % seen), none by more than 2 lr, and a QAT step's
loss and grad norm within 1e-5 and 1e-4. The recurrent families take
those params bounds and the loss's too: gradients near zero by
cancellation (rwkv6's squared-ReLU channel mix) are normalized each by
its own size in AdamW's first step, so some elements part by up to 5e-4
after it (0.002 % past 1e-4 on rwkv6), which moves the second step's
grad norm by up to 4.4e-4 (held within 1e-3).
"""
import contextlib
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.quant import QuantConfig as JaxQuant
from repro.core.quant import fake_quant as jax_fake_quant
from repro.core.quantized_linear import qmatmul as jax_qmatmul
from repro.launch.dryrun import _parse_quant as jax_quant
from repro.models import build_model as jax_build
from repro.models import common as jcm
from repro.train.loop import init_train_state as jax_init_state
from repro.train.loop import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch import tree as tr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import parse_quant_token
from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.core.quantized_linear import qmatmul
from repro_torch.data import DataIterator
from repro_torch.kernels import (dense_matmul, flash_attention, flash_attention_bwd, ops, ref,
                                 rglru, wkv6)
from repro_torch.models import build_model
from repro_torch.models import common as cm
from repro_torch.models import transformer
from repro_torch.train.loop import (StragglerMonitor, init_train_state, make_train_step,
                                    run_training)
from torch_parity import to_numpy_tree

RNG = np.random.default_rng(17)
GRAD_TOL = 1e-5
LEAF_TOL = {"['blocks']['tm']['u']": 5e-5}     # see the module docstring


def _vjp_jax(f, args, g):
    y, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _vjp_torch(f, args, g):
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    y = f(*ts)
    return y.detach().numpy(), [x.numpy() for x in torch.autograd.grad(y, ts,
                                                                       torch.from_numpy(g))]


# -- fake quantization --------------------------------------------------------

@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("signed", [True, False])
def test_fake_quant_and_ste_bitwise_jax(bits, axis, signed):
    """Forward (absmax quantize-dequantize) and the straight-through
    gradient ``g * (|x| <= scale * qmax)`` bitwise ``jax.vjp``; values
    past the clip range (a scaled-up tail) get none."""
    x = RNG.standard_normal((12, 24)).astype(np.float32)
    x[0, :4] *= 9.0
    g = RNG.standard_normal(x.shape).astype(np.float32)
    fj = lambda a: jax_fake_quant(a, bits, signed, axis)     # noqa: E731
    ft = lambda a: fake_quant(a, bits, signed, axis)         # noqa: E731
    yj, (gj,) = _vjp_jax(fj, [x], g)
    yt, (gt,) = _vjp_torch(ft, [x], g)
    assert np.array_equal(yj, yt) and np.array_equal(gj, gt)
    with torch.no_grad():                  # the forward alone, as serving runs it
        assert np.array_equal(ft(torch.from_numpy(x)).numpy(), yj)


def test_fake_quant_bf16_bitwise_jax():
    x = RNG.standard_normal((2, 8, 64)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    yj, vjp = jax.vjp(lambda a: jax_fake_quant(a, 4, True, 2), xj)
    (gj,) = vjp(jnp.ones_like(yj))
    yt = fake_quant(xt, 4, True, 2)
    (gt,) = torch.autograd.grad(yt, xt, torch.ones_like(yt))
    assert yt.dtype == gt.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(yj, np.float32), yt.detach().float().numpy())
    assert np.array_equal(np.asarray(gj, np.float32), gt.float().numpy())


@pytest.mark.parametrize("qcfg", [dict(w_bits=4, a_bits=8), dict(w_bits=2, a_bits=6),
                                  dict(w_bits=8, a_bits=4, per_channel=False),
                                  dict(w_bits=4, a_bits=8, act_signed=False)])
def test_qmatmul_fake_mode_bitwise_jax(qcfg):
    x = RNG.standard_normal((2, 8, 64)).astype(np.float32)
    w = (RNG.standard_normal((64, 24)) * 0.1).astype(np.float32)
    g = RNG.standard_normal((2, 8, 24)).astype(np.float32)
    yj, gj = _vjp_jax(lambda a, b: jax_qmatmul(a, b, JaxQuant(**qcfg), mode="fake"), [x, w], g)
    yt, gt = _vjp_torch(lambda a, b: qmatmul(a, b, QuantConfig(**qcfg), mode="fake"), [x, w], g)
    assert np.array_equal(yj, yt)
    assert all(np.array_equal(a, b) for a, b in zip(gj, gt))
    with pytest.raises(ValueError, match="unknown qmatmul mode"):
        qmatmul(torch.zeros(2, 64), torch.zeros(64, 8), QuantConfig(), mode="bogus")


def test_linear_routes_fake_mode_only_with_a_config():
    x, w = torch.randn(3, 16), torch.randn(16, 8)
    assert torch.equal(cm.linear(x, w), x @ w)
    assert torch.equal(cm.linear(x, w, None, "fake"), x @ w)
    q = QuantConfig(w_bits=4, a_bits=8)
    assert torch.equal(cm.linear(x, w, q, "fake"), qmatmul(x, w, q, mode="fake"))
    assert torch.equal(cm.linear(x, w, q, "none"), x @ w)


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_value_and_grad_match_jax(z_loss):
    logits = (RNG.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = RNG.integers(0, 50, (3, 7)).astype(np.int32)
    g = RNG.standard_normal((3, 7)).astype(np.float32)
    yj, vjp = jax.vjp(lambda a: jcm.cross_entropy(a, jnp.asarray(labels), z_loss),
                      jnp.asarray(logits))
    (gj,) = vjp(jnp.asarray(g))
    lt = torch.from_numpy(logits).requires_grad_(True)
    yt = cm.cross_entropy(lt, torch.from_numpy(labels), z_loss)
    (gt,) = torch.autograd.grad(yt, lt, torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-7)


# -- the models' training loss --------------------------------------------------

def _cfgs(arch, qat=None, **over):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32", **over)
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32", **over)
    if qat:
        jcfg, tcfg = jcfg.with_quant(jax_quant(qat)), tcfg.with_quant(parse_quant_token(qat))
    return jcfg, tcfg


def _port_params(jparams):
    return convert.params_from_numpy(to_numpy_tree(jparams), "cpu")


def _loss_and_grads(model, params, batch):
    live = tr.map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.train_loss(live, batch)
    grads = torch.autograd.grad(loss, tr.leaves(live), allow_unused=True)
    return loss, metrics, [torch.zeros_like(p) if g is None else g
                           for p, g in zip(tr.leaves(live), grads)]


@pytest.mark.parametrize("arch,qat,seq", [
    ("olmo-1b", None, 32), ("olmo-1b", "w4a8", 32), ("paligemma-3b", None, 24),
    ("hubert-xlarge", None, 20), ("rwkv6-3b", None, 40), ("recurrentgemma-9b", None, 40),
    ("recurrentgemma-9b", "w4a8", 40)])
def test_train_loss_and_grads_match_jax(arch, qat, seq):
    """The loss and every leaf's gradient of a data-pipeline batch (JAX
    weights carried across), float32; QAT against JAX unscanned (see the
    module docstring). paligemma: the text positions after the patches;
    hubert: per-frame labels (its token embedding gets no gradient).
    rwkv6: T 40 crosses a chunk edge (the reduced chunk is 64: one partial
    chunk; JAX's shrinks to T); Griffin: T 40 past its 16-wide window, the
    gradient through the RG-LRU, the conv and windowed attention."""
    jcfg, tcfg = _cfgs(arch, qat, **({"scan_layers": False} if qat else {}))
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = DataIterator(tcfg, global_batch=3, seq_len=seq, seed=1, branch=4).batch_at(0)
    eager = jax.disable_jit() if qat and jcfg.family == "hybrid" else contextlib.nullcontext()
    with eager:
        (jl, jmet), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet, tg = _loss_and_grads(tm, _port_params(jparams), batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert float(tmet["loss"].detach()) == float(tl.detach()) and float(tmet["aux_loss"]) == 0.0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        a, key = np.asarray(a), jax.tree_util.keystr(path)
        err = np.abs(a - b.numpy()).max()
        tol = LEAF_TOL.get(key, GRAD_TOL)
        assert err <= tol * max(np.abs(a).max(), 1e-30), (key, err, np.abs(a).max())


def test_remat_changes_no_bit():
    """``cfg.remat`` checkpoints each block; the loss and gradients are
    bitwise those without it."""
    _, tcfg = _cfgs("olmo-1b", "w4a8")
    params = build_model(tcfg).init(seed=0, device="cpu")
    batch = DataIterator(tcfg, global_batch=2, seq_len=16, seed=0).batch_at(0)
    out = []
    for remat in (True, False):
        model = build_model(dataclasses.replace(tcfg, remat=remat))
        out.append(_loss_and_grads(model, params, batch))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


def test_stacked_leaves_unbind_once():
    """Layer params come from one unbind of each stacked leaf (views, no
    copy): a leaf's gradient is one stack, not a leaf-sized zero tensor
    per layer."""
    tcfg = get_reduced_config("olmo-1b")
    params = build_model(tcfg).init(seed=0, device="cpu")
    layers = transformer.unstack_layers(params["blocks"], tcfg.num_layers)
    assert len(layers) == tcfg.num_layers
    w = params["blocks"]["ffn"]["w_up"]
    assert layers[1]["ffn"]["w_up"].data_ptr() == w[1].data_ptr()
    live = w.detach().requires_grad_(True)
    parts = live.unbind(0)
    (g,) = torch.autograd.grad(sum(p.sum() for p in parts), live)
    assert "Unbind" in type(parts[0].grad_fn).__name__ and torch.equal(g, torch.ones_like(w))


@pytest.mark.parametrize("arch", ["olmo-1b", "nemotron-4-15b", "stablelm-12b",
                                  "paligemma-3b", "hubert-xlarge", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_param_count_matches_jax(arch):
    """``param_count`` of each family the port trains, at full and reduced
    size, is JAX's (the train CLI prints it on its first line)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    assert get_config(arch).param_count() == jax_config(arch).param_count()
    assert get_reduced_config(arch).param_count() == jax_reduced(arch).param_count()


# -- the train step and the runner -----------------------------------------------

def _tc(**kw):
    base = dict(lr=1e-2, warmup_steps=2, total_steps=30, log_every=5, checkpoint_every=10)
    base.update(kw)
    return TrainConfig(**base), JaxTrainConfig(**base)


@pytest.mark.parametrize("arch,qat,micro,compress", [
    ("olmo-1b", None, 1, 0), ("olmo-1b", None, 2, 8), ("olmo-1b", "w4a8", 1, 0),
    ("rwkv6-3b", None, 1, 0), ("recurrentgemma-9b", None, 1, 0)],
    ids=["None-1-0", "None-2-8", "w4a8-1-0", "rwkv6-3b", "recurrentgemma-9b"])
def test_train_step_matches_jax(arch, qat, micro, compress):
    """Two steps of ``make_train_step`` from JAX's weights on the data
    pipeline's batches: loss, grad norm and params against JAX's step
    (jitted; unjitted and unscanned under QAT), also with microbatches
    and int8-compressed gradients, and for each recurrent family (their
    float32 leaves, rwkv6's ``decay_base`` and ``u``, Griffin's
    ``lambda_p`` and gate biases, among the params)."""
    jcfg, tcfg = _cfgs(arch, qat, **({"scan_layers": False} if qat else {}))
    recurrent = jcfg.family in ("ssm", "hybrid")
    tc, jtc = _tc(microbatches=micro, grad_compress_bits=compress)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    js, ts = jax_init_state(jparams, jtc), init_train_state(_port_params(jparams), tc)
    jstep = jax_train_step(jm, jtc)
    jstep = jstep if qat else jax.jit(jstep)
    tstep = make_train_step(tm, tc)
    data = DataIterator(tcfg, global_batch=4, seq_len=32, seed=0, branch=4)
    for i in range(2):
        b = data.batch_at(i)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, b)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5 if qat or recurrent else 1e-6)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-3 if recurrent else 1e-4 if qat else 1e-5)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), abs=2e-9)
    for a, b in zip(jax.tree_util.tree_leaves(js.params), tr.leaves(ts.params)):
        d = np.abs(b.numpy() - np.asarray(a))
        if not (compress or qat or recurrent):
            assert d.max() <= 1e-4
        else:
            # A code (an int8 gradient's, an activation's after the first
            # update) that a sum in another order moves across a rounding
            # boundary, or a gradient near zero by cancellation, changes
            # some elements' AdamW update, each by at most lr a step: rare,
            # and bounded.
            assert (d > 1e-4).mean() < 1e-2 and d.max() <= 2 * tc.lr
    assert (ts.err is None) == (not compress)


def test_microbatches_match_the_full_batch():
    """Two microbatches' float32 gradient sum against the full batch: the
    loss equal to rounding, the params after a step within JAX's own
    test's 2e-2."""
    _, tcfg = _cfgs("olmo-1b")
    model = build_model(tcfg)
    params = model.init(seed=0, device="cpu")
    batch = DataIterator(tcfg, global_batch=4, seq_len=32, seed=0, branch=4).batch_at(0)
    out = []
    for micro in (1, 2):
        tc, _ = _tc(microbatches=micro)
        st = init_train_state(tr.map_tree(torch.clone, params), tc)
        st, met = make_train_step(model, tc)(st, batch)
        out.append((float(met["loss"]), tr.leaves(st.params)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-2)


def test_loss_decreases():
    cfg = get_reduced_config("olmo-1b")
    tc, _ = _tc(total_steps=40)
    data = DataIterator(cfg, global_batch=8, seq_len=32, seed=0, branch=4)
    _, history = run_training(build_model(cfg), tc, data, device="cpu")
    losses = [h["loss"] for h in history]
    assert losses[-1] < losses[0] - 0.3, losses


def test_grad_compression_training_runs():
    cfg = get_reduced_config("olmo-1b")
    tc, _ = _tc(total_steps=10, grad_compress_bits=8)
    data = DataIterator(cfg, global_batch=4, seq_len=16, seed=0, branch=4)
    state, history = run_training(build_model(cfg), tc, data, device="cpu")
    assert state.err is not None and all(np.isfinite(h["loss"]) for h in history)


def test_resume_from_checkpoint(tmp_path):
    """A run preempted by SIGTERM after step 11 saves its state at step 12
    and stops (``_PreemptionFlag``); a restarted job resumes there (the
    template on ``meta``, the data iterator's state restored) and runs to
    15. Its steps 12-14 and final params are bitwise a run that was never
    interrupted."""
    import os
    import signal

    cfg = get_reduced_config("olmo-1b")
    model = build_model(cfg)
    tc, _ = _tc(total_steps=15, checkpoint_every=100, log_every=1)

    def data():
        return DataIterator(cfg, global_batch=4, seq_len=16, seed=0, branch=4)

    def preempt_after_11(step, rec):
        if step == 11:
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    try:
        whole, hist_whole = run_training(model, tc, data(), device="cpu")
        mgr = CheckpointManager(tmp_path, keep=2)
        _, hist_a = run_training(model, tc, data(), checkpoint_mgr=mgr, hooks=preempt_after_11,
                                 device="cpu")
        assert [h["step"] for h in hist_a][-1] == 11 and mgr.latest_step() == 12
        it = data()
        resumed, hist_b = run_training(model, tc, it, checkpoint_mgr=mgr, device="cpu")
    finally:
        signal.signal(signal.SIGTERM, old)
    assert it.get_state()["step"] >= 15 and [h["step"] for h in hist_b] == [12, 13, 14]
    assert [(h["loss"], h["grad_norm"]) for h in hist_b] == [
        (h["loss"], h["grad_norm"]) for h in hist_whole[12:]]
    assert int(resumed.opt.step) == 15
    assert all(torch.equal(a, b) for a, b in zip(tr.leaves(whole), tr.leaves(resumed)))


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0)
    assert not mon.observe(1.0)
    for _ in range(5):
        assert not mon.observe(1.0)
    assert mon.observe(5.0)
    assert mon.flagged == 1


# -- the CLIs ----------------------------------------------------------------------

def test_train_cli_and_serve_ckpt_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve, train

    ck = str(tmp_path / "ck")
    train.main(["--arch", "olmo-1b", "--reduced", "--steps", "6", "--qat", "w4a8",
                "--ckpt", ck, "--device", "cpu", "--seq", "32"])
    out = capsys.readouterr().out
    assert "arch: olmo-1b-smoke (0.1M params)" in out
    assert len(re.findall(r"^step +\d+  loss \d+\.\d+  gnorm", out, re.M)) == 6
    assert "done: 6 logged steps, final loss" in out
    assert CheckpointManager(ck).latest_step() == 6
    serve.main(["--arch", "olmo-1b", "--reduced", "--ckpt", ck, "--device", "cpu",
                "--requests", "2", "--max-new", "3", "--policy", "w4a8;wo=w8a8"])
    out = capsys.readouterr().out
    assert "restored checkpoint step 6" in out and "req 1: [" in out
    assert "randomly initialized" not in out


@pytest.mark.parametrize("flag", [["--fake-devices", "4"], ["--mesh-shape", "2,2"]])
def test_train_cli_refuses_mesh_flags(flag):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="Queue 1 item 4"):
        train.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", *flag])


def test_serve_ckpt_of_a_jax_checkpoint_gives_jax_serves_greedy_tokens(tmp_path, capsys):
    """A TrainState saved by JAX's trainer (reduced olmo-1b, bf16) served
    by both serve CLIs with --ckpt: the greedy requests' tokens equal
    (the sampled ones draw from each package's own generator)."""
    import sys

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    cfg = jax_reduced("olmo-1b")
    st = jax_init_state(jax_build(cfg).init(jax.random.PRNGKey(3)), JaxTrainConfig())
    JaxManager(tmp_path).save(3, st)
    argv = ["--arch", "olmo-1b", "--reduced", "--ckpt", str(tmp_path), "--requests", "3",
            "--max-new", "4"]
    old = sys.argv
    sys.argv = ["serve", *argv]
    try:
        jax_serve.main()
    finally:
        sys.argv = old
    want = capsys.readouterr().out
    _, done, _ = serve.run(serve.build_parser().parse_args(argv + ["--device", "cpu"]))
    got = capsys.readouterr().out
    assert "restored checkpoint step 3" in want and "restored checkpoint step 3" in got
    jtok = {int(m[0]): m[1] for m in re.findall(r"req (\d+): (\[[^\]]*\])", want)}
    assert {r.rid: str(r.out_tokens).replace(" ", "") for r in done if r.temperature == 0} \
        == {rid: t.replace(" ", "") for rid, t in jtok.items() if rid % 2 == 0}


# -- the kernels' autograd plumbing ------------------------------------------------

MASKS = [dict(causal=True, window=0, q_offset=0),
         dict(causal=True, window=6, q_offset=10),           # rows past every key
         dict(causal=True, window=0, q_offset=0, prefix_len=5),
         dict(causal=False, window=0, q_offset=0)]


@pytest.mark.parametrize("kw", MASKS)
def test_plain_flash_backward_is_finite_and_zero_on_blind_rows(kw):
    """The plain version's gradients (autograd through
    ``flash_attention_gqa_ref``), which the card's kernel is held to: ops'
    CPU route gives them, a row that sees no key gets zeros, never NaN."""
    q = torch.randn(2, 20, 4, 16, requires_grad=True)
    k = torch.randn(2, 14, 2, 16, requires_grad=True)
    v = torch.randn(2, 14, 2, 16, requires_grad=True)
    do = torch.randn(2, 20, 4, 16)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v), do)
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    assert all(torch.equal(a, b) and torch.isfinite(a).all() for a, b in zip(got, want))
    if kw["window"]:
        blind = kw["q_offset"] + torch.arange(20) - kw["window"] + 1 > 13
        assert blind.any() and (got[0][:, blind] == 0).all()


def test_flash_backward_argtypes_match_the_source():
    import ctypes

    from repro_torch.kernels import build

    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    params = re.search(r'extern "C" int flash_attention_bwd\(([^)]*)\)', src).group(1)
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
            for p in params.split(",")]
    assert flash_attention_bwd.ARGTYPES == want
    assert "flash_attention_bwd" in build.KERNELS
    assert "flash_attention_bwd" in ops.launch_counts()


def test_flash_backward_bf16_plan_fits_and_is_keyed_by_head_dim():
    """The bf16 route's tile plan, read from its source: one row for every
    head dim the kernels take and no other key (never B, T, G or the mask,
    so a head's gradients are the same bits alone or in a batch), whole
    mma tiles, and each kernel's shared memory within the H100's 227 KB a
    block. The launcher sizes both kernels from ``Plan<H>`` alone."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import HEAD_DIMS

    plans = flash_attention_bwd.bf16_plans()
    assert sorted(plans) == sorted(HEAD_DIMS)
    for H, p in plans.items():
        assert p["kv_keys"] % 16 == 0 and p["kv_rows"] % 32 == 0, H
        assert p["q_rows"] % 16 == 0 and p["q_keys"] % 16 == 0, H
        assert max(p["rows_smem"], p["dkdv_smem"]) <= 227 * 1024, (H, p)
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    launch = re.search(r"int launch_bf16\(.*?\n}\n", src, re.S).group(0)
    assert "using P = Plan<H>;" in launch
    assert re.findall(r"<<<dim3\([^,]*P::(?:QR|KVK)", launch) and "Plan<" not in launch.replace(
        "Plan<H>", "")


def test_flash_backward_refuses_mixed_dtypes():
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_bwd.check_inputs(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd.check_inputs(*(torch.zeros(1, 4, 2, 24),) * 3)


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """The card's route with each kernel launch swapped for its plain
    version (CPU tensors, ``ops._backend`` forced to cuda): the autograd
    Functions and their gradients run as on the card (flash attention,
    ``dense_matmul``, and the two recurrences forward and backward)."""
    from repro_torch.kernels import registry

    cuda = registry.get_registry().resolve("cuda", torch.device("cuda"), "flash_attention")
    monkeypatch.setattr(ops, "_backend", lambda t, name, backend: cuda)
    monkeypatch.setattr(flash_attention, "launch",
                        lambda q, k, v, **kw: ref.flash_attention_gqa_ref(q, k, v, **kw))
    monkeypatch.setattr(flash_attention_bwd, "launch",
                        lambda q, k, v, out, do, **kw: ref.flash_attention_bwd_ref(
                            q, k, v, do, **kw))
    monkeypatch.setattr(dense_matmul, "launch",
                        lambda x, w, backend=None, out_dtype=torch.bfloat16, plan=None:
                        (x.float() @ w.float()).to(out_dtype))

    def wkv_launch(r, k, v, w, u, state, *, chunk, states=False):
        out = ref.wkv6_chunked_ref(r, k, v, w, u, state, chunk, return_states=True)
        return out if states else out[:2]

    monkeypatch.setattr(wkv6, "launch", wkv_launch)
    monkeypatch.setattr(wkv6, "launch_bwd",
                        lambda r, k, v, w, u, st, do, ds=None, *, chunk:
                        ref.wkv6_chunked_bwd_ref(r, k, v, w, u, st, do, ds, chunk))
    monkeypatch.setattr(rglru, "launch", ref.rglru_scan_ref)
    monkeypatch.setattr(rglru, "launch_bwd", ref.rglru_scan_bwd_ref)
    return cuda


@pytest.mark.parametrize("kw", MASKS)
def test_flash_function_carries_the_kernels_gradient(kernels_as_plain, kw):
    q = torch.randn(2, 20, 4, 16, requires_grad=True)
    k = torch.randn(2, 14, 2, 16, requires_grad=True)
    v = torch.randn(2, 14, 2, 16, requires_grad=True)
    do = torch.randn(2, 20, 4, 16)
    out = ops.flash_attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():                  # serving: the kernel alone, no Function
        assert ops.flash_attention(q, k, v, **kw).grad_fn is None
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q.to(torch.bfloat16), k, v, **kw)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_dense_function_gradients_are_the_plain_products(kernels_as_plain, out_dtype):
    """``dense_matmul``'s Function under autograd: dX = dY W^T and dW = X^T
    dY in x's dtype (in float32 for the float32 store, cast back)."""
    x = torch.randn(2, 5, 32).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(32, 16).to(torch.bfloat16).requires_grad_(True)
    y = ops.dense_matmul(x, w, out_dtype=out_dtype)
    assert type(y.grad_fn).__name__ == "ViewBackward0"
    g = torch.randn(y.shape).to(y.dtype)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    g2 = g.reshape(-1, 16)
    if out_dtype is None:
        want_x, want_w = g2 @ w.T, x.reshape(-1, 32).T @ g2
    else:
        want_x = (g2 @ w.float().T).to(torch.bfloat16)
        want_w = (x.reshape(-1, 32).float().T @ g2).to(torch.bfloat16)
    assert torch.equal(dx.reshape(-1, 32), want_x) and torch.equal(dw, want_w)
    with torch.no_grad():
        assert ops.dense_matmul(x, w).grad_fn is None


def test_wkv6_function_carries_the_kernels_gradient(kernels_as_plain):
    """``ops.wkv6_chunked`` under autograd runs ``WKV6``: its gradients are
    the plain backward's over the forward's chunk-start states, bitwise,
    and within 1e-5 of max |g| of autograd through the plain forward; no
    grad → no Function."""
    B, T, H, K, C = 2, 37, 2, 8, 16
    ins = [torch.randn(B, T, H, K) for _ in range(3)]
    ins += [torch.rand(B, T, H, K) * 0.7 + 0.3, torch.randn(H, K), torch.randn(B, H, K, K)]
    do, ds = torch.randn(B, T, H, K), torch.randn(B, H, K, K)
    live = [x.clone().requires_grad_(True) for x in ins]
    out, state = ops.wkv6_chunked(*live, chunk=C)
    assert type(out.grad_fn).__name__ == "WKV6Backward"
    got = torch.autograd.grad((out, state), live, (do, ds))
    _, _, starts = ref.wkv6_chunked_ref(*ins, C, return_states=True)
    want = ref.wkv6_chunked_bwd_ref(*ins[:5], starts, do, ds, C)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    again = [x.clone().requires_grad_(True) for x in ins]
    oracle = torch.autograd.grad(ref.wkv6_chunked_ref(*again, C), again, (do, ds))
    assert all((a - b).abs().max() <= GRAD_TOL * b.abs().max() for a, b in zip(got, oracle))
    with torch.no_grad():
        assert ops.wkv6_chunked(*live, chunk=C)[0].grad_fn is None


def test_rglru_function_carries_the_kernels_gradient(kernels_as_plain):
    """``ops.rglru_scan`` under autograd runs ``RGLRU`` and returns h_last
    as a slice of h, so a loss on both reaches h once: its gradients are
    the plain backward's for dh plus the slice's, bitwise; with lengths
    the slice is each row's lengths - 1."""
    B, T, W = 2, 21, 16
    ins = [torch.randn(s) for s in ((B, T, W), (B, T, W), (B, T, W), (W,), (W,), (W,), (B, W))]
    live = [x.clone().requires_grad_(True) for x in ins]
    h, h_last = ops.rglru_scan(*live)
    assert type(h.grad_fn).__name__ == "RGLRUBackward" and h_last._base is h
    dh, dl = torch.randn(B, T, W), torch.randn(B, W)
    got = torch.autograd.grad((h, h_last), live, (dh, dl))
    full = dh.clone()
    full[:, -1] += dl
    want = ref.rglru_scan_bwd_ref(*ins, h.detach(), full)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    h, h_last = ops.rglru_scan(*live, lengths=torch.tensor([21, 9]))
    assert torch.equal(h_last.detach(), h.detach()[[0, 1], [20, 8]])
    with torch.no_grad():
        assert ops.rglru_scan(*live)[0].grad_fn is None
