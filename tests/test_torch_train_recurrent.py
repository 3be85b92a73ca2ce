"""Training the recurrent families (rwkv6-3b, recurrentgemma-9b) in the
port, held against the JAX package on the CPU: the plain versions of the
two backward kernels (``ref.wkv6_chunked_bwd_ref``,
``ref.rglru_scan_bwd_ref``: the kernels' own algebra, not autograd)
against ``jax.vjp`` of JAX's ``wkv6_chunked`` and of ``_rglru_coeffs`` +
``_rglru_scan``, against autograd through the plain forwards, and
against float64 at decays down to 1e-6 (the autograd Functions
``wkv6.WKV6`` and ``rglru.RGLRU``, their launches swapped for the plain
versions, are in ``test_torch_train.py`` beside flash attention's); the
C entries' ctypes signatures; Griffin's QAT in ``rec_mix_apply``; AdamW on the families'
float32 leaves; and the train CLI with ``--ckpt``, a bitwise resume and
``serve --ckpt`` for each family.

Tolerances: 1e-5 of each gradient's max |g| in float32 (sums in other
orders). The decay's gradient dw = d(log w) / w is held as w·dw where
decays reach below 1e-2: the division carries a rounding of d(log w)
multiplied by 1/w (1e6 at w = 1e-6; JAX's float32 dw there is 0.03-0.12
of max |dw| from float64's), and the model multiplies dw by w again
(w = exp(-exp(x))).
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
from repro.models import griffin as jgriffin
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import tree as tr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import parse_quant_token
from repro_torch.kernels import build, ops, ref, rglru, wkv6
from repro_torch.models import griffin
from repro_torch.optim import adamw
from torch_parity import to_numpy_tree

RNG = np.random.default_rng(29)
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# -- wkv6: the plain backward -------------------------------------------------------

def _wkv_inputs(B, T, H, K, wlo, carried, rng=RNG):
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) for _ in range(3))
    w = np.exp(rng.uniform(np.log(wlo), 0.0, (B, T, H, K))).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, K, K)) if carried
          else np.zeros((B, H, K, K))).astype(np.float32)
    do = rng.standard_normal((B, T, H, K)).astype(np.float32)
    ds = rng.standard_normal((B, H, K, K)).astype(np.float32) if carried else None
    return (r, k, v, w, u, s0), do, ds


def _plain_wkv_bwd(inputs, do, ds, chunk):
    t = [torch.from_numpy(x) for x in inputs]
    _, _, states = ref.wkv6_chunked_ref(*t, chunk, return_states=True)
    return [g.numpy() for g in ref.wkv6_chunked_bwd_ref(
        *t[:5], states, torch.from_numpy(do), None if ds is None else torch.from_numpy(ds),
        chunk)]


# (B, T, H, K, chunk, least decay, carried state and dstate)
WKV_CASES = {
    "T a multiple of the chunk": (2, 32, 2, 8, 16, 0.3, False),
    "T no multiple of the chunk": (2, 37, 2, 8, 16, 0.3, False),
    "carried state and dstate": (2, 40, 3, 16, 16, 0.3, True),
    "decays down to 1e-6": (1, 40, 3, 16, 16, 1e-6, True),
    "T below one chunk": (2, 20, 2, 8, 64, 0.5, False),
}


@pytest.mark.parametrize("case", list(WKV_CASES))
def test_plain_wkv6_backward_matches_jax_vjp(case):
    """dr, dk, dv, dw, du and dstate_in of the plain backward against
    ``jax.vjp`` of JAX's ``wkv6_chunked`` (its chunk shrinks to T below
    one chunk; the port pads), within 1e-5 of max |g|; dw as w·dw where
    decays reach below 1e-2 (the module docstring)."""
    B, T, H, K, C, wlo, carried = WKV_CASES[case]
    inputs, do, ds = _wkv_inputs(B, T, H, K, wlo, carried)
    (_, _), vjp = jax.vjp(lambda *a: jax_wkv6_chunked(*a, chunk=C),
                          *map(jnp.asarray, inputs))
    want = [np.asarray(g) for g in vjp((jnp.asarray(do),
                                        jnp.asarray(np.zeros_like(inputs[5]) if ds is None
                                                    else ds)))]
    got = _plain_wkv_bwd(inputs, do, ds, C)
    if wlo < 1e-2:
        got[3], want[3] = got[3] * inputs[3], want[3] * inputs[3]
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got, want):
        assert a.shape == b.shape and _rel(a, b) <= TOL, (name, _rel(a, b))


def _seq64(r, k, v, w, u, s0):
    """The recurrence token by token in float64."""
    S, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, 1), S


def test_plain_wkv6_backward_at_tiny_decays_matches_float64():
    """Decays down to 1e-6 over 64-token chunks (a chunk's log-decay
    prefix reaches -884, where float32's spacing is 6e-5): the plain
    backward, whose exponents are sums over s < j < t and never the
    difference of two long prefixes, within 1e-5 of max |g| of autograd
    through the float64 token-by-token recurrence (dw as w·dw). JAX's
    float32 gradient parts from it by 1.6e-5 (dr) there."""
    inputs, do, ds = _wkv_inputs(1, 130, 2, 16, 1e-6, True)
    got = _plain_wkv_bwd(inputs, do, ds, 64)
    live = [torch.from_numpy(x).double().requires_grad_(True) for x in inputs]
    want = [g.numpy() for g in torch.autograd.grad(
        _seq64(*live), live, (torch.from_numpy(do).double(), torch.from_numpy(ds).double()))]
    got[3], want[3] = got[3] * inputs[3], want[3] * inputs[3]
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got, want):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


@pytest.mark.parametrize("case", ["T no multiple of the chunk", "carried state and dstate"])
def test_plain_wkv6_backward_matches_autograd_through_the_plain_forward(case):
    """The second oracle: autograd through ``ref.wkv6_chunked_ref``."""
    B, T, H, K, C, wlo, carried = WKV_CASES[case]
    inputs, do, ds = _wkv_inputs(B, T, H, K, wlo, carried)
    got = _plain_wkv_bwd(inputs, do, ds, C)
    live = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out, state = ref.wkv6_chunked_ref(*live, C)
    want = torch.autograd.grad(
        (out, state), live,
        (torch.from_numpy(do), torch.zeros_like(state) if ds is None else torch.from_numpy(ds)))
    for a, b in zip(got, want):
        assert _rel(a, b.numpy()) <= TOL


def test_plain_wkv6_backward_gives_pads_and_clamped_decays_nothing():
    """A T no multiple of the chunk returns gradients of T rows (its pads
    get none); a decay at or below JAX's 1e-12 clamp gets dw = 0."""
    inputs, do, ds = _wkv_inputs(1, 21, 2, 8, 0.3, False)
    inputs[3][0, 5, 1, :4] = 1e-13
    got = _plain_wkv_bwd(inputs, do, ds, 16)
    assert got[0].shape == (1, 21, 2, 8) and got[3].shape == (1, 21, 2, 8)
    assert (got[3][0, 5, 1, :4] == 0).all() and (got[3][0, 5, 1, 4:] != 0).all()


# -- the RG-LRU: the plain backward ---------------------------------------------------

def _rglru_inputs(B, T, W, carried, lam_range, rng=RNG):
    y = rng.standard_normal((B, T, W)).astype(np.float32)
    A_r, A_i = ((rng.standard_normal((W, W)) / np.sqrt(W)).astype(np.float32)
                for _ in range(2))
    ab, ib = ((rng.standard_normal(W) * 0.1).astype(np.float32) for _ in range(2))
    lam = rng.uniform(*lam_range, W).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if carried else None
    dh = rng.standard_normal((B, T, W)).astype(np.float32)
    return y, A_r, A_i, ab, ib, lam, h0, dh


def _jax_rglru(y, A_r, A_i, ab, ib, lam, h0):
    mix = {"rg_a_proj": A_r, "rg_i_proj": A_i, "rg_a_bias": ab, "rg_i_bias": ib,
           "lambda_p": lam}
    a, b = jgriffin._rglru_coeffs(mix, y)
    return jgriffin._rglru_scan(a, b, h0)


def _plain_rglru_grads(y, A_r, A_i, ab, ib, lam, h0, dh):
    """The plain backward chained through the two gate projections, as the
    model's autograd chains ``rglru_bwd`` through ``dense_matmul``: the
    gradients of (y, A_r, A_i, a_bias, i_bias, lam, h0)."""
    t = {n: None if x is None else torch.from_numpy(x)
         for n, x in zip(("y", "A_r", "A_i", "ab", "ib", "lam", "h0", "dh"),
                         (y, A_r, A_i, ab, ib, lam, h0, dh))}
    ga, gi = t["y"] @ t["A_r"], t["y"] @ t["A_i"]
    h, _ = ref.rglru_scan_ref(ga, gi, t["y"], t["ab"], t["ib"], t["lam"], t["h0"])
    dga, dgi, dy, dab, dib, dlam, dh0 = ref.rglru_scan_bwd_ref(
        ga, gi, t["y"], t["ab"], t["ib"], t["lam"], t["h0"], h, t["dh"])
    dy = dy + dga @ t["A_r"].T + dgi @ t["A_i"].T
    flat = t["y"].reshape(-1, y.shape[-1])
    dA_r = flat.T @ dga.reshape(flat.shape)
    dA_i = flat.T @ dgi.reshape(flat.shape)
    return [None if g is None else g.numpy() for g in (dy, dA_r, dA_i, dab, dib, dlam, dh0)]


# (B, T, W, carried h0 and its gradient, the range of Lambda)
RGLRU_CASES = {
    "zero h0": (2, 37, 16, False, (-3.0, 3.0)),
    "carried h0": (2, 37, 16, True, (-3.0, 3.0)),
    "Lambda at the clamp (a rounds to 1)": (2, 30, 16, True, (-30.0, -20.0)),
    "Lambda near the clamp": (2, 30, 16, True, (-19.0, -8.0)),
}


@pytest.mark.parametrize("case", [c for c in RGLRU_CASES if c != "Lambda near the clamp"])
def test_plain_rglru_backward_matches_jax_vjp(case):
    """The plain backward chained through the gate projections against
    ``jax.vjp`` of JAX's ``_rglru_coeffs`` + ``_rglru_scan`` (the
    associative scan): y, A_r, A_i, both biases, Lambda and h0 within
    1e-5 of max |g|. Lambda from -30 to -20 makes a round to 1, so 1 - a²
    sits at the 1e-12 clamp, where the square root's gradient is 0. Just
    above it (Lambda -19 to -8), 1 - a² is down to 6e-8, a float32
    rounding of a moves it by its own size and sqrt's gradient 0.5 /
    sqrt(1 - a²) with it: JAX's exp and PyTorch's round a apart in the
    last bit there (9e-4 of max |dy| seen), so that case is held against
    autograd through the plain forward, which computes the same a."""
    B, T, W, carried, lam_range = RGLRU_CASES[case]
    y, A_r, A_i, ab, ib, lam, h0, dh = _rglru_inputs(B, T, W, carried, lam_range)
    args = [y, A_r, A_i, ab, ib, lam] + ([h0] if carried else [])
    f = (lambda *a: _jax_rglru(*a)) if carried else (lambda *a: _jax_rglru(*a, None))
    _, vjp = jax.vjp(f, *map(jnp.asarray, args))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dh))]
    got = _plain_rglru_grads(y, A_r, A_i, ab, ib, lam, h0, dh)
    names = ("dy", "dA_r", "dA_i", "da_bias", "di_bias", "dlam", "dh0")
    for name, a, b in zip(names, got, want):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
    assert (got[6] is None) == (not carried)


@pytest.mark.parametrize("case", ["carried h0", "Lambda at the clamp (a rounds to 1)",
                                  "Lambda near the clamp"])
def test_plain_rglru_backward_matches_autograd_through_the_plain_forward(case):
    """The second oracle: autograd through ``ref.rglru_scan_ref``; the
    plain backward's dga, dgi and dh0 bitwise it (the same float32 ops
    per element), dy and the (W,) sums within 1e-5."""
    B, T, W, carried, lam_range = RGLRU_CASES[case]
    y, _, _, ab, ib, lam, h0, dh = _rglru_inputs(B, T, W, carried, lam_range)
    ga, gi = (RNG.standard_normal((B, T, W)).astype(np.float32) for _ in range(2))
    ins = [torch.from_numpy(x) for x in (ga, gi, y, ab, ib, lam, h0)]
    live = [x.clone().requires_grad_(True) for x in ins]
    h, _ = ref.rglru_scan_ref(*live)
    want = torch.autograd.grad(h, live, torch.from_numpy(dh))
    got = ref.rglru_scan_bwd_ref(*ins, h.detach(), torch.from_numpy(dh))
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= TOL


# -- the C entries ----------------------------------------------------------------

@pytest.mark.parametrize("entry,module,attr", [("wkv6_bwd", wkv6, "BWD_ARGTYPES"),
                                               ("rglru_bwd", rglru, "RGLRU_BWD_ARGTYPES")])
def test_backward_argtypes_match_the_source(entry, module, attr):
    """Each backward C entry's ctypes signature read from its source; the
    library is built with the others and counted by ``ops``."""
    src = (build.CSRC / f"{entry}.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params.split(",")]
    assert getattr(module, attr) == want
    assert entry in build.KERNELS and entry in ops.launch_counts()
    ops.reset_launch_counts()
    assert ops.launch_counts()[entry] == 0


# -- the models -----------------------------------------------------------------------

def test_griffin_rec_mix_fake_quantizes_under_qat():
    """Under a QuantConfig (QAT) ``rec_mix_apply`` fake-quantizes
    ``rg_gate``, ``rg_in`` and ``rg_out`` as JAX's does: the reduced
    Griffin's first recurrent mixer under w4a8 against JAX's, float32, and
    apart from the unquantized mixer."""
    jcfg = dataclasses.replace(jax_reduced("recurrentgemma-9b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("recurrentgemma-9b"), dtype="float32")
    jparams = jax.tree_util.tree_map(lambda a: a[0], jgriffin.init_params(
        jax.random.PRNGKey(0), jcfg)["groups"]["l0_rglru"]["mix"])
    mix = convert.params_from_numpy(to_numpy_tree(jparams), "cpu")
    x = RNG.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    jq, tq = jcfg.with_quant(jax_quant("w4a8")), tcfg.with_quant(parse_quant_token("w4a8"))
    want, _ = jgriffin.rec_mix_apply(jparams, jq, jnp.asarray(x))
    got, _ = griffin.rec_mix_apply(mix, tq, torch.from_numpy(x))
    plain, _ = griffin.rec_mix_apply(mix, tcfg, torch.from_numpy(x))
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    assert _rel(plain.numpy(), np.asarray(want)) > 1e-3


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_remat_changes_no_bit_in_the_recurrent_families(arch):
    """``cfg.remat`` checkpoints each rwkv6 layer and each Griffin group
    (its ``rem`` layers are not): the loss and every gradient bitwise those
    without it (reduced Griffin at 5 layers: one group and a 2-layer rem)."""
    from repro_torch.data import DataIterator
    from repro_torch.models import build_model

    over = {"num_layers": 5} if arch == "recurrentgemma-9b" else {}
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32", **over)
    params = build_model(cfg).init(seed=0, device="cpu")
    batch = DataIterator(cfg, global_batch=2, seq_len=24, seed=0).batch_at(0)
    out = []
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        live = tr.map_tree(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = model.train_loss(live, batch)
        out.append((loss, torch.autograd.grad(loss, tr.leaves(live))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# rwkv6's decay_base and u, Griffin's lambda_p and gate biases.
F32_LEAVES = {"rwkv6-3b": ("decay_base", "u"),
              "recurrentgemma-9b": ("lambda_p", "rg_a_bias", "rg_i_bias")}


@pytest.mark.parametrize("arch", list(F32_LEAVES))
def test_adamw_keeps_the_float32_leaves_and_is_bitwise_jax_on_them(arch):
    """The families' float32 leaves beside bf16 ones: carried from JAX's
    reduced params they keep their dtype, and three AdamW steps on them
    (with a bf16 matrix beside them: AdamW is elementwise per leaf) from
    the same random gradients give JAX's params and moments bitwise."""
    jtree = jax_build(jax_reduced(arch)).init(jax.random.PRNGKey(1))
    ttree = convert.params_from_numpy(to_numpy_tree(jtree), "cpu")
    tflat = {tr.path_str(p): x for p, x in tr.flatten_with_path(ttree)}
    jflat = {jax.tree_util.keystr(p, simple=True, separator="/"): x
             for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    f32 = sorted(p for p in tflat if p.rsplit("/", 1)[-1] in F32_LEAVES[arch])
    bf16 = next(p for p, x in tflat.items() if x.dtype == torch.bfloat16 and x.ndim == 3)
    assert f32 and all(tflat[p].dtype == torch.float32 for p in f32)
    keys = f32 + [bf16]
    jp, tp = {k: jflat[k] for k in keys}, {k: tflat[k] for k in keys}
    assert all(str(jp[k].dtype) == str(tp[k].dtype).replace("torch.", "") for k in keys)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    js, ts = jadamw.init_state(jp), adamw.init_state(tp)
    lr = lambda s: kw["lr"] * (s / 10)     # noqa: E731  (one schedule for both)
    for _ in range(3):
        g = {k: RNG.standard_normal(tp[k].shape).astype(np.float32) for k in keys}
        jp, js, _ = jadamw.apply_updates(jp, {k: jnp.asarray(v, jp[k].dtype)
                                              for k, v in g.items()}, js, jtc, lr)
        tp, ts, _ = adamw.apply_updates(tp, {k: torch.from_numpy(v).to(tp[k].dtype)
                                             for k, v in g.items()}, ts, tc, lr)
    for name, (a, b) in {"params": (jp, tp), "mu": (js.mu, ts.mu),
                         "nu": (js.nu, ts.nu)}.items():
        for k in keys:
            assert b[k].dtype == (torch.bfloat16 if name == "params" and k == bf16
                                  else torch.float32), (name, k)
            assert np.array_equal(np.asarray(a[k], np.float32), b[k].float().numpy()), (name, k)


# -- the train CLI, checkpoints and serve --ckpt ------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_train_cli_resumes_bitwise_and_serve_ckpt_runs(arch, tmp_path, capsys):
    """``launch.train`` trains the reduced family for 6 steps with --ckpt
    (saves at 2, 4, 6); with step 6's checkpoint removed, a restart resumes
    at step 4 and its step-6 checkpoint is bitwise the uninterrupted one's,
    every array; ``serve --ckpt`` restores and serves it."""
    import shutil

    from repro_torch.launch import serve, train

    ck = tmp_path / "ck"
    argv = ["--arch", arch, "--reduced", "--steps", "6", "--seq", "32", "--global-batch", "4",
            "--ckpt", str(ck), "--device", "cpu"]
    train.main(argv)
    out = capsys.readouterr().out
    assert f"arch: {arch}-smoke" in out and "done: 6 logged steps" in out
    assert CheckpointManager(ck).latest_step() == 6
    whole = tmp_path / "whole"
    shutil.copytree(ck / "6", whole)
    shutil.rmtree(ck / "6")
    train.main(argv)
    out = capsys.readouterr().out
    assert len(re.findall(r"^step +\d+  loss", out, re.M)) == 2, out
    with np.load(whole / "arrays.npz") as a, np.load(ck / "6" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[f], b[f]) for f in a.files)
    serve.main(["--arch", arch, "--reduced", "--ckpt", str(ck), "--device", "cpu",
                "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "restored checkpoint step 6" in out and "req 1: [" in out
