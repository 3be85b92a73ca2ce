"""The port's checkpoint manager (``repro_torch.checkpoint``) held against
the JAX package's: the cases of ``tests/test_checkpoint.py`` (atomic
saves, keep-K, uncommitted steps ignored, shape checks, async saves),
JAX's leaf paths and order, and checkpoints crossing both ways bitwise —
a TrainState written by either package (bf16 params, float32 moments,
the int32 step, error-feedback leaves) restores in the other with every
leaf's bits and dtype, for olmo-1b, rwkv6-3b and recurrentgemma-9b."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.train.loop import init_train_state as jax_init_state
from repro_torch import tree as tr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import build_model
from repro_torch.train.loop import TrainState, init_train_state

RNG = np.random.default_rng(3)


def _state(tc=TrainConfig()):
    params = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
              "b": torch.ones((4,), dtype=torch.bfloat16)}
    return init_train_state(params, tc)


def _meta_state(tc=TrainConfig()):
    return init_train_state({"w": torch.empty((3, 4), device="meta"),
                             "b": torch.empty((4,), dtype=torch.bfloat16, device="meta")}, tc)


def _as_np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state()
    mgr.save(10, state, data_state={"step": 10, "seed": 0, "host_id": 0})
    restored, data_state, step = mgr.restore(_state, device="cpu")
    assert step == 10 and data_state["step"] == 10
    for a, b in zip(tr.leaves(state), tr.leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype and a.shape == b.shape


def test_restore_from_a_meta_template_draws_nothing(tmp_path):
    """A template on ``meta`` (shapes and dtypes only) restores the same
    state; so does the model's own init on ``meta``."""
    mgr = CheckpointManager(tmp_path)
    state = _state()
    mgr.save(1, state)
    restored, _, _ = mgr.restore(_meta_state, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tr.leaves(state), tr.leaves(restored)))
    cfg = get_reduced_config("olmo-1b")
    meta = build_model(cfg).init(seed=0, device="meta")
    assert all(p.device.type == "meta" for p in tr.leaves(meta))
    assert [p.shape for p in tr.leaves(meta)] == [
        p.shape for p in tr.leaves(build_model(cfg).init(seed=0, device="cpu"))]


def test_keep_k_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert sorted(int(p.name) for p in tmp_path.iterdir() if p.name.isdigit()) == [3, 4]
    assert mgr.latest_step() == 4


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, _state())
    (tmp_path / "6").mkdir()
    (tmp_path / "6" / "manifest.json").write_text(json.dumps({"leaves": []}))
    assert mgr.latest_step() == 5
    assert mgr.restore(_state, device="cpu")[2] == 5


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state())

    def bad_template():
        return init_train_state({"w": torch.zeros((5, 5)),
                                 "b": torch.zeros((4,), dtype=torch.bfloat16)}, TrainConfig())

    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad_template, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(lambda: init_train_state({"v": torch.zeros(2)}, TrainConfig()),
                    device="cpu")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_state, device="cpu")


def test_async_save_copies_before_returning(tmp_path):
    """An async save holds its own host copy: the state updated in place
    right after ``save`` returns does not reach the file."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    state = _state()
    mgr.save(7, state)
    state.params["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _, _ = mgr.restore(_state, device="cpu")
    assert torch.equal(restored.params["w"], state.params["w"] - 100.0)


def test_restore_places_leaves_on_the_device(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, _state())
    restored, _, _ = mgr.restore(_state, device="cpu")
    assert all(t.device.type == "cpu" for t in tr.leaves(restored))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(_state)


def test_files_and_paths_are_jax_s(tmp_path):
    """The same state saved by both packages gives the same manifest (leaf
    keys, paths, dtypes, shapes in JAX's order) and the same arrays."""
    jstate = jax_init_state({"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                             "b": {"z": jnp.ones((4,), jnp.bfloat16), "a": jnp.zeros(2)}},
                            JaxTrainConfig(grad_compress_bits=8))
    tstate = init_train_state({"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                               "b": {"z": torch.ones((4,), dtype=torch.bfloat16),
                                     "a": torch.zeros(2)}}, TrainConfig(grad_compress_bits=8))
    JaxManager(tmp_path / "j").save(3, jstate, {"step": 3, "seed": 0, "host_id": 0})
    CheckpointManager(tmp_path / "t").save(3, tstate, {"step": 3, "seed": 0, "host_id": 0})
    mj = json.loads((tmp_path / "j" / "3" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "3" / "manifest.json").read_text())
    assert mj == mt
    assert [leaf["path"] for leaf in mt["leaves"]][:4] == [
        "params/b/a", "params/b/z", "params/w", "opt/step"]
    assert "err/w" in {leaf["path"] for leaf in mt["leaves"]}
    with np.load(tmp_path / "j" / "3" / "arrays.npz") as a, \
            np.load(tmp_path / "t" / "3" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert ((tmp_path / "j" / "3" / "data_state.json").read_text()
            == (tmp_path / "t" / "3" / "data_state.json").read_text())


@pytest.fixture(scope="module", params=["olmo-1b", "rwkv6-3b", "recurrentgemma-9b",
                                        "mixtral-8x22b", "llama4-maverick-400b-a17b"])
def olmo_states(request):
    """A reduced TrainState (bf16 params, two AdamW steps' moments) of each
    family in each package from the same numbers: olmo-1b, rwkv6-3b (its
    float32 decay_base and u beside bf16 leaves), recurrentgemma-9b
    (Griffin's group-stacked tree, its rem layers and float32 gates) and
    the MoE decoders (the float32 router beside bf16 expert leaves under
    ``experts_tp`` for mixtral-8x22b, ``experts_ep`` for llama4)."""
    arch = request.param
    params = jax_build(jax_reduced(arch)).init(jax.random.PRNGKey(0))
    jstate = jax_init_state(params, JaxTrainConfig(grad_compress_bits=8))
    noisy = jax.tree_util.tree_map(
        lambda l: jnp.asarray(RNG.standard_normal(l.shape).astype(np.float32)).astype(l.dtype)
        if l.ndim else l + 2, jstate)
    return arch, noisy, TrainConfig(grad_compress_bits=8)


def _torch_template(arch, tc):
    return init_train_state(build_model(get_reduced_config(arch)).init(0, "meta"), tc)


def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path, olmo_states):
    arch, jstate, tc = olmo_states
    JaxManager(tmp_path).save(4, jstate, {"step": 4, "seed": 0, "host_id": 0})
    state, data_state, step = CheckpointManager(tmp_path).restore(
        lambda: _torch_template(arch, tc), device="cpu")
    assert step == 4 and data_state == {"step": 4, "seed": 0, "host_id": 0}
    assert isinstance(state, TrainState)
    jl = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tl = tr.flatten_with_path(state)
    assert len(jl) == len(tl)
    for (jp, a), (tp, b) in zip(jl, tl):
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), tr.path_str(tp)
        assert np.array_equal(np.asarray(a, np.float32), _as_np(b).astype(np.float32))
    dtypes = {p.dtype for p in tr.leaves(state.params)}
    assert torch.bfloat16 in dtypes and (arch == "olmo-1b") == (torch.float32 not in dtypes)
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 2


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path, olmo_states):
    arch, jstate, tc = olmo_states
    JaxManager(tmp_path / "j").save(4, jstate)
    state, _, _ = CheckpointManager(tmp_path / "j").restore(
        lambda: _torch_template(arch, tc), device="cpu")
    CheckpointManager(tmp_path / "t").save(9, state, {"step": 9, "seed": 0, "host_id": 0})
    jcfg = jax_reduced(arch)
    back, data_state, step = JaxManager(tmp_path / "t").restore(
        lambda: jax_init_state(jax_build(jcfg).init(jax.random.PRNGKey(1)),
                               JaxTrainConfig(grad_compress_bits=8)))
    assert step == 9 and data_state["step"] == 9
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a, np.float32),
                                                     np.asarray(b, np.float32))
    # JAX's serve restores with the default TrainConfig: no error leaves.
    back2, _, _ = JaxManager(tmp_path / "t").restore(
        lambda: jax_init_state(jax_build(jcfg).init(jax.random.PRNGKey(1)), JaxTrainConfig()))
    assert back2.err is None
