"""The port's data pipeline (``repro_torch.data``, its own numpy copy of
``repro.data.pipeline``) held against the JAX package's: every batch
bitwise JAX's for the olmo, VLM and encoder configs at any (seed, step,
host), also at olmo-1b's full vocabulary, the iterator protocol and its
state restore, and the cases of ``tests/test_data.py``."""
import numpy as np
import pytest

from repro.configs import get_reduced_config as jax_reduced
from repro.data import DataIterator as JaxIterator
from repro_torch.configs import get_reduced_config
from repro_torch.data import DataIterator

ARCHS = ["olmo-1b", "paligemma-3b", "hubert-xlarge"]


def _it(**kw):
    cfg = get_reduced_config("olmo-1b")
    defaults = dict(global_batch=4, seq_len=16, seed=7)
    defaults.update(kw)
    return DataIterator(cfg, **defaults)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,step,host,hosts,branch", [
    (0, 0, 0, 1, 32), (7, 5, 1, 2, 4), (3, 11, 3, 4, 8)])
def test_batches_bitwise_jax(arch, seed, step, host, hosts, branch):
    kw = dict(global_batch=8, seq_len=48, seed=seed, host_id=host, host_count=hosts,
              branch=branch)
    want = JaxIterator(jax_reduced(arch), **kw).batch_at(step)
    got = DataIterator(get_reduced_config(arch), **kw).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_full_vocab_batches_bitwise_jax():
    """At olmo-1b's full 50 304-entry vocabulary (the unigram draws take
    numpy's ``choice`` algorithm with one cdf built up front)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    kw = dict(global_batch=4, seq_len=96, seed=5, branch=8)
    want = JaxIterator(jax_config("olmo-1b"), **kw).batch_at(2)["tokens"]
    got = DataIterator(get_config("olmo-1b"), **kw).batch_at(2)["tokens"]
    assert np.array_equal(got, want)


def test_choice_is_numpys():
    from repro_torch.data import SyntheticLM

    src = SyntheticLM(777, seed=1)
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for n in (1, 8, 33):
        assert np.array_equal(src._choice(a, n), b.choice(777, size=n, p=src.unigram))


@pytest.mark.parametrize("arch", ARCHS)
def test_iterator_and_state_restore_bitwise_jax(arch):
    """next() from both iterators, then each restored from the other's
    state, continues with the same batches."""
    kw = dict(global_batch=4, seq_len=40, seed=2, branch=8)
    jit, tit = JaxIterator(jax_reduced(arch), **kw), DataIterator(get_reduced_config(arch), **kw)
    for _ in range(3):
        a, b = next(jit), next(tit)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert tit.get_state() == jit.get_state() == {"step": 3, "seed": 2, "host_id": 0}
    j2, t2 = JaxIterator(jax_reduced(arch), **kw), DataIterator(get_reduced_config(arch), **kw)
    t2.set_state(jit.get_state())
    j2.set_state(tit.get_state())
    a, b = next(j2), next(t2)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert t2.step == 4


def test_deterministic_across_instances():
    np.testing.assert_array_equal(_it().batch_at(3)["tokens"], _it().batch_at(3)["tokens"])


def test_steps_differ():
    it = _it()
    assert not np.array_equal(it.batch_at(0)["tokens"], it.batch_at(1)["tokens"])


def test_host_sharding_disjoint_and_sized():
    h0 = _it(host_id=0, host_count=2).batch_at(0)["tokens"]
    h1 = _it(host_id=1, host_count=2).batch_at(0)["tokens"]
    assert h0.shape == (2, 16) and h1.shape == (2, 16)
    assert not np.array_equal(h0, h1)
    with pytest.raises(ValueError, match="hosts"):
        _it(global_batch=5, host_count=2)


def test_iterator_protocol_and_state_restore():
    it = _it()
    for _ in range(3):
        next(it)
    state = it.get_state()
    assert state["step"] == 3
    it2 = _it()
    it2.set_state(state)
    np.testing.assert_array_equal(next(it2)["tokens"], it.batch_at(3)["tokens"])
    with pytest.raises(ValueError, match="seed"):
        _it(seed=8).set_state(state)


def test_rewind_drops_stale_prefetches():
    """set_state to an earlier step while the worker has prefetched ahead:
    the next batch is the rewound step's."""
    it = _it()
    for _ in range(5):
        next(it)
    it.set_state({"step": 1, "seed": 7, "host_id": 0})
    np.testing.assert_array_equal(next(it)["tokens"], it.batch_at(1)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"], it.batch_at(2)["tokens"])


def test_prefetch_builds_each_batch_once():
    """The worker offers a built batch until the queue takes it: with the
    queue full it builds nothing more (the JAX package's rebuilt it at
    every 0.2 s timeout, holding the interpreter lock the training loop
    needs). At most the consumed batch, the queue's two and the one being
    offered are built."""
    import time

    it = _it()
    built = []
    orig = it.batch_at
    it.batch_at = lambda step: built.append(step) or orig(step)
    next(it)
    time.sleep(0.9)
    assert len(built) <= 4 and built == sorted(set(built))
    it.set_state({"step": 0, "seed": 7, "host_id": 0})     # stops the worker cleanly
    np.testing.assert_array_equal(next(it)["tokens"], orig(0)["tokens"])


def test_vlm_and_encoder_batches():
    vlm = get_reduced_config("paligemma-3b")
    b = DataIterator(vlm, global_batch=2, seq_len=16, seed=0).batch_at(0)
    assert b["patches"].shape == (2, vlm.num_prefix_embeds, vlm.frontend_dim)
    assert b["tokens"].shape == (2, 16 - vlm.num_prefix_embeds)
    enc = get_reduced_config("hubert-xlarge")
    b = DataIterator(enc, global_batch=2, seq_len=16, seed=0).batch_at(0)
    assert b["frames"].shape == (2, 16, enc.frontend_dim)
    assert b["labels"].shape == (2, 16) and b["labels"].max() < enc.vocab


def test_token_distribution_is_learnable():
    toks = _it(global_batch=8, seq_len=256, branch=4).batch_at(0)["tokens"]
    bigrams = set(zip(toks[:, :-1].reshape(-1), toks[:, 1:].reshape(-1)))
    assert len(bigrams) < 0.7 * toks.size
