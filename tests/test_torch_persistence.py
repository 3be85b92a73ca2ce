"""Corrupt and stale prefix-index files against the port: the index half
of ``tests/test_persistence.py`` (the ``--plans`` half waits for the
port's kernel registry).

A missing, truncated, garbage or wrong-schema file, and an index whose
digest table is not hex, points past its blocks or whose block bytes
have the wrong size, warns and cold-starts with 0 digests loaded. Nothing
raises out of a load, the pool invariants hold, and the engine then
serves the stream cold with the tokens of the good file's run. Each mode
is held through a live scheduler's ``load_index`` and through the
engine's load before its first ``generate`` (held, then imported when
the scheduler is built).
"""
import json

import numpy as np
import pytest

from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine, assert_pool_invariants

SYS = np.arange(24) % 64
PATHS = pytest.mark.parametrize("path", ["scheduler", "deferred"])


@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _engine(cfg, params):
    return ServingEngine(cfg, params, max_batch=2, bucket=16, paged=True, block_size=4,
                         pool_blocks=40, prefix_cache=True, chunked_prefill=False,
                         preempt=False, host_pool_bytes=1 << 20, device="cpu")


def _requests(n=2):
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=np.concatenate(
                [SYS, rng.integers(0, 64, 3 + i)]).astype(np.int64),
                max_new_tokens=3, temperature=0.0)
            for i in range(n)]


@pytest.fixture(scope="module")
def saved_index(olmo, tmp_path_factory):
    """One good index file and the tokens of the stream that wrote it."""
    cfg, params = olmo
    path = tmp_path_factory.mktemp("idx") / "good.json"
    eng = _engine(cfg, params)
    out = [r.out_tokens for r in eng.generate(_requests())]
    assert eng.save_index(path) > 0
    return path, out


def _load(eng, file, path):
    """Load `file` through a live scheduler, or before the first
    generate (the payload held, imported with the scheduler). Returns
    the digests the scheduler holds from it."""
    if path == "scheduler":
        eng.generate(_requests(n=1))   # a live scheduler: the checked load
        return eng.load_index(file)
    eng.load_index(file)
    eng.generate(_requests(n=1))       # the held payload is imported here
    return len(eng._sched._host_index)


@PATHS
@pytest.mark.parametrize("mutate", [
    pytest.param(lambda d, txt: txt[: len(txt) // 2], id="truncated"),
    pytest.param(lambda d, txt: "not json {{{", id="garbage"),
    pytest.param(lambda d, txt: json.dumps({**d, "version": 99}), id="wrong-version"),
    pytest.param(lambda d, txt: json.dumps({**d, "schema": "other"}), id="wrong-schema"),
    pytest.param(lambda d, txt: json.dumps(
        {**d, "digests": {next(iter(d["digests"])): 9999}}), id="digest-out-of-range"),
    pytest.param(lambda d, txt: json.dumps({**d, "digests": {"zz-not-hex": 0}}),
                 id="digest-not-hex"),
    pytest.param(lambda d, txt: json.dumps({**d, "blocks": "bad"}),
                 id="blocks-not-a-list"),
    pytest.param(lambda d, txt: json.dumps(
        {**d, "blocks": [{"k": "AAAA", "v": "AAAA", "k_scale": None, "v_scale": None}]
         * len(d["blocks"])}), id="block-bytes-wrong-size"),
])
def test_load_index_corrupt_cold_starts(olmo, saved_index, tmp_path, mutate, path):
    """Every corruption mode warns, loads 0 digests, leaves the pool
    invariant-clean, and the engine still serves (cold)."""
    cfg, params = olmo
    good_path, good_out = saved_index
    data = json.loads(good_path.read_text())
    bad = tmp_path / "bad.json"
    bad.write_text(mutate(data, good_path.read_text()))

    eng = _engine(cfg, params)
    with pytest.warns(UserWarning):
        assert _load(eng, bad, path) == 0
    out = [r.out_tokens for r in eng.generate(_requests())]
    assert out == good_out                  # cold serve, same tokens
    assert_pool_invariants(eng._sched)
    assert eng.pool_stats()["swap_ins"] == 0


def test_load_index_missing_file_cold_starts(olmo, tmp_path):
    cfg, params = olmo
    eng = _engine(cfg, params)
    with pytest.warns(UserWarning, match="cold start"):
        assert eng.load_index(tmp_path / "nope.json") == 0
    # The live scheduler's load too (after the first generate).
    eng.generate(_requests(n=1))
    with pytest.warns(UserWarning, match="cold start"):
        assert eng._sched.load_index(tmp_path / "nope.json") == 0
    assert_pool_invariants(eng._sched)


@PATHS
def test_load_index_good_file_still_loads(olmo, saved_index, path):
    """The robustness shell does not reject the good file: it loads and
    the stream is served warm from host with the same tokens."""
    cfg, params = olmo
    good_path, good_out = saved_index
    n_file = len(json.loads(good_path.read_text())["digests"])
    eng = _engine(cfg, params)
    if path == "deferred":
        assert eng.load_index(good_path) == n_file
    else:
        eng.scheduler(eng._ctx_needed(_requests()))
        assert eng.load_index(good_path) == n_file
    out = [r.out_tokens for r in eng.generate(_requests())]
    assert out == good_out
    assert eng.pool_stats()["swap_ins"] > 0
    assert_pool_invariants(eng._sched)
