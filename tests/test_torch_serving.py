"""The port's serving stack: greedy parity with the JAX scheduler, the
port's own bit-identity contracts, the sampling stream, the CLI, and the
rule that the port never loads JAX."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import parse_policy_spec as jax_policy
from repro.models import build_model as jax_build
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy_spec
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, Request, assert_pool_invariants, sampling
from torch_parity import to_numpy_tree

ROOT = Path(__file__).resolve().parents[1]
POLICY = "w4a8;wo=w8a8"
PROMPTS = [np.arange(10) * 7 % 512, (np.arange(7) * 13 + 3) % 512,
           (np.arange(13) * 5 + 1) % 512]


def test_greedy_tokens_match_jax_scheduler():
    """Three greedy requests through two slots (the third is admitted
    mid-decode) on a float32 copy of the reduced config, JAX weights
    carried across: the port's scheduler emits JAX's tokens."""
    jcfg = dataclasses.replace(jax_reduced("olmo-1b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32")
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    kw = dict(max_batch=2, max_ctx=48, block_size=4, prefill_budget=8)
    jax_sched = JaxScheduler(jcfg, params, quant=jax_policy(POLICY), bucket=16,
                             paged=True, prefix_cache=False, preempt=False,
                             chunked_prefill=True, **kw)
    want = {r.rid: r.out_tokens for r in jax_sched.run(
        [JaxRequest(i, p, max_new_tokens=6) for i, p in enumerate(PROMPTS)])}
    port = ContinuousScheduler(tcfg, convert.params_from_numpy(to_numpy_tree(params), "cpu"),
                               quant=parse_policy_spec(POLICY), preempt=False,
                               device="cpu", **kw)
    got = {r.rid: r.out_tokens for r in port.run(
        [Request(i, p, max_new_tokens=6) for i, p in enumerate(PROMPTS)])}
    assert got == want


@pytest.fixture(scope="module")
def olmo():
    cfg = get_reduced_config("olmo-1b")
    return cfg, build_model(cfg).init(seed=0, device="cpu")


def _sched(cfg, params, **kw):
    args = dict(max_batch=3, max_ctx=64, block_size=4,
                prefill_budget=8, quant=parse_policy_spec(POLICY), device="cpu")
    args.update(kw)
    return ContinuousScheduler(cfg, params, **args)


def _solo_vs_mid_decode(cfg, params, target, first, **kw):
    """`target`'s tokens served alone (each in a fresh scheduler) and
    admitted while `first` is decoding; returns (solo, mixed, scheduler)."""
    solo = {r.rid: _sched(cfg, params, **kw).run([dataclasses.replace(r)])[0].out_tokens
            for r in target}
    mixed = _sched(cfg, params, **kw)
    mixed.submit(first)
    for _ in range(4):
        mixed.step()
    reqs = [dataclasses.replace(r) for r in target]
    for r in reqs:
        mixed.submit(r)
    while mixed.num_active or mixed.num_waiting:
        mixed.step()
    return solo, {r.rid: r.out_tokens for r in reqs}, mixed


@pytest.mark.parametrize("kv_int8", [False, True])
def test_solo_equals_mid_decode_admission(olmo, kv_int8):
    """A request served alone and the same request admitted while other
    slots are deep into their decodes emit identical tokens (greedy and
    sampled), on bf16 and int8 pools, each row owning its blocks (no
    prefix cache)."""
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    target = [Request(10, PROMPTS[2], max_new_tokens=9),
              Request(11, PROMPTS[0], max_new_tokens=7, temperature=0.8, top_k=40)]
    first = Request(0, PROMPTS[1], max_new_tokens=12, temperature=0.7)
    solo, mixed, sched = _solo_vs_mid_decode(cfg, params, target, first,
                                             prefix_cache=False)
    assert mixed == solo
    assert sched.pool_stats()["prefill_chunks_run"] >= 5


@pytest.mark.parametrize("kv_int8", [False, True])
def test_solo_equals_mid_decode_admission_prefix_cache(olmo, kv_int8):
    """The twin with the prefix cache on (the default): the mid-decode
    admissions share the live request's first 8 prompt tokens, hit them,
    chunk-prefill only their tails, and still emit the solo tokens."""
    cfg, params = olmo
    cfg = dataclasses.replace(cfg, kv_cache_quant=kv_int8)
    shared = PROMPTS[2][:8]
    target = [Request(10, np.concatenate([shared, PROMPTS[2]]), max_new_tokens=9),
              Request(11, np.concatenate([shared, PROMPTS[0]]), max_new_tokens=7,
                      temperature=0.8, top_k=40)]
    first = Request(0, np.concatenate([shared, PROMPTS[1]]), max_new_tokens=12,
                    temperature=0.7)
    solo, mixed, sched = _solo_vs_mid_decode(cfg, params, target, first)
    assert mixed == solo
    stats = sched.pool_stats()
    assert stats["prefix_cache"] and stats["prefix_hit_blocks"] >= 4
    assert stats["prefill_chunks_run"] >= 5
    assert_pool_invariants(sched)


def test_reservation_queueing_small_pool(olmo):
    """A pool too small for every request at once: admissions wait for
    blocks (FIFO, preemption off) instead of failing, and every stream is
    unchanged; a request that can never fit comes back failed. Each row
    owns its blocks (no prefix cache)."""
    cfg, params = olmo
    reqs = lambda: [Request(i, p, max_new_tokens=8) for i, p in enumerate(PROMPTS)]
    big = {r.rid: r.out_tokens for r in _sched(cfg, params, prefix_cache=False).run(reqs())}
    small = _sched(cfg, params, pool_blocks=6, prefix_cache=False, preempt=False)
    got = {r.rid: r.out_tokens for r in small.run(reqs())}
    assert got == big
    assert small.pool_stats()["peak_allocated_blocks"] <= 6
    too_big = small.run([Request(9, np.arange(40) % 512, max_new_tokens=8)])[0]
    assert too_big.failed and too_big.out_tokens == []


def test_reservation_queueing_small_pool_prefix_cache(olmo):
    """The twin with the prefix cache on: prompts sharing 8 tokens queue
    for a pool of 6 blocks (preemption off), hit each other's retained
    blocks, evict them when admissions need room, and emit the streams of
    a large pool with the cache off; live blocks never pass the pool."""
    cfg, params = olmo
    shared = PROMPTS[0][:8]
    reqs = lambda: [Request(i, np.concatenate([shared, p[:5]]), max_new_tokens=8)
                    for i, p in enumerate(PROMPTS)]
    big = {r.rid: r.out_tokens for r in _sched(cfg, params, prefix_cache=False).run(reqs())}
    small = _sched(cfg, params, pool_blocks=6, preempt=False)
    got = {r.rid: r.out_tokens for r in small.run(reqs())}
    assert got == big
    stats = small.pool_stats()
    assert stats["peak_allocated_blocks"] <= 6
    assert stats["prefix_hit_blocks"] > 0 and stats["prefix_evictions"] > 0
    too_big = small.run([Request(9, np.arange(40) % 512, max_new_tokens=8)])[0]
    assert too_big.failed and too_big.out_tokens == []
    assert_pool_invariants(small)


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["no-cache", "cache"])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_small_pool_with_preemption(olmo, prefix_cache, chunked):
    """The twins with preemption on (the default on the pool): a pool of 6
    blocks preempts live rows for the queue head, and every stream, greedy
    and sampled, is still the large pool's. A resume prefills prompt ++
    generated: cold without the prefix cache, and with it from whatever of
    the blocks its preemption registered the pool still holds (a pool this
    small evicts them first, so it is cold here as well)."""
    cfg, params = olmo
    reqs = lambda: [Request(i, p, max_new_tokens=8, temperature=0.7 * (i % 2))
                    for i, p in enumerate(PROMPTS)]
    kw = dict(prefix_cache=prefix_cache, chunked_prefill=chunked)
    big = {r.rid: r.out_tokens for r in _sched(cfg, params, **kw).run(reqs())}
    small = _sched(cfg, params, pool_blocks=6, **kw)
    done = []
    for r in reqs():
        small.submit(r)
    while small.num_active or small.num_waiting:
        done += small.step()
        assert_pool_invariants(small)
    assert {r.rid: r.out_tokens for r in done} == big
    stats = small.pool_stats()
    assert stats["preemptions"] >= 1 and stats["peak_allocated_blocks"] <= 6
    assert all(r.error is None and r.preemptions <= 1 for r in done)
    assert stats["prefix_cache"] == prefix_cache
    assert stats["prefix_evictions"] > 0 if prefix_cache else stats["prefix_hit_tokens"] == 0


def test_sample_stream_is_a_function_of_seed_rid_step():
    """The uniforms of (key, step) do not depend on the other rows, and
    the key depends only on (seed, rid)."""
    keys = np.stack([sampling.request_key(0, r) for r in (5, 6, 7)]).astype(np.int64)
    steps = torch.tensor([3, 0, 9])
    u = sampling.uniforms(torch.from_numpy(keys), steps, 50)
    u1 = sampling.uniforms(torch.from_numpy(keys[2:]), steps[2:], 50)
    assert torch.equal(u[2:], u1)
    assert bool(((u > 0) & (u < 1)).all())
    assert np.array_equal(sampling.request_key(0, 7), sampling.request_key(0, 7))
    assert not np.array_equal(sampling.request_key(0, 7), sampling.request_key(1, 7))
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    a = sampling.sample_tokens(logits, [0.7, 0.0, 1.0], [0, 0, 5], keys, [3, 0, 9])
    b = sampling.sample_tokens(logits[2:], [1.0], [5], keys[2:], [9])
    assert a[2] == b[0] and a[1] == logits[1].argmax()


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "olmo-1b", "--reduced", "--continuous", "--device", "cpu",
                "--policy", POLICY, "--requests", "3", "--max-new", "4",
                "--max-batch", "2", "--block-size", "4", "--prefill-budget", "4",
                "--kv-int8"])
    out = capsys.readouterr().out
    assert "precision policy: default=w4a8; wo=w8a8" in out
    assert "3 requests, 12 tokens" in out and "chunked prefill:" in out
    assert "req 2: [" in out and "kv_int8=True" in out
    # The timed pass serves every prompt again: all of it from the blocks
    # the warmup pass left.
    assert "prefix cache: 50% of prompt tokens served from resident blocks" in out


def test_serve_cli_shared_prefix_hits_on_cpu(capsys):
    """--shared-prefix 8 on 4-token blocks: the CLI reports a prefix hit
    rate above 0, and --no-prefix-cache emits the same greedy tokens."""
    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--reduced", "--continuous", "--shared-prefix", "8",
            "--block-size", "4", "--device", "cpu", "--requests", "4", "--max-new", "4"]
    out = {}
    for extra in ([], ["--no-prefix-cache"]):
        _, done, report = serve.run(serve.build_parser().parse_args(argv + extra))
        out[bool(extra)] = ({r.rid: r.out_tokens for r in done if r.temperature == 0},
                            report["stats"])
    assert out[True][0] == out[False][0]
    assert out[False][1]["prefix_hit_rate"] > 0 and not out[True][1]["prefix_cache"]
    assert "prefix cache: " in capsys.readouterr().out


@pytest.mark.parametrize("arch,layers,flags", [
    ("olmo-1b", 1, ["--continuous"]),
    ("rwkv6-3b", 1, ["--static"]),
    ("recurrentgemma-9b", 2, ["--continuous"]),   # no whole group: the remainder only
])
def test_serve_cli_layers_cuts_depth_only(arch, layers, flags):
    """--layers N serves the config's first N layers and keeps every
    width; a depth the config does not have is refused."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
            "--max-new", "3", "--max-batch", "2", *flags]
    engine, done, _ = serve.run(serve.build_parser().parse_args(argv + ["--layers",
                                                                          str(layers)]))
    full = get_reduced_config(arch)
    assert engine.cfg == dataclasses.replace(full, num_layers=layers)
    assert all(len(r.out_tokens) == 3 for r in done)
    for bad in (0, full.num_layers + 1):
        with pytest.raises(SystemExit, match="layers"):
            serve.run(serve.build_parser().parse_args(argv + ["--layers", str(bad)]))


def test_chip_smoke_serves_each_arch_at_its_depth():
    """chip_smoke's serve runs pass --layers at DEPTH for the earlier
    archs, and none for recurrentgemma-9b, which keeps all 38 layers."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.launch import serve

    seen = set()
    for name in chip_smoke.RUNS:
        args = serve.build_parser().parse_args(chip_smoke.serve_argv(name))
        assert args.layers == chip_smoke.DEPTH.get(args.arch)
        assert chip_smoke.serve_config(args.arch).num_layers == (
            args.layers or chip_smoke.serve_config(args.arch).num_layers)
        seen.add(args.arch)
    assert seen == {*chip_smoke.DEPTH, "recurrentgemma-9b"}
    assert chip_smoke.serve_config("recurrentgemma-9b").num_layers == 38


def test_port_never_loads_jax():
    """Importing every module of the port, and chip_smoke, loads no JAX
    and nothing of the JAX package."""
    mods = sorted(str(p.relative_to(ROOT / "src")).replace("/", ".")[:-3]
                  for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_run_on_cuda_unless_cpu_is_asked():
    """No device given means CUDA: without a GPU the entry points raise
    instead of falling back to the CPU."""
    cfg = get_reduced_config("olmo-1b")
    model = build_model(cfg)
    if torch.cuda.is_available():
        assert model.init(seed=0)["embed"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_paged_cache(2, 5, 4, 2)
    params = model.init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousScheduler(cfg, params)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "olmo-1b", "--reduced", "--continuous"])
