"""The port's kernel registry (``repro_torch.kernels.registry``) against
the JAX package's: every backend-neutral case of ``tests/test_registry.py``
(backends and scoped selection, the per-call override, the reference ops,
the plan cache, ``record_plan``, ``autotune``, plan files, a custom
backend) and the plans half of ``tests/test_persistence.py`` (corrupt,
missing and foreign files cold-start with a warning and 0 plans).

Beyond JAX: a backend that does not run on the tensors' device raises
(no call moves to another device or to a plain version on the card);
the autotune candidates are plans the kernels take, covering each output
and K code once, and ``dense_matmul``'s K split is never among them;
plan files of either package load in the other; ``serve --plans`` saves
the registry's plans and loads them back, and ``--backend`` refuses a
device it does not run on.
"""
import inspect
import json
import warnings

import numpy as np
import pytest
import torch

from repro.kernels.registry import KernelRegistry as JaxRegistry
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import dense_matmul as dense
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import ops
from repro_torch.kernels.registry import (
    KernelBackend,
    KernelRegistry,
    get_registry,
    heuristic,
    use_backend,
)

RNG = np.random.default_rng(7)
CPU = torch.device("cpu")
SHAPES = {"fused_matmul": (4, 2048, 8192), "bitplane_matmul": (1280, 2048, 6144),
          "dense_matmul": (4, 8960, 2560)}


def test_default_backends_registered():
    reg = KernelRegistry()
    assert set(reg.names()) >= {"cuda", "reference"}
    assert not reg.get("cuda").is_reference
    assert reg.get("reference").is_reference


def test_default_active_backend_is_platform_dependent():
    reg = KernelRegistry()
    assert reg.default_name() == ("cuda" if torch.cuda.is_available() else "reference")
    assert reg.active.name == reg.default_name()
    # With nothing chosen, dispatch follows the device.
    assert reg.resolve(None, CPU).name == "reference"
    assert reg.resolve(None, torch.device("cuda")).name == "cuda"


def test_unknown_backend_raises_with_listing():
    reg = KernelRegistry()
    with pytest.raises(KeyError, match="reference"):
        reg.get("mosaic")


def test_use_backend_is_scoped():
    reg = get_registry()
    before = reg.active.name
    with reg.use("reference") as be:
        assert be.is_reference
        assert reg.active.name == "reference"
    assert reg.active.name == before
    with use_backend("cuda"):
        assert reg.active.name == "cuda"
    assert reg.active.name == before


def test_per_call_backend_override():
    x = RNG.integers(-8, 8, (5, 40)).astype(np.int32)
    w = RNG.integers(-8, 8, (40, 7)).astype(np.int32)
    xt, wt = torch.from_numpy(x).to(torch.int8), torch.from_numpy(w).to(torch.int8)
    got_d = ops.bitplane_matmul(xt, wt, a_bits=4)
    got_r = ops.bitplane_matmul(xt, wt, a_bits=4, backend="reference")
    np.testing.assert_array_equal(got_d.numpy(), x @ w)
    np.testing.assert_array_equal(got_r.numpy(), x @ w)
    # The per-call choice wins over the scoped one.
    with get_registry().use("cuda"):
        got_o = ops.bitplane_matmul(xt, wt, a_bits=4, backend="reference")
    np.testing.assert_array_equal(got_o.numpy(), x @ w)


def test_reference_backend_end_to_end_ops():
    """Every op dispatches on the reference backend without a kernel."""
    with use_backend("reference"):
        x = torch.from_numpy(RNG.standard_normal((4, 32)).astype(np.float32))
        q, s = ops.quantize_rows(x, bits=4)
        assert q.shape == (4, 32) and s.shape == (4, 1)
        w = torch.from_numpy(RNG.integers(-8, 8, (32, 6)).astype(np.int32))
        acc = ops.bitplane_matmul(q, w.to(torch.int8), a_bits=4)
        np.testing.assert_array_equal(acc.numpy(), q.numpy().astype(np.int64) @ w.numpy())
        y = ops.dense_matmul(x, torch.eye(32)[:, :8])
        assert torch.equal(y, x[:, :8])


def test_every_op_takes_backend():
    public = [f for name, f in vars(ops).items()
              if inspect.isfunction(f) and f.__module__ == ops.__name__
              and not name.startswith("_") and name not in ("launch_counts",
                                                              "reset_launch_counts")]
    assert len(public) == 17       # rglru_scan, rglru_step and expert_matmul included
    for f in public:
        p = inspect.signature(f).parameters.get("backend")
        assert p is not None and p.default is None, f.__name__


@pytest.mark.parametrize("how", ["scoped", "per-call"])
def test_device_mismatch_raises(how):
    """A CPU tensor under ``cuda`` raises, naming both; so does a CUDA
    device under ``reference`` — nothing falls back or moves."""
    x = torch.randn(4, 64)
    w = torch.randn(64, 8)
    with pytest.raises(ValueError, match="'cuda'.*cpu"):
        if how == "scoped":
            with use_backend("cuda"):
                ops.dense_matmul(x, w)
        else:
            ops.dense_matmul(x, w, backend="cuda")
    with pytest.raises(ValueError, match="'reference'.*cuda"):
        get_registry().resolve("reference", torch.device("cuda"), "dense_matmul")
    with pytest.raises(ValueError, match="meta"):
        get_registry().resolve(None, torch.device("meta"), "dense_matmul")


# -- block plans ------------------------------------------------------------


@pytest.mark.parametrize("op", sorted(SHAPES))
def test_plan_is_the_kernels_heuristic(op):
    M, K, N = SHAPES[op]
    want = {"fused_matmul": fm.plan(M, K, N).blocks,
            "bitplane_matmul": bpm.plan(M, K, N).blocks,
            "dense_matmul": (dense.tiles(M, K, N),)}[op]
    assert KernelRegistry().plan(op, (M, K, N), "cuda") == want == heuristic(op, (M, K, N))


def test_plan_cache_memoizes():
    reg = KernelRegistry()
    p1 = reg.plan("fused_matmul", (64, 64, 64), "cuda")
    before = reg.cache_info()
    p2 = reg.plan("fused_matmul", (64, 64, 64), "cuda")
    after = reg.cache_info()
    assert p1 == p2
    assert after["hits"] == before["hits"] + 1 and after["misses"] == before["misses"]
    # Keyed per backend: another backend plans (and misses) on its own.
    reg.register(KernelBackend("cuda-b"))
    reg.plan("fused_matmul", (64, 64, 64), "cuda-b")
    assert reg.cache_info()["misses"] == after["misses"] + 1


def test_record_plan_overrides_heuristic():
    reg = KernelRegistry()
    shape = (1280, 2048, 8192)
    assert reg.plan("fused_matmul", shape, "cuda") != (32, 128, 256)
    reg.record_plan("fused_matmul", shape, (32, 128, 256), "cuda")
    assert reg.plan("fused_matmul", shape, "cuda") == (32, 128, 256)
    with pytest.raises(ValueError, match="no kernel"):
        reg.record_plan("fused_matmul", shape, (32, 256, 256), "cuda")


def test_wrappers_take_the_registry_plan(monkeypatch):
    """The three kernel wrappers plan through the registry, or take an
    explicit ``plan=`` without asking it."""
    seen = []
    reg = get_registry()
    real = reg.plan

    def spy(op, shape, backend=None):
        seen.append((op, tuple(shape)))
        return real(op, shape, backend)

    monkeypatch.setattr(reg, "plan", spy)
    assert fm._plan(4, 2048, 8192, None, "cuda") == fm.plan(4, 2048, 8192)
    assert bpm._plan(4, 2048, 6144, None, "cuda") == bpm.plan(4, 2048, 6144)
    assert bpm._plan(4, 2048, 6144, (64, 128, 256), "cuda").grid == (48, 8, 1)
    assert fm._plan(4, 2048, 8192, (64, 256, 2048), "cuda").grid == (32, 1, 1)
    assert seen == [("fused_matmul", (4, 2048, 8192)), ("bitplane_matmul", (4, 2048, 6144))]
    src = inspect.getsource(dense.launch)
    assert 'get_registry().plan("dense_matmul", (M, K, N), backend)' in src
    assert "tiles(" not in src
    for mod in (fm, bpm):
        for entry in (mod.launch, mod.launch_dequant):
            assert "_plan(m, k, n, plan, backend)" in inspect.getsource(entry)


def test_autotune_caches_winner_and_skips_failures():
    reg = KernelRegistry()
    calls = []

    def run(blocks):
        if blocks[2] > 256:
            raise RuntimeError("candidate does not fit")
        calls.append(blocks)

    shape = (64, 1024, 512)
    win = reg.autotune("fused_matmul", shape, run,
                       candidates=[(64, 128, 512), (64, 128, 256), (32, 128, 128)],
                       backend="cuda")
    assert win[2] <= 256
    n_calls = len(calls)
    assert n_calls == 3 * 3    # heuristic + 2 that fit: one untimed, two timed runs each
    again = reg.autotune("fused_matmul", shape, run, backend="cuda")
    assert again == win
    assert len(calls) == n_calls       # cached — no re-measurement
    assert reg.plan("fused_matmul", shape, "cuda") == win


def test_autotune_includes_the_heuristic_and_skips_foreign_blocks():
    reg = KernelRegistry()
    seen = []
    shape = (4, 2048, 8192)
    reg.autotune("fused_matmul", shape, seen.append, candidates=[(32, 256, 128)],
                 backend="cuda")
    # (32, 256) is no tile of the kernel: skipped; the heuristic ran.
    assert set(seen) == {heuristic("fused_matmul", shape)}


@pytest.mark.parametrize("op,shape", [
    ("fused_matmul", (4, 6144, 24576)), ("fused_matmul", (32, 24576, 6144)),
    ("fused_matmul", (37, 200, 100)), ("bitplane_matmul", (4, 13824, 5120)),
    ("bitplane_matmul", (1280, 2048, 6144)), ("bitplane_matmul", (37, 200, 100))])
def test_autotune_candidates_cover_each_element_once(op, shape):
    """The default candidates are plans the kernel takes whose grid covers
    every output element and every K code exactly once: with exact int32
    sums, none can change a bit (held on the card by chip_smoke)."""
    M, K, N = shape
    mod = fm if op == "fused_matmul" else bpm
    cands = mod.candidates(M, K, N)
    assert len(set(cands)) == len(cands) > 3
    for c in cands + [heuristic(op, shape)]:
        p = mod.plan_from(M, K, N, c)
        bm, bn = p.bm, (p.bn if op == "fused_matmul" else bpm.BN)
        assert p.grid[0] * bn >= N > (p.grid[0] - 1) * bn
        assert p.grid[2] * bm >= M > (p.grid[2] - 1) * bm
        assert p.kb * p.grid[1] >= K > p.kb * (p.grid[1] - 1)


@pytest.mark.parametrize("shape", [(4, 8960, 2560), (4, 2560, 8960), (1280, 2560, 8960),
                                   (4, 24576, 6144)])
def test_dense_k_split_never_among_candidates(shape):
    """Autotune offers ``dense_matmul`` tilings only: every candidate is a
    (bm,) the kernel takes, and the launch's K split stays plan(K, N)."""
    M, K, N = shape
    reg = KernelRegistry()
    seen = []
    reg.autotune("dense_matmul", shape, seen.append, backend="cuda")
    assert seen and all(len(c) == 1 and c[0] in (16, 64, 128) for c in seen)
    assert (16,) in [tuple(c) for c in seen] or dense.plan(K, N) == 1
    S, sk, _ = dense.launch_plan(M, K, N)
    assert (S, sk) == (dense.plan(K, N), dense.slice_k(K, N))
    with pytest.raises(ValueError, match="no tiling"):
        reg.record_plan("dense_matmul", shape, (64, S + 1), "cuda")
    if dense.plan(K, N) == 1:
        with pytest.raises(ValueError, match="no tiling"):
            reg.record_plan("dense_matmul", shape, (16,), "cuda")


def test_save_and_load_plans_roundtrip(tmp_path):
    reg = KernelRegistry()
    reg.record_plan("bitplane_matmul", (64, 64, 64), (32, 128, 128), "cuda")
    reg.record_plan("dense_matmul", (4, 8960, 2560), (64,), "cuda")
    reg.plan("fused_matmul", (1280, 2048, 8192), "cuda")   # a heuristic entry persists too
    path = tmp_path / "plans.json"
    assert reg.save_plans(path) == 3
    obj = json.loads(path.read_text())
    assert obj["version"] == 1 and {e["backend"] for e in obj["plans"]} == {"cuda"}
    assert set(obj["plans"][0]) == {"op", "backend", "shape", "blocks"}

    fresh = KernelRegistry()
    assert fresh.load_plans(path) == 3
    assert fresh.plan("bitplane_matmul", (64, 64, 64), "cuda") == (32, 128, 128)
    assert fresh.plan("dense_matmul", (4, 8960, 2560), "cuda") == (64,)
    assert (fresh.plan("fused_matmul", (1280, 2048, 8192), "cuda")
            == reg.plan("fused_matmul", (1280, 2048, 8192), "cuda"))
    info = fresh.cache_info()        # loaded plans are hits: no re-planning
    assert info["plans"] == 3 and info["misses"] == 0 and info["hits"] == 3


def test_load_plans_rejects_unknown_version(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"version": 99, "plans": []}')
    reg = KernelRegistry()
    with pytest.warns(UserWarning, match="version"):
        assert reg.load_plans(path) == 0
    assert reg.cache_info()["plans"] == 0


def test_custom_backend_registration(tmp_path):
    reg = KernelRegistry()
    reg.register(KernelBackend("cuda-tuned"))
    assert "cuda-tuned" in reg.names()
    with pytest.raises(ValueError):
        reg.register(KernelBackend("cuda-tuned"))
    # Its plans are its own, and a plan file carries them.
    reg.record_plan("fused_matmul", (4, 2048, 8192), (64, 256, 1024), "cuda-tuned")
    assert reg.plan("fused_matmul", (4, 2048, 8192), "cuda") != (64, 256, 1024)
    reg.save_plans(tmp_path / "p.json")
    other = KernelRegistry()
    other.register(KernelBackend("cuda-tuned"))
    assert other.load_plans(tmp_path / "p.json") == 2
    assert other.plan("fused_matmul", (4, 2048, 8192), "cuda-tuned") == (64, 256, 1024)
    # A registry without that backend skips its entries.
    assert KernelRegistry().load_plans(tmp_path / "p.json") == 1


# -- the plan file, as tests/test_persistence.py holds JAX's -----------------


def _good_plans(tmp_path):
    reg = KernelRegistry()
    reg.record_plan("bitplane_matmul", (64, 64, 64), (32, 128, 128), "cuda")
    path = tmp_path / "plans.json"
    reg.save_plans(path)
    return path


@pytest.mark.parametrize("mutate", [
    pytest.param(lambda txt: txt[: len(txt) // 2], id="truncated"),
    pytest.param(lambda txt: "not json {{{", id="garbage"),
    pytest.param(
        lambda txt: json.dumps({**json.loads(txt), "version": 99}),
        id="wrong-version"),
    pytest.param(lambda txt: json.dumps({"version": 1, "plans": [
        {"op": "bitplane_matmul"}]}), id="missing-fields"),
    pytest.param(lambda txt: json.dumps([1, 2, 3]), id="not-a-dict"),
])
def test_load_plans_corrupt_cold_starts(tmp_path, mutate):
    path = _good_plans(tmp_path)
    path.write_text(mutate(path.read_text()))
    reg = KernelRegistry()
    with pytest.warns(UserWarning):
        assert reg.load_plans(path) == 0
    assert reg.cache_info()["plans"] == 0
    # The registry still plans heuristically — cold start, not dead.
    assert reg.plan("bitplane_matmul", (64, 64, 64), "cuda")


def test_load_plans_missing_file_cold_starts(tmp_path):
    reg = KernelRegistry()
    with pytest.warns(UserWarning, match="cold start"):
        assert reg.load_plans(tmp_path / "nope.json") == 0


def test_load_plans_corrupt_entry_loads_nothing(tmp_path):
    """A file that parses but has one corrupt entry loads ZERO plans —
    no partially-applied cache — whichever backend the entry names."""
    path = _good_plans(tmp_path)
    obj = json.loads(path.read_text())
    obj["plans"].append({"op": "x", "backend": "y", "shape": "bad", "blocks": [1]})
    path.write_text(json.dumps(obj))
    reg = KernelRegistry()
    with pytest.warns(UserWarning, match="corrupt"):
        assert reg.load_plans(path) == 0
    assert reg.cache_info()["plans"] == 0


@pytest.mark.parametrize("entry", [
    pytest.param({"op": "flash_attention", "shape": [4, 64, 64], "blocks": [1, 1, 1]},
                 id="unknown-op"),
    pytest.param({"op": "fused_matmul", "shape": [4, 2048, 8192], "blocks": [128, 128, 256]},
                 id="tile-it-lacks"),
    pytest.param({"op": "bitplane_matmul", "shape": [4, 2048, 8192], "blocks": [32, 128, 192]},
                 id="partial-k-tile"),
    pytest.param({"op": "fused_matmul", "shape": [4, 2048, 8192], "blocks": [32, 128, 0]},
                 id="empty-k-slice"),
    pytest.param({"op": "dense_matmul", "shape": [4, 8960, 2560], "blocks": [16, 8]},
                 id="dense-k-split"),
    pytest.param({"op": "fused_matmul", "shape": [4, 0, 8192], "blocks": [32, 128, 64]},
                 id="empty-shape"),
])
def test_load_plans_entry_the_kernel_cannot_take(tmp_path, entry):
    path = _good_plans(tmp_path)
    obj = json.loads(path.read_text())
    obj["plans"].append({**entry, "backend": "cuda"})
    path.write_text(json.dumps(obj))
    reg = KernelRegistry()
    with pytest.warns(UserWarning, match="corrupt"):
        assert reg.load_plans(path) == 0
    assert reg.cache_info()["plans"] == 0


# -- interchange with the JAX package -----------------------------------------


def test_jax_plan_file_loads_in_the_port(tmp_path):
    """A JAX ``save_plans`` file (interpret, mosaic and reference entries)
    loads without a warning; the port consults only its own backends'
    entries, so it loads none of them and keeps its own plans."""
    jreg = JaxRegistry()
    jreg.record_plan("bitplane_matmul", 64, 64, 64, (8, 8, 8), "interpret")
    jreg.matmul_plan(128, 256, 512, "mosaic")
    jreg.fused_matmul_plan(4, 8192, 2048, "reference")
    jreg.paged_attention_plan(8, 16, 128, "interpret")
    path = tmp_path / "jax_plans.json"
    assert jreg.save_plans(path) == 4
    reg = KernelRegistry()
    reg.record_plan("fused_matmul", (4, 2048, 8192), (32, 128, 512), "cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert reg.load_plans(path) == 0
    assert reg.cache_info()["plans"] == 1
    assert reg.plan("fused_matmul", (4, 2048, 8192), "cuda") == (32, 128, 512)
    # Mixed with the port's entries, only those load.
    obj = json.loads(path.read_text())
    obj["plans"].append({"op": "fused_matmul", "backend": "cuda", "shape": [4, 6144, 24576],
                         "blocks": [32, 128, 1024]})
    path.write_text(json.dumps(obj))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert KernelRegistry().load_plans(path) == 1


def test_port_plan_file_loads_in_jax(tmp_path):
    """The port's file loads in JAX without a warning (JAX keeps the cuda
    entries and never consults them: it has no such backend)."""
    reg = KernelRegistry()
    for op, shape in SHAPES.items():
        reg.plan(op, shape, "cuda")
    path = tmp_path / "torch_plans.json"
    assert reg.save_plans(path) == 3
    jreg = JaxRegistry()
    before = jreg.matmul_plan(1280, 6144, 2048, "interpret")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert jreg.load_plans(path) == 3
    assert jreg.matmul_plan(1280, 6144, 2048, "interpret") == before
    assert "cuda" not in jreg.names()


# -- the serve CLI ------------------------------------------------------------


SERVE = ["--arch", "olmo-1b", "--reduced", "--continuous", "--device", "cpu",
         "--policy", "w4a8;wo=w8a8", "--requests", "3", "--max-new", "4",
         "--max-batch", "2", "--block-size", "4", "--prefill-budget", "4"]


@pytest.fixture
def clean_registry():
    reg = get_registry()
    reg.clear_plans()
    yield reg
    reg.clear_plans()


def test_serve_plans_saves_then_loads(tmp_path, capsys, clean_registry):
    """``serve --plans FILE`` (on the CPU the reference backend plans
    nothing, so the file starts with one cuda plan): the first run loads
    it and saves what the registry holds, the second loads exactly that;
    the tokens are those of the run without --plans."""
    from repro_torch.launch import serve

    path = tmp_path / "plans.json"
    seed = KernelRegistry()
    seed.record_plan("fused_matmul", (4, 64, 192), (32, 128, 64), "cuda")
    seed.save_plans(path)
    runs = []
    for argv in (SERVE, SERVE + ["--plans", str(path)], SERVE + ["--plans", str(path)],
                 SERVE + ["--backend", "reference"]):
        clean_registry.clear_plans()
        _, done, _ = serve.run(serve.build_parser().parse_args(argv))
        runs.append({r.rid: r.out_tokens for r in done})
    out = capsys.readouterr().out
    assert out.count("loaded 1 block plans from") == 2
    assert out.count("saved 1 block plans to") == 2
    assert runs[1] == runs[2] == runs[3] == runs[0]
    assert json.loads(path.read_text())["plans"][0]["blocks"] == [32, 128, 64]


@pytest.mark.parametrize("backend,device", [("reference", None), ("reference", "cuda"),
                                            ("cuda", "cpu")])
def test_serve_backend_refuses_another_device(backend, device):
    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--reduced", "--backend", backend]
    argv += ["--device", device] if device else []
    with pytest.raises(SystemExit, match=f"--backend {backend} runs on"):
        serve.main(argv)
