"""Kernel backends and per-shape block plans.

Port of ``repro.kernels.registry``. Two backends ship by default:

  cuda      : the hand-written kernels (``csrc/``). The default where
              ``torch.cuda.is_available()``.
  reference : the plain PyTorch versions in :mod:`repro_torch.kernels.ref`,
              what CPU tensors run. The default elsewhere.

Dispatch follows the tensors' device. With no backend chosen, a CUDA
tensor runs ``cuda`` and a CPU tensor ``reference``. A chosen backend
(``set_active``, the scoped ``use(name)`` / :func:`use_backend`, or the
per-call ``backend=`` of every op in :mod:`repro_torch.kernels.ops`)
must match the device: a CUDA tensor under ``reference`` or a CPU tensor
under ``cuda`` raises ValueError. The registry never moves a call to
another device, nor to a plain version on the card (JAX's reference
backend doubles as a fallback; here that would be one).

Block plans. The three tiled matmuls take their grid from a plan the
registry memoizes per (op, backend, shape), shape = (M, K, N):
``fused_matmul`` and ``bitplane_matmul`` blocks (bm, bn, kb), a tile and
a K-slice length, and ``dense_matmul`` its tiling (bm,). :meth:`plan`
serves each kernel module's heuristic (``fused_matmul.plan``,
``bitplane_matmul.plan``, ``dense_matmul.tiles``); :meth:`autotune` times
the candidates once and pins the fastest; :meth:`record_plan` pins a
plan; :meth:`save_plans` / :meth:`load_plans` persist them in the JAX
package's JSON schema (``serve --plans FILE``). Every plan the registry
offers or accepts changes no bit of any output: the integer kernels' sums
are exact in any tiling and K split, and every ``dense_matmul`` tiling
runs the same chains. ``dense_matmul``'s K split S sets each row's
summation order, so it is never part of a plan: it stays
``dense_matmul.plan(K, N)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

Blocks = Tuple[int, ...]
Shape = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """One way of executing the kernel suite: ``name`` is the registry key;
    ``is_reference`` routes to the plain versions on the CPU, otherwise
    the CUDA kernels run on the card."""

    name: str
    is_reference: bool = False


_DEFAULT_BACKENDS = (KernelBackend("cuda"), KernelBackend("reference", is_reference=True))


def _kernel(op: str):
    """The kernel module that plans `op`; KeyError for an op without plans."""
    from repro_torch.kernels import bitplane_matmul, dense_matmul, fused_matmul

    mods = {"fused_matmul": fused_matmul, "bitplane_matmul": bitplane_matmul,
            "dense_matmul": dense_matmul}
    if op not in mods:
        raise KeyError(f"no block planner for op {op!r}; planned ops: {sorted(mods)}")
    return mods[op]


def heuristic(op: str, shape: Shape) -> Blocks:
    """The kernel's own plan for `shape` = (M, K, N)."""
    mod = _kernel(op)
    if op == "dense_matmul":
        return (mod.tiles(*shape),)
    return mod.plan(*shape).blocks


def check_plan(op: str, shape: Shape, blocks: Blocks) -> None:
    """Raise ValueError (KeyError for an unknown op) unless the kernel of
    `op` takes `blocks` at `shape` = (M, K, N)."""
    mod = _kernel(op)
    if len(shape) != 3 or min(shape) <= 0:
        raise ValueError(f"{op}: shape {tuple(shape)} is not a positive (M, K, N)")
    if op == "dense_matmul":
        mod.check_blocks(*shape, tuple(blocks))
    else:
        mod.plan_from(*shape, tuple(blocks))


class KernelRegistry:
    """Backend selection and the memoized per-shape block-plan cache (see
    the module docstring)."""

    def __init__(self, backends: Iterable[KernelBackend] = _DEFAULT_BACKENDS):
        self._backends: Dict[str, KernelBackend] = {}
        for b in backends:
            self.register(b)
        self._active: Optional[str] = None
        self._plans: Dict[Tuple[str, str, Shape], Blocks] = {}
        self._plan_hits = 0
        self._plan_misses = 0

    # -- backends ----------------------------------------------------------

    def register(self, backend: KernelBackend, overwrite: bool = False) -> None:
        if backend.name in self._backends and not overwrite:
            raise ValueError(f"backend {backend.name!r} already registered")
        self._backends[backend.name] = backend

    def get(self, name: str) -> KernelBackend:
        try:
            return self._backends[name]
        except KeyError:
            raise KeyError(f"unknown kernel backend {name!r}; registered: "
                           f"{self.names()}") from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._backends)

    def default_name(self) -> str:
        """``cuda`` where a card is visible, ``reference`` elsewhere."""
        return "cuda" if torch.cuda.is_available() else "reference"

    @property
    def active(self) -> KernelBackend:
        return self.get(self._active or self.default_name())

    def set_active(self, name: str) -> None:
        self.get(name)  # validate
        self._active = name

    @contextlib.contextmanager
    def use(self, name: str):
        """Scoped backend selection (restores the previous choice on exit)."""
        prev = self._active
        self.set_active(name)
        try:
            yield self.get(name)
        finally:
            self._active = prev

    def resolve(self, backend: Union[None, str, KernelBackend] = None,
                device: Optional[torch.device] = None, op: str = "kernel") -> KernelBackend:
        """The backend a call of `op` on `device` runs: `backend`, else the
        active choice, else the device's own (``reference`` on the CPU,
        ``cuda`` on a CUDA device). A chosen backend that does not run on
        `device` raises ValueError naming both."""
        choice = backend if backend is not None else self._active
        if choice is None:
            if device is None:
                return self.active
            if device.type not in ("cpu", "cuda"):
                raise ValueError(f"{op}: no kernel for device {device}")
            return self.get("reference" if device.type == "cpu" else "cuda")
        be = choice if isinstance(choice, KernelBackend) else self.get(choice)
        if device is not None and (device.type == "cpu") != be.is_reference:
            runs = "the plain versions on the CPU" if be.is_reference else "CUDA kernels"
            raise ValueError(f"{op}: backend {be.name!r} runs {runs}; the tensors are on "
                             f"{device} (choose the backend of their device, or move them)")
        return be

    # -- block plans -------------------------------------------------------

    def plan(self, op: str, shape: Shape,
             backend: Union[None, str, KernelBackend] = None) -> Blocks:
        """Memoized blocks for `op` at `shape` = (M, K, N) on `backend`."""
        key = (op, self.resolve(backend).name, tuple(shape))
        hit = self._plans.get(key)
        if hit is not None:
            self._plan_hits += 1
            return hit
        self._plan_misses += 1
        blocks = heuristic(op, key[2])
        self._plans[key] = blocks
        return blocks

    def record_plan(self, op: str, shape: Shape, blocks: Blocks, backend=None) -> None:
        """Pin `blocks` for `op` at `shape` (autotune winners land here);
        ValueError if the kernel cannot take them."""
        shape, blocks = tuple(shape), tuple(int(b) for b in blocks)
        check_plan(op, shape, blocks)
        self._plans[(op, self.resolve(backend).name, shape)] = blocks

    def autotune(self, op: str, shape: Shape, run: Callable[[Blocks], None],
                 candidates: Optional[Sequence[Blocks]] = None, backend=None,
                 repeat: int = 2) -> Blocks:
        """Time candidate blocks and memoize the fastest.

        `run(blocks)` runs the kernel once with that plan. Each candidate
        is run once untimed, then timed `repeat` times (CUDA events where
        a card is visible; the host clock elsewhere) and scored by its
        least time. The heuristic plan is always a candidate; the default
        candidates are the kernel module's ``candidates`` (knobs that
        change no bit). Candidates the kernel cannot take or whose run
        raises are skipped. An already planned shape returns its plan
        without measuring."""
        be = self.resolve(backend)
        shape = tuple(shape)
        key = (op, be.name, shape)
        cached = self._plans.get(key)
        if cached is not None:
            return cached
        heur = heuristic(op, shape)
        cands = [tuple(c) for c in (candidates or _kernel(op).candidates(*shape))]
        if heur not in cands:
            cands.insert(0, heur)
        best: Optional[Tuple[float, Blocks]] = None
        for cand in cands:
            try:
                check_plan(op, shape, cand)
                run(cand)
                t = min(self._time_one(run, cand) for _ in range(max(1, repeat)))
            except Exception:
                continue
            if best is None or t < best[0]:
                best = (t, cand)
        if best is None:
            raise RuntimeError(f"autotune: no candidate ran for {op} at {shape}")
        self._plans[key] = best[1]
        return best[1]

    @staticmethod
    def _time_one(run: Callable[[Blocks], None], cand: Blocks) -> float:
        if torch.cuda.is_available():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run(cand)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) * 1e-3
        t0 = time.perf_counter()
        run(cand)
        return time.perf_counter() - t0

    def cache_info(self) -> dict:
        return {"plans": len(self._plans), "hits": self._plan_hits,
                "misses": self._plan_misses}

    def clear_plans(self) -> None:
        self._plans.clear()
        self._plan_hits = self._plan_misses = 0

    # -- plan persistence --------------------------------------------------

    def save_plans(self, path) -> int:
        """Write the plan cache to `path` in the JAX package's schema
        (``{"version": 1, "plans": [{"op", "backend", "shape", "blocks"}]}``).
        Returns the number of plans written."""
        entries = [{"op": op, "backend": be, "shape": list(shape), "blocks": list(blocks)}
                   for (op, be, shape), blocks in sorted(self._plans.items())]
        Path(path).write_text(json.dumps({"version": 1, "plans": entries}, indent=2) + "\n")
        return len(entries)

    def load_plans(self, path) -> int:
        """Merge the plans of a :meth:`save_plans` file (of either package)
        into the cache, over any heuristic entry. Only entries of this
        registry's kernel backends are loaded: another package's backends
        and the reference backend (which runs no plan) are skipped. Returns
        the number loaded. Never raises on bad input: a missing, truncated
        or corrupt file, an unknown version, or an entry the kernel cannot
        take (an unknown op, a tile it lacks, a K slice that is not whole
        K tiles) warns and loads 0 plans, a cold start (JAX's contract)."""
        try:
            obj = json.loads(Path(path).read_text())
        except (OSError, ValueError) as e:
            warnings.warn(f"plan-cache load from {path!s} failed ({e}) — cold start")
            return 0
        if not isinstance(obj, dict) or obj.get("version") != 1:
            got = obj.get("version") if isinstance(obj, dict) else None
            warnings.warn(f"unsupported plan-cache version in {path!s}: {got!r} — cold start")
            return 0
        loaded = {}
        try:
            for e in obj["plans"]:
                op, be = str(e["op"]), str(e["backend"])
                shape = tuple(int(x) for x in e["shape"])
                blocks = tuple(int(x) for x in e["blocks"])
                if be not in self._backends or self._backends[be].is_reference:
                    continue
                check_plan(op, shape, blocks)
                loaded[(op, be, shape)] = blocks
        except (KeyError, TypeError, ValueError) as e:
            warnings.warn(f"corrupt plan-cache entry in {path!s} ({e}) — cold start")
            return 0
        self._plans.update(loaded)
        return len(loaded)


_REGISTRY = KernelRegistry()


def get_registry() -> KernelRegistry:
    """The process-wide registry every op of ``ops`` dispatches through."""
    return _REGISTRY


def use_backend(name: str):
    """``with use_backend("reference"): ...``"""
    return _REGISTRY.use(name)
