"""Atomic checkpoint manager: port of ``repro.checkpoint.manager``, with
its on-disk format, so a checkpoint written by either package restores
in the other.

  * saves are atomic (write to ``<step>.tmp/``, fsync the ``COMMITTED``
    marker, rename to ``<step>/``), so a preemption mid-save never
    corrupts the latest checkpoint;
  * keep-K retention with the newest always preserved;
  * restore picks the newest *complete* checkpoint (the marker written
    last);
  * leaves are host numpy arrays in ``arrays.npz`` keyed ``leaf_<i>`` in
    JAX's leaf order, and ``manifest.json`` names each by its tree path
    (``params/blocks/wq``, ``opt/mu/embed``, ``opt/step``); bfloat16 is
    widened to float32 on disk and cast back to the template's dtype on
    restore; ``data_state.json`` holds the data iterator's state;
  * optional async mode: the device → host copy runs at once, the disk
    write on a background thread.

Restore takes a template whose leaves give only shapes and dtypes: an
init on the ``meta`` device draws nothing (JAX's ``eval_shape``), so a
full-width restore holds one copy of the state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tr

_COMMIT = "COMMITTED"


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` (never a view: the optimizer updates its
    tensors in place while an async write runs), bf16 widened to f32."""
    t = t.detach()
    dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.to(device="cpu", dtype=dt, copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def _committed(self):
        return [int(p.name) for p in self.dir.iterdir()
                if p.is_dir() and p.name.isdigit() and (p / _COMMIT).exists()]

    def latest_step(self) -> Optional[int]:
        steps = self._committed()
        return max(steps) if steps else None

    def save(self, step: int, state: Any, data_state: Optional[dict] = None) -> None:
        # Device → host at once, so the caller may update the state in
        # place (the optimizer does) while an async write runs.
        host = [(tr.path_str(p), _to_host(leaf)) for p, leaf in tr.flatten_with_path(state)]

        def write():
            tmp = self.dir / f"{step}.tmp"
            final = self.dir / str(step)
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": []}
            arrays = {}
            for i, (path, arr) in enumerate(host):
                key = f"leaf_{i}"
                arrays[key] = arr
                manifest["leaves"].append({"key": key, "path": path, "dtype": str(arr.dtype),
                                           "shape": list(arr.shape)})
            np.savez(tmp / "arrays.npz", **arrays)
            if data_state is not None:
                (tmp / "data_state.json").write_text(json.dumps(data_state))
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            with open(tmp / _COMMIT, "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in sorted(self._committed())[: -self.keep]:
            shutil.rmtree(self.dir / str(s), ignore_errors=True)

    def restore(self, init_fn: Callable[[], Any], device=None,
                step: Optional[int] = None) -> Tuple[Any, Optional[dict], int]:
        """(state, data_state, step). The template from `init_fn` (leaves
        on any device, ``meta`` included) gives the tree, shapes and
        dtypes; leaves are loaded by tree path, so a restore survives a
        reordered tree, and placed on `device` (CUDA unless named)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        dev = resolve_device(device)
        d = self.dir / str(step)
        manifest = json.loads((d / "manifest.json").read_text())
        template = init_fn()
        out = []
        with np.load(d / "arrays.npz") as arrays:
            by_path = {leaf["path"]: leaf["key"] for leaf in manifest["leaves"]}
            for p, tmpl in tr.flatten_with_path(template):
                key = tr.path_str(p)
                if key not in by_path:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = arrays[by_path[key]]
                if tuple(arr.shape) != tuple(tmpl.shape):
                    raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                                     f"{tuple(tmpl.shape)}")
                out.append(torch.from_numpy(np.asarray(arr, order="C")).to(
                    device=dev, dtype=tmpl.dtype))
        state = tr.unflatten_like(template, out)
        data_state = None
        ds = d / "data_state.json"
        if ds.exists():
            data_state = json.loads(ds.read_text())
        return state, data_state, step
