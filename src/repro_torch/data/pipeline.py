"""Deterministic, checkpointable synthetic LM data pipeline: the port's
own copy of ``repro.data.pipeline`` (numpy only, no JAX), whose batches
are bitwise JAX's for every (seed, step, host). Two host-side changes,
neither moving a bit: the unigram draws reuse one cdf (numpy's
``choice`` rebuilds it at every call), and the prefetch worker builds
each batch once.

Production-shaped even though the corpus is synthetic: the stream is
deterministic in (seed, step, host), sharded by host (each host materializes
only its slice of the global batch — the multi-host contract), double-
buffered with a background prefetch thread (the paper's load/compute/store
pipelining at the input layer), and the iterator state (step counter) is
part of the checkpoint so restarts resume mid-epoch exactly.

The token distribution is a Zipfian mixture with a Markov backbone so that
a ~100M-param model actually has something learnable (examples/train_lm.py
shows loss dropping well below the unigram entropy floor).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    """Markov-chain token stream with Zipfian unigram marginals."""

    def __init__(self, vocab: int, seed: int = 0, branch: int = 32):
        self.vocab = vocab
        self.branch = branch
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # Each token transitions to `branch` successors (deterministic table)
        self.succ = rng.integers(0, vocab, size=(min(vocab, 4096), branch))
        # numpy's Generator.choice(vocab, size, p=unigram) draws
        # cdf.searchsorted(random(size), side="right") with this cdf, and
        # consumes nothing else; computed once here instead of at every
        # draw (half a million cumsums a full-vocab batch), the same draws.
        self._cdf = self.unigram.cumsum()
        self._cdf /= self._cdf[-1]

    def _choice(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """``rng.choice(self.vocab, size=size, p=self.unigram)``, bitwise."""
        return self._cdf.searchsorted(rng.random(size), side="right").astype(np.int64)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), dtype=np.int32)
        cur = self._choice(rng, batch)
        for t in range(seq):
            out[:, t] = cur
            explore = rng.random(batch) < 0.1
            nxt = self.succ[cur % self.succ.shape[0],
                            rng.integers(0, self.branch, batch)]
            cur = np.where(explore, self._choice(rng, batch), nxt).astype(np.int64)
        return out


class DataIterator:
    """Deterministic per-host iterator with get_state/set_state.

    Batches are a dict matching the model's input_specs: tokens for LM
    archs; frames+labels for the encoder; patches+tokens for the VLM.
    """

    def __init__(
        self,
        cfg,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        host_id: int = 0,
        host_count: int = 1,
        prefetch: int = 2,
        branch: int = 32,
    ):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{host_count} hosts")
        self.cfg = cfg
        self.local_batch = global_batch // host_count
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.step = 0
        self.source = SyntheticLM(cfg.vocab, seed, branch=branch)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch construction --------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id
        )

    def batch_at(self, step: int) -> dict:
        rng = self._rng_for(step)
        cfg = self.cfg
        if cfg.frontend == "frame_stub":
            frames = rng.standard_normal(
                (self.local_batch, self.seq_len, cfg.frontend_dim), np.float32
            )
            labels = rng.integers(
                0, cfg.vocab, (self.local_batch, self.seq_len), dtype=np.int32
            )
            return {"frames": frames, "labels": labels}
        if cfg.frontend == "patch_stub":
            P = cfg.num_prefix_embeds
            patches = rng.standard_normal(
                (self.local_batch, P, cfg.frontend_dim), np.float32
            )
            tokens = self.source.sample(rng, self.local_batch, self.seq_len - P)
            return {"patches": patches, "tokens": tokens}
        return {"tokens": self.source.sample(rng, self.local_batch, self.seq_len)}

    # -- iterator protocol with prefetch ---------------------------------
    def _worker(self):
        # Each batch is built once, then offered until the queue takes it
        # (the JAX package's worker rebuilt it at every 0.2 s timeout,
        # holding the interpreter lock the training loop dispatches with).
        step = self.step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch), timeout=0.2)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        while True:
            step, batch = self._queue.get()
            if step == self.step:  # drop stale prefetches after set_state
                self.step += 1
                return batch
            if step > self.step:  # worker ahead of a rewind: restart it
                self._restart_worker()

    def _restart_worker(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        while not self._queue.empty():
            self._queue.get_nowait()
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- checkpointable state ---------------------------------------------
    def get_state(self) -> dict:
        return {"step": self.step, "seed": self.seed, "host_id": self.host_id}

    def set_state(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"data seed mismatch on restore: checkpoint "
                             f"{state['seed']}, iterator {self.seed}")
        self.step = int(state["step"])
        if self._thread is not None:
            self._restart_worker()
