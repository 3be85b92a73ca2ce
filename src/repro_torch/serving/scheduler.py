"""Continuous-batching scheduler: request queue, slot table, mid-decode
admission, paged KV allocation with reservation queueing, and chunked
prefill interleaved with decoding.

Port of ``repro.serving.scheduler`` as it stood when chunked prefill
landed (paged pool + Sarathi-style chunked prefill, solo whole-prompt
admission, the contiguous cache), without the prefix cache. Later
features — prefix cache, speculation, precision tiers,
lifecycle/preemption/chaos and the host tier — come with later slices of
the port.

Design:
  * ``max_batch`` decode slots; every step decodes the full (max_batch, 1)
    token batch. Free slots decode a dummy token whose output is ignored.
  * ``paged`` (default for full-attention archs): a KV pool shared by
    every slot. Admission reserves the request's worst-case block count
    ``ceil((len + max_new - 1) / block_size)``; if the pool cannot cover
    it the request waits (FIFO), so a live row can never deadlock
    mid-decode. Blocks are allocated lazily: prompt blocks at admission,
    one more whenever a decode step crosses a boundary. Retirement frees
    a slot's blocks and its unclaimed reservation. ``paged=False``: a
    contiguous cache in which every slot reserves a max_ctx row.
  * ``chunked_prefill`` (default on the paged pool): admission enqueues a
    chunk *plan*; each step runs at most one ``prefill_budget``-token
    chunk (round-robin over plans) through the paged-prefill kernel
    alongside the decode step. Until its last chunk lands, a slot's device
    table row is all -1 (masked out of decoding). Otherwise admission
    prefills the whole prompt solo (right-padded to the bucket) and
    scatters its cache into the slot's pool blocks or contiguous row;
    every free slot may admit in the same step.
  * Sampling draws from per-request ``(seed, rid, step)`` streams, so a
    request's tokens do not depend on what else is in the batch.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import as_policy
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.models import build_model
from repro_torch.models.model_zoo import check_policy
from repro_torch.models.kv_cache import scatter_into_paged, scatter_into_slot
from repro_torch.serving import sampling


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_time`` is seconds after the start
    of ``run()``; ``t_first``/``t_done`` are filled by the scheduler;
    ``error`` is set (and the request returned) when it can never fit."""

    rid: int
    prompt: np.ndarray            # (T,) int
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0                # 0 = no top-k filtering
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    on_token: Optional[Callable[["Request", int], None]] = None
    out_tokens: Optional[List[int]] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    error: Optional[str] = None

    @property
    def failed(self) -> bool:
        return self.error is not None


class ContinuousScheduler:
    """Continuous-batching scheduler over the paged pool (see the module
    docstring). Drive it with ``submit()`` + ``step()``, or hand a whole
    workload to ``run()``."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_ctx: int = 128, quant=None, bucket: int = 64, seed: int = 0,
                 on_token=None, paged: Optional[bool] = None, block_size: int = 16,
                 pool_blocks: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None, prefill_budget: int = 32,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        policy = as_policy(quant)
        check_policy(cfg, policy)
        if policy is not None:
            params = quantize_params_for_serving(params, policy, min_size=1024)
        self.params = params
        self.max_batch = max_batch
        self.max_ctx = max_ctx
        self.bucket = bucket
        self.seed = seed
        self.on_token = on_token
        self.block_size = block_size

        # Paged needs a full-attention KV cache (recurrent states are
        # constant-size); chunked prefill rides on the paged pool and on the
        # model's fused chunk path (`prefill_chunk`).
        can_page = (getattr(self.model, "init_paged_cache", None) is not None
                    and not cfg.attn_window)
        if paged is None:
            paged = can_page
        elif paged and not can_page:
            raise ValueError(f"{cfg.name}: paged KV cache requires a full-attention "
                             "cache (ring buffers and recurrent states are already "
                             "footprint-bounded)")
        self.paged = paged
        can_chunk = paged and getattr(self.model, "prefill_chunk", None) is not None
        if chunked_prefill is None:
            chunked_prefill = can_chunk
        elif chunked_prefill and not can_chunk:
            raise ValueError(f"{cfg.name}: chunked prefill requires the paged KV "
                             "cache and an arch with the fused chunk-prefill path "
                             "(token-input, non-MoE full-attention transformer)")
        self.chunked_prefill = chunked_prefill
        if prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1")
        self.prefill_budget = prefill_budget

        B = max_batch
        # Admission bound: max_ctx in every mode, so static, contiguous and
        # paged agree on which requests fit; a recurrent state is
        # position-unbounded (None).
        self._capacity = max_ctx if cfg.family != "ssm" else None
        if paged:
            self._max_blocks = -(-max_ctx // block_size)
            usable = (pool_blocks if pool_blocks is not None
                      else B * self._max_blocks)
            if usable < 1:
                raise ValueError("pool_blocks must be >= 1")
            self.pool_blocks = usable
            self.cache = self.model.init_paged_cache(
                B, usable + 1, block_size, self._max_blocks, device=self.device)
            self._free: List[int] = list(range(usable, 0, -1))  # block 0 = trash
            self._avail = usable        # free minus outstanding reservations
            self._reserved = np.zeros((B,), np.int64)
            self._block_tab = np.full((B, self._max_blocks), -1, np.int32)
            self._table_dirty = False
            self._peak_blocks = 0
        else:
            # Every slot reserves a full max_ctx (+ headroom) row for life.
            self.cache = self.model.init_cache(B, max_ctx, device=self.device)

        self._chunk_plans: Dict[int, dict] = {}     # slot → in-flight plan
        self._chunk_queue: Deque[int] = collections.deque()
        self.prefill_chunks_run = 0
        self.prefill_chunk_tokens = 0
        self.prefill_chunk_steps = 0
        self.decode_steps_stalled = 0

        self._pos_host = np.zeros((B,), np.int64)    # next write position
        self._cur = np.zeros((B, 1), np.int32)       # next input token/slot
        self._temps = np.zeros((B,), np.float32)
        self._top_ks = np.zeros((B,), np.int32)
        self._keys = np.zeros((B, 2), np.uint32)
        self._steps = np.zeros((B,), np.int32)
        self._slots: List[Optional[Request]] = [None] * B
        self.waiting: Deque[Request] = collections.deque()
        self.steps_run = 0
        self.tokens_emitted = 0
        self._t0: Optional[float] = None

    # -- queue/slot accounting ---------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _now(self) -> Optional[float]:
        return None if self._t0 is None else time.perf_counter() - self._t0

    def _need_tokens(self, req: Request) -> int:
        # The first token comes from the prefill logits and writes no
        # cache slot; only the remaining max_new - 1 decode inputs do.
        return len(req.prompt) + max(req.max_new_tokens, 1) - 1

    def _need_blocks(self, req: Request) -> int:
        return -(-self._need_tokens(req) // self.block_size)

    def _bucketed(self, n: int) -> int:
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def _reject_reason(self, req: Request) -> Optional[str]:
        """Non-None iff the request can never be served here (vs. waiting
        for pool blocks)."""
        if self._capacity is None:
            return None
        need = self._need_tokens(req)
        if self.paged:
            if need > self._capacity or self._need_blocks(req) > self.pool_blocks:
                return (f"request {req.rid}: prompt ({len(req.prompt)}) + "
                        f"max_new_tokens ({req.max_new_tokens}) needs {need} "
                        f"cache slots, beyond capacity ({self._capacity} per "
                        f"slot, {self.pool_blocks * self.block_size} pooled); "
                        "raise max_ctx / pool_blocks")
            return None
        L = self._bucketed(len(req.prompt))
        # The solo prefill cache carries L + headroom slots and must fit the
        # max_ctx + headroom row, hence the L > max_ctx bound.
        if L > self.max_ctx or need > self._capacity:
            return (f"request {req.rid}: bucketed prompt ({L}) or prompt + "
                    f"max_new_tokens ({need} slots) exceeds cache capacity "
                    f"(max_ctx {self.max_ctx}); raise max_ctx")
        return None

    # -- block allocator ---------------------------------------------------

    @property
    def _live_blocks(self) -> int:
        return self.pool_blocks - len(self._free)

    def _take_free_block(self) -> int:
        return self._free.pop()

    def _alloc_block(self, slot: int, j: int) -> None:
        self._block_tab[slot, j] = self._take_free_block()
        self._reserved[slot] -= 1
        self._table_dirty = True
        self._peak_blocks = max(self._peak_blocks, self._live_blocks)

    def _alloc_boundary_blocks(self) -> None:
        """Back the position each live (decoding) slot writes this step."""
        for b, req in enumerate(self._slots):
            if req is None or b in self._chunk_plans:
                continue
            j = int(self._pos_host[b]) // self.block_size
            if j < self._max_blocks and self._block_tab[b, j] < 0:
                self._alloc_block(b, j)

    def _sync_table(self) -> None:
        """Push the host block table to the device; rows with a chunk plan
        in flight stay all -1 (their decode writes go to the trash block
        and their attention sees no keys)."""
        if not self._table_dirty:
            return
        tab = self._block_tab.copy()
        for b in self._chunk_plans:
            tab[b, :] = -1
        self.cache.kv.block_table.copy_(torch.from_numpy(tab))
        self._table_dirty = False

    def _release_slot(self, b: int) -> None:
        """Retire row `b`: free its blocks and its unclaimed reservation
        (a contiguous row is simply overwritten by its next admission)."""
        self._slots[b] = None
        if not self.paged:
            return
        if self._chunk_plans.pop(b, None) is not None:
            self._chunk_queue.remove(b)
        row = self._block_tab[b]
        for blk in row[row >= 0]:
            self._free.append(int(blk))
            self._avail += 1
        row[:] = -1
        self._avail += int(self._reserved[b])
        self._reserved[b] = 0
        self._table_dirty = True

    def pool_stats(self) -> dict:
        """KV-memory utilization and chunked-prefill counters."""
        kv = self.cache.kv
        if not self.paged:
            # The whole contiguous reservation (or recurrent state) is
            # resident for life.
            st = self.cache.rwkv
            planes = ((kv.k, kv.v, kv.k_scale, kv.v_scale) if kv is not None
                      else (st.wkv, st.tm_shift, st.cm_shift))
            total = sum(a.numel() * a.element_size() for a in planes
                        if a is not None)
            return {"paged": False, "resident_kv_bytes": total,
                    "reserved_kv_bytes": total, "chunked_prefill": False}
        per_token = (kv.k.shape[0] * int(np.prod(kv.k.shape[3:]))
                     * 2 * kv.k.element_size())
        if kv.quantized:
            per_token += kv.k.shape[0] * kv.k.shape[3] * 2 * 4
        allocated = self._live_blocks
        return {
            "paged": True,
            "block_size": self.block_size,
            "pool_blocks": self.pool_blocks,
            "free_blocks": len(self._free),
            "allocated_blocks": allocated,
            "peak_allocated_blocks": self._peak_blocks,
            "capacity_tokens": self.pool_blocks * self.block_size,
            "resident_kv_bytes": allocated * self.block_size * per_token,
            "peak_resident_kv_bytes":
                self._peak_blocks * self.block_size * per_token,
            # The contiguous scheduler's reservation for the same settings
            # (max_ctx + 8 decode-headroom slots per slot, as in JAX).
            "reserved_kv_bytes": self.max_batch * (self.max_ctx + 8) * per_token,
            "chunked_prefill": self.chunked_prefill,
            "prefill_budget": self.prefill_budget,
            "prefill_chunks_run": self.prefill_chunks_run,
            "decode_steps_stalled": self.decode_steps_stalled,
            "prefill_tokens_per_step":
                self.prefill_chunk_tokens / max(self.prefill_chunk_steps, 1),
            "prefill_chunk_steps": self.prefill_chunk_steps,
        }

    # -- admission / retirement --------------------------------------------

    def _fail(self, req: Request, reason: str) -> None:
        req.error = reason
        if req.out_tokens is None:
            req.out_tokens = []
        req.t_done = self._now()

    def _reserve(self, req: Request, slot: int) -> None:
        """Reserve the request's worst-case blocks and allocate its prompt
        blocks in row `slot` of the host table."""
        need = self._need_blocks(req)
        self._avail -= need
        self._reserved[slot] = need
        for j in range(-(-len(req.prompt) // self.block_size)):
            self._alloc_block(slot, j)

    def _admit(self, req: Request, slot: int) -> Optional[Request]:
        """Prefill `req`'s whole prompt solo (right-padded to the bucket)
        and scatter its cache into row `slot` — its pool blocks, or its
        contiguous row. Returns the request if it finished on its first
        token."""
        n = len(req.prompt)
        if self.paged:
            self._reserve(req, slot)
        L = self._bucketed(n)
        tokens = np.zeros((1, L), np.int64)
        tokens[0, :n] = req.prompt
        solo, logits = self.model.prefill(self.params, {
            "tokens": torch.from_numpy(tokens).to(self.device),
            "lengths": torch.tensor([n], dtype=torch.int32)})
        if self.paged:
            # The scatter writes this row's device table too; _table_dirty
            # stays set so rows freed earlier sync on the next decode.
            scatter_into_paged(self.cache, solo, slot, self._block_tab[slot])
        else:
            scatter_into_slot(self.cache, solo, slot)
        self._pos_host[slot] = n
        self._slots[slot] = req
        return self._first_token(req, slot, logits)

    def _admit_chunked(self, req: Request, slot: int) -> None:
        """Claim row `slot`: reserve the request's blocks, allocate its
        prompt blocks, and enqueue a chunk plan. The slot stays masked out
        of decoding until its last chunk lands."""
        n = len(req.prompt)
        self._reserve(req, slot)
        self._pos_host[slot] = 0
        self._cur[slot, 0] = 0          # dummy decode input while prefilling
        self._slots[slot] = req
        self._chunk_plans[slot] = {"req": req, "next": 0, "n": n,
                                   "toks": np.asarray(req.prompt)}
        self._chunk_queue.append(slot)
        self._table_dirty = True

    def _run_chunk(self, slot: int) -> Optional[Request]:
        """Run one `prefill_budget`-token chunk of row `slot`'s plan. On
        the final chunk the slot graduates to decoding and samples its
        first token. Returns the request if it finished on that token."""
        plan = self._chunk_plans[slot]
        req, n, start = plan["req"], plan["n"], plan["next"]
        Lc = self.prefill_budget
        t = min(Lc, n - start)
        tokens = np.zeros((1, Lc), np.int64)
        tokens[0, :t] = plan["toks"][start:start + t]
        covering = -(-(start + t) // self.block_size)
        batch = {
            "tokens": torch.from_numpy(tokens).to(self.device),
            "lengths": [t],
            "start": start,
            "slot": slot,
            "blocks": torch.from_numpy(self._block_tab[slot, :covering].copy()),
        }
        self.cache, logits = self.model.prefill_chunk(self.params, self.cache, batch)
        self.prefill_chunks_run += 1
        self.prefill_chunk_tokens += t
        plan["next"] = start + t
        if plan["next"] < n:
            return None
        del self._chunk_plans[slot]
        self._pos_host[slot] = n
        self._table_dirty = True       # unmask the row for the decode step
        return self._first_token(req, slot, logits)

    def _first_token(self, req: Request, slot: int, logits) -> Optional[Request]:
        key = sampling.request_key(self.seed, req.rid)
        tok = int(sampling.sample_tokens(
            logits[:, -1, :], [req.temperature], [req.top_k], key[None], [0])[0])
        self._cur[slot, 0] = tok
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._keys[slot] = key
        self._steps[slot] = 1
        req.out_tokens = [tok]
        if req.t_first is None:
            req.t_first = self._now()
        self._emit(req, tok)
        if self._finished(req, tok):
            self._release_slot(slot)
            return req
        return None

    def _emit(self, req: Request, tok: int) -> None:
        self.tokens_emitted += 1
        for cb in (req.on_token, self.on_token):
            if cb is not None:
                cb(req, tok)

    @staticmethod
    def _finished(req: Request, tok: int) -> bool:
        return (req.failed or len(req.out_tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    # -- the decode loop ----------------------------------------------------

    def step(self) -> List[Request]:
        """One scheduler step: admit waiting requests into free slots (one
        chunk plan per step, or solo whole-prompt prefills into every free
        slot), run one budgeted prefill chunk, then one batched decode
        step, sample, and retire finished slots. Returns the requests that
        finished this step (including rejected ones, which carry
        ``error``)."""
        finished: List[Request] = []
        free = collections.deque(
            b for b in range(self.max_batch) if self._slots[b] is None)
        while free and self.waiting:
            head = self.waiting[0]
            reason = self._reject_reason(head)
            if reason is not None:
                self.waiting.popleft()
                self._fail(head, reason)
                finished.append(head)
                continue
            if self.paged and self._need_blocks(head) > self._avail:
                break                   # the head keeps FIFO priority: wait
            if self.chunked_prefill:
                self._admit_chunked(self.waiting.popleft(), free.popleft())
                # One admission per step: its chunks are spent one per step.
                break
            done = self._admit(self.waiting.popleft(), free[0])
            if done is not None:
                finished.append(done)   # finished on its first token: the
                continue                # slot is free again this step
            free.popleft()

        chunk_ran = False
        if self._chunk_queue:
            slot = self._chunk_queue.popleft()
            chunk_ran = True
            done = self._run_chunk(slot)
            if slot in self._chunk_plans:
                self._chunk_queue.append(slot)   # unfinished: back of line
            elif done is not None:
                finished.append(done)
            self.prefill_chunk_steps += 1

        decoding = [b for b, r in enumerate(self._slots)
                    if r is not None and b not in self._chunk_plans]
        if not decoding:
            return finished
        if chunk_ran:
            self.decode_steps_stalled += 1
        if self.paged:
            self._alloc_boundary_blocks()
            self._sync_table()
        cur = torch.from_numpy(self._cur).to(self.device)
        self.cache, logits = self.model.decode_step(self.params, self.cache, cur)
        toks = sampling.sample_tokens(logits[:, -1, :], self._temps,
                                      self._top_ks, self._keys,
                                      self._steps).cpu().numpy()
        self._steps += 1
        self.steps_run += 1
        for b in decoding:
            req = self._slots[b]
            self._pos_host[b] += 1
            tok = int(toks[b])
            req.out_tokens.append(tok)
            self._emit(req, tok)
            if self._finished(req, tok):
                self._release_slot(b)
                finished.append(req)
            else:
                self._cur[b, 0] = tok
        return finished

    def run(self, requests=()) -> List[Request]:
        """Serve a workload to completion, admitting each request no
        earlier than its ``arrival_time``. Returns the requests in
        completion order with ``t_first``/``t_done`` filled."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        self._t0 = time.perf_counter()
        done: List[Request] = []
        while pending or self.waiting or self.num_active:
            now = time.perf_counter() - self._t0
            while pending and pending[0].arrival_time <= now:
                self.submit(pending.pop(0))
            if not self.waiting and self.num_active == 0:
                time.sleep(min(max(pending[0].arrival_time - now, 0.0), 0.05))
                continue
            for req in self.step():
                req.t_done = time.perf_counter() - self._t0
                done.append(req)
        self._t0 = None
        return done
