"""Continuous-batching scheduler: request queue, slot table, mid-decode
admission, paged KV allocation with reservation queueing, preemption and
the head-of-line bypass under pool pressure, chunked prefill interleaved
with decoding, the cross-request prefix cache, and fault containment.

Port of ``repro.serving.scheduler``'s paged pool, chunked prefill, solo
whole-prompt admission, contiguous cache, prefix cache, self-speculative
decoding, per-request precision tiers, the request lifecycle
(cancellation, deadlines, contained callbacks), preemption with warm
resume, the bounded head-of-line bypass, graceful degradation, seeded
fault injection, the NaN-logits detector, the host-RAM block tier with
the ``block-to-host`` victim policy, and the durable prefix index.

Design:
  * ``max_batch`` decode slots; every step decodes the full (max_batch, 1)
    token batch. Free slots decode a dummy token whose output is ignored.
  * ``paged`` (default for full-attention archs): a KV pool shared by
    every slot. Admission reserves the blocks the request may still
    allocate, so a live row can never deadlock mid-decode. Blocks are
    allocated lazily: prompt blocks at admission, one more whenever a
    decode step crosses a boundary. ``paged=False``: a contiguous cache in
    which every slot reserves a max_ctx row.
  * Pool pressure: when the pool cannot cover the queue head, the step
    (with ``preempt``, the default on the paged pool) preempts at most one
    live victim (``victim_policy``) whose release alone covers the
    shortfall, never for a head that was itself preempted; the victim's
    written blocks are registered in the prefix index and it is requeued
    at the back as prompt ++ generated, so its resume prefills only what
    the pool no longer holds and emits bitwise the uninterrupted stream
    (greedy and sampled: its next token is drawn at step
    ``len(out_tokens)``). Otherwise a later request that fits may admit
    past the blocked head, at most ``max_head_bypass`` times in a row, and
    the head waits. With ``degrade``, after ``degrade_after`` consecutive
    pressure steps admissions are served at the lowest configured tier,
    for the request's whole life (``Request.degraded_to``).
  * ``prefix_cache`` (default on the paged pool): a host index maps
    chain digests of block-sized token chunks to resident pool blocks, so
    a request whose prompt prefix is already resident maps those blocks
    into its table instead of prefilling them again. Blocks are
    refcounted: retirement decrefs, unreferenced cached blocks are kept
    in an LRU (evicted only when the pool needs them), and a row that
    must append into a block it shares copies it first (copy-on-write).
    Admission prefills only the uncached suffix, and a warm request's
    tokens are bitwise a cold request's.
  * ``host_pool_bytes`` > 0 (paged pool and prefix cache): a host-RAM
    tier under the pool. A hashed block the LRU evicts moves to a host
    store (CPU tensors, pinned when the pool is on CUDA) with its
    digests instead of dying, the oldest evicted past the byte budget; a
    prefix match falls back to the host index digest by digest, and
    admission swaps a hit back into a fresh pool block verbatim, so a
    warm-from-host request's tokens are bitwise a cold one's. Under
    ``victim_policy="block-to-host"`` a preemption spills the victim's
    hashed blocks at once, so its resume is warm from host at worst.
    ``save_index``/``load_index`` persist every cached chunk (device and
    host) as JSON in the JAX package's format, and a load fills the
    host tier.
  * ``chunked_prefill`` (default on the paged pool): admission enqueues a
    chunk *plan* starting at the first uncached position; each step runs
    at most one ``prefill_budget``-token chunk (round-robin over plans)
    through the paged-prefill kernel alongside the decode step. Until its
    last chunk lands, a slot's device table row is all -1 (masked out of
    decoding). A prompt that is resident whole runs its last token
    through the same kernel without writing (``store=False``). Otherwise
    admission prefills the whole prompt (or its uncached suffix) solo and
    scatters its cache into the slot's pool blocks or contiguous row;
    every free slot may admit in the same step.
  * ``speculate=k`` (paged pool, packed weights): each step, before the
    batched decode, greedy slots draft up to k tokens with a
    plane-truncated view of the resident weights (``draft_policy``),
    then one full-policy verify call over every row's ``[current token,
    drafts]`` window emits the longest matching prefix; positions roll
    back for the rejected tail. Greedy tokens are bitwise those without
    speculation; sampled slots decode normally.
  * ``tiers`` (paged pool, packed weights): a request may name a "wXaY"
    precision tier and is served through a plane-truncated view of the
    one packed weight set (``truncate_policy_view``; every tensor shared
    by identity). Each step decodes one call per tier group, every other
    row masked out of the pushed block table, so a tier-T request in a
    mixed batch emits what an engine serving only tier T emits. Prefix
    digests are seeded with the tier, so tiers never share blocks; the
    draft must sit strictly below a slot's tier for it to speculate, and
    verify runs at the slot's tier, one call per tier group.
  * Lifecycle: ``cancel(rid)`` and the ``deadline_s``/``deadline_steps``
    of a request take effect at the start of the next ``step()`` (queued
    requests leave the queue, live rows — chunk plans included — retire
    with their blocks, reservation and plan freed); a user ``on_token``
    callback that raises fails only its own request.
  * Faults: every decode call goes through one seam (``_decode_call``);
    a row whose logits hold a non-finite value retires with
    ``error="nan-logits"`` before its token is used, its neighbours
    untouched. A :class:`~repro_torch.serving.chaos.FaultInjector`
    (``chaos=``) fires seeded faults at the ``alloc``, ``kernel``, ``nan``
    and ``callback`` seams; an injected decode fault fires before anything
    is dispatched, and the same call is dispatched again through the same
    kernels (``kernel_fallbacks``).
  * Sampling draws from per-request ``(seed, rid, step)`` streams, so a
    request's tokens do not depend on what else is in the batch.
"""
from __future__ import annotations

import base64
import collections
import dataclasses
import hashlib
import json
import time
import warnings
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import (
    as_policy,
    degrade_order,
    parse_tier_specs,
    parse_tier_token,
    quant_token,
    truncate_policy_view,
)
from repro_torch.core.quant import QuantConfig
from repro_torch.core.quantized_linear import quantize_params_for_serving
from repro_torch.models import build_model
from repro_torch.models.model_zoo import check_policy
from repro_torch.models.kv_cache import (
    KVCache,
    copy_pool_block,
    scatter_into_paged,
    scatter_into_slot,
    scatter_suffix_into_paged,
    set_decode_positions,
    set_paged_row,
    write_pool_block,
)
from repro_torch.serving import sampling
from repro_torch.serving.chaos import FaultInjector, InjectedFault
from repro_torch.serving.speculative import derive_draft_params, greedy_accept

#: Preemption victim-selection policies (JAX's names): `most-blocks` frees
#: the most pool capacity per eviction, `lowest-tier` sheds the cheapest
#: quality class first, `latest-deadline` preempts the request with the
#: most slack (no-deadline requests first, then the latest deadline).
#: `block-to-host` picks like `most-blocks` and spills the victim's hashed
#: blocks to the host-RAM tier (needs ``host_pool_bytes``), so pool churn
#: before its re-admission cannot evict them.
VICTIM_POLICIES = ("most-blocks", "lowest-tier", "latest-deadline",
                   "block-to-host")

#: Schema tag and version of the persisted prefix index (`save_index`),
#: the JAX package's: an index written by either package loads in the
#: other.
INDEX_SCHEMA = "m4bram-prefix-index"
INDEX_VERSION = 1

# Each plane of an index block as the JAX package writes it: C order,
# little-endian (bfloat16 as its 16-bit pattern).
_LE_DTYPES = {torch.bfloat16: (np.dtype("<i2"), torch.int16),
              torch.float32: (np.dtype("<f4"), torch.float32),
              torch.int8: (np.dtype("i1"), torch.int8)}


def _le_bytes(t: torch.Tensor) -> bytes:
    """The bytes of CPU tensor `t`, C-contiguous and little-endian."""
    le, as_int = _LE_DTYPES[t.dtype]
    return t.contiguous().view(as_int).numpy().astype(le, copy=False).tobytes()


def _from_le_bytes(buf: bytes, dtype: torch.dtype, shape, pin: bool) -> torch.Tensor:
    """`_le_bytes`'s inverse: a CPU tensor of `dtype` and `shape` (pinned
    with `pin`). Raises ValueError when `buf` is not that many bytes."""
    le, as_int = _LE_DTYPES[dtype]
    a = np.frombuffer(buf, dtype=le).astype(le.newbyteorder("="))
    t = torch.from_numpy(a.reshape(shape)).view(dtype)
    return t.pin_memory() if pin else t


@dataclasses.dataclass
class _HostBlock:
    """One pool block's K/V parked in the host-RAM tier: CPU copies of
    its ``(L, block_size, NKV, H)`` planes (int8 codes and the float32
    ``(L, block_size, NKV, 1)`` scale planes on a quantized pool) and the
    digests that can claim it. The bytes were frozen on the device when
    the first digest was registered, so swapping them back
    (`write_pool_block`) restores the block verbatim. ``ready`` is the
    CUDA event recorded after the device-to-host copy was queued (None
    on the CPU): a host read of the bytes waits on it first."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    digests: set
    nbytes: int
    ready: Optional[object] = None

    def planes(self) -> tuple:
        """The entry's tensors in index order (k, v[, k_scale, v_scale]),
        once the copy that filled them has landed."""
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        return tuple(a for a in (self.k, self.v, self.k_scale, self.v_scale)
                     if a is not None)


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_time`` is seconds after the start
    of ``run()``; ``t_first``/``t_done`` are filled by the scheduler;
    ``error`` is set (and the request returned) when it can never fit, is
    cancelled, misses a deadline, its logits turn non-finite, or its
    ``on_token`` callback raises."""

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
    # Speculative-decoding counters (filled when the scheduler runs with
    # `speculate`): draft tokens proposed for this request and how many of
    # them greedy verification accepted.
    spec_drafted: int = 0
    spec_accepted: int = 0
    # Per-request precision tier: a "wXaY" token (or QuantConfig) naming
    # one of the scheduler's configured `tiers`, served as a plane-
    # truncated view of the one packed weight set. None = the storage
    # policy. An unconfigured or malformed tier fails the request.
    tier: Union[None, str, QuantConfig] = None
    # Completion deadlines: `deadline_s` is wall-clock seconds after
    # `arrival_time` (evaluated only while `run()` drives the clock);
    # `deadline_steps` is a budget of scheduler steps counted from
    # `submit()`. A request past either — queued or live — is retired
    # with error="deadline". None = no deadline.
    deadline_s: Optional[float] = None
    deadline_steps: Optional[int] = None
    # Times this request was preempted under pool pressure (each requeued
    # it as prompt ++ generated for a warm, bitwise resume) and, when
    # graceful degradation admitted it, the tier it was served at (sticky
    # for the request's whole life).
    preemptions: int = 0
    degraded_to: Optional[str] = None
    # (key, chain digests) memo of ContinuousScheduler._req_hashes.
    _prefix_hashes: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # The canonical tier key `_tier_error` resolved, and the scheduler
    # step at `submit()` (the epoch of `deadline_steps`).
    _tier_key: Optional[str] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _submit_step: Optional[int] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def spec_acceptance_rate(self) -> float:
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

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
                 pool_blocks: Optional[int] = None, prefix_cache: Optional[bool] = None,
                 chunked_prefill: Optional[bool] = None, prefill_budget: int = 32,
                 speculate: int = 0, draft_policy="w4a8", tiers=None,
                 preempt: Optional[bool] = None, victim_policy: str = "most-blocks",
                 max_head_bypass: int = 4, degrade: bool = False, degrade_after: int = 2,
                 chaos: Optional[FaultInjector] = None, host_pool_bytes: int = 0,
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
        # Prefix caching rides on the paged pool (shared blocks need block
        # tables and host-side ownership) and on suffix-only prefill.
        can_prefix = paged and getattr(self.model, "prefill_suffix", None) is not None
        if prefix_cache is None:
            prefix_cache = can_prefix
        elif prefix_cache and not can_prefix:
            raise ValueError(f"{cfg.name}: prefix caching requires the paged KV "
                             "cache and an arch with suffix-only prefill "
                             "(token-input, non-MoE full-attention transformer)")
        self.prefix_cache = prefix_cache
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

        # Self-speculative decoding: drafting reuses the decode step with
        # *view* params (plane_lo on the packed leaves, the same tensors)
        # and verification the chunk path with all-position logits, so it
        # needs the paged pool, the verify entry and packed weights.
        if speculate:
            if speculate < 1:
                raise ValueError("speculate must be >= 1 (0 disables)")
            can_spec = (paged and getattr(self.model, "prefill_chunk_logits_multi",
                                          None) is not None)
            if not can_spec:
                raise ValueError(f"{cfg.name}: speculative decoding requires the paged "
                                 "KV cache and the chunked-prefill verify path "
                                 "(token-input, non-MoE full-attention transformer)")
            # Raises when the params carry no packed leaves (serve with a
            # quant policy) or the draft truncates nothing.
            self._draft_params, _ = derive_draft_params(self.params, draft_policy)
            self._draft_bits = parse_tier_token(draft_policy).w_bits
        self.speculate = int(speculate)
        self.draft_policy = draft_policy
        self.spec_rounds = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_verify_calls = 0     # multi-row verify calls
        self.spec_verify_rows = 0      # slots verified across those calls

        # Per-request precision tiers: each tier is a plane-truncated view
        # of the one packed weight set (every tensor shared by identity),
        # key None the storage policy itself.
        tier_cfgs: Dict[str, QuantConfig] = {}
        tier_views: Dict[Optional[str], object] = {None: self.params}
        if tiers:
            if not paged:
                raise ValueError(f"{cfg.name}: per-request precision tiers need the "
                                 "paged KV cache (tier groups are isolated by masked "
                                 "block tables)")
            for tcfg in parse_tier_specs(tiers):
                key = quant_token(tcfg)
                # Raises unless the tier is a pure plane truncation of the
                # storage policy (packed params, whole planes, same a-bits).
                tier_views[key], _ = truncate_policy_view(self.params, tcfg)
                tier_cfgs[key] = tcfg
        self._tier_cfgs = tier_cfgs
        self._tier_views = tier_views
        self.tiers = tuple(tier_cfgs)
        self._slot_tier: List[Optional[str]] = [None] * max_batch
        self.tier_counters: Dict[Optional[str], Dict[str, int]] = {
            k: {"requests": 0, "tokens": 0, "decode_calls": 0,
                "spec_draft_tokens": 0, "spec_accepted_tokens": 0}
            for k in [None, *tier_cfgs]}

        # Preemption (None: on whenever the pool is paged) evicts at most one
        # live victim a step for a pool-blocked head; see the docstring.
        if preempt is None:
            preempt = paged
        elif preempt and not paged:
            raise ValueError(f"{cfg.name}: preemption needs the paged KV cache (the "
                             "contiguous scheduler has no pool pressure to relieve)")
        self.preempt = bool(preempt)
        if victim_policy not in VICTIM_POLICIES:
            raise ValueError(f"unknown victim_policy {victim_policy!r}; choose one of "
                             f"{VICTIM_POLICIES}")
        self.victim_policy = victim_policy

        # The host-RAM block tier under the paged pool (see the docstring):
        # spilled blocks are found again by their chain digests, so it
        # rides on the prefix cache.
        self.host_pool_bytes = int(host_pool_bytes or 0)
        if self.host_pool_bytes < 0:
            raise ValueError("host_pool_bytes must be >= 0 (0 disables the "
                             "host-RAM tier)")
        self.host_tier = bool(self.host_pool_bytes and paged and prefix_cache)
        if self.host_pool_bytes and not self.host_tier:
            raise ValueError(f"{cfg.name}: the host-RAM block tier rides on the "
                             "paged pool and the prefix cache (spilled blocks are "
                             "found by their chain digests); enable both or set "
                             "host_pool_bytes=0")
        if victim_policy == "block-to-host" and not self.host_tier:
            raise ValueError("victim_policy='block-to-host' spills the victim's K/V "
                             "to the host-RAM block tier; pass host_pool_bytes > 0 "
                             "(and keep the paged pool and prefix cache on)")
        self._host_store: "collections.OrderedDict[int, _HostBlock]" = (
            collections.OrderedDict())      # insertion order = oldest first
        self._host_index: Dict[bytes, int] = {}     # digest → host id
        self._host_next_id = 0
        self.host_bytes = 0
        self.swap_ins = 0           # host → device block copies
        self.swap_outs = 0          # device → host spills
        self.host_evictions = 0     # host entries dropped by the budget
        self.host_hit_blocks = 0
        self.host_hit_tokens = 0
        if max_head_bypass < 0:
            raise ValueError("max_head_bypass must be >= 0 (0 disables "
                             "head-of-line bypass)")
        self.max_head_bypass = int(max_head_bypass)
        if degrade_after < 1:
            raise ValueError("degrade_after must be >= 1")
        self.degrade = bool(degrade)
        self.degrade_after = int(degrade_after)
        if degrade:
            if not tier_cfgs:
                raise ValueError("degrade=True serves pressure admissions at the lowest "
                                 "configured precision tier — pass tiers= / --tiers")
            self._degrade_to = quant_token(degrade_order(tier_cfgs.values())[-1])
        self.chaos = chaos

        # Lifecycle: cancellations and deadlines are processed at the start
        # of the next step(); `_step_calls` is the deadline_steps clock.
        self._cancelled: set = set()
        self._step_calls = 0
        self._head_bypass = 0           # consecutive bypasses of the blocked head
        self._pressure_streak = 0       # consecutive pool-blocked steps
        self.preemptions = 0
        self.cancellations = 0
        self.deadline_misses = 0
        self.pool_pressure_events = 0
        self.queue_wait_steps = 0
        self.head_bypasses = 0
        self.degraded_requests = 0
        self.callback_errors = 0
        self.nan_logit_events = 0
        self.kernel_fallbacks = 0

        B = max_batch
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
            # Free + LRU-retained minus outstanding reservations: what
            # admission can still promise without deadlocking a live row.
            self._avail = usable
            self._reserved = np.zeros((B,), np.int64)
            self._block_tab = np.full((B, self._max_blocks), -1, np.int32)
            self._table_dirty = False
            self._peak_blocks = 0
            # Prefix-cache ownership: refcounts, digest → block, block →
            # every digest registered against it (a retired row's straddle
            # block carries its prompt-partial and its extended full-chunk
            # digest; once any digest is attached the block's bytes are
            # frozen), and the refcount-0 cached blocks in LRU order.
            self._refcnt = np.zeros((usable + 1,), np.int64)
            self._prefix_index: Dict[bytes, int] = {}
            self._block_hash: Dict[int, set] = {}
            self._lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()
            self._slot_hashes: List[Optional[tuple]] = [None] * B
            self.prefix_hit_blocks = 0
            self.prefix_hit_tokens = 0
            self.prompt_tokens_seen = 0
            self.cow_copies = 0
            self.prefix_evictions = 0
            # Tokens run through prefill at admission (padding included):
            # a prefix hit prefills only its suffix.
            self.prefill_tokens_computed = 0
        else:
            # Every slot reserves a full max_ctx (+ headroom) row for life.
            self.cache = self.model.init_cache(B, max_ctx, device=self.device)
        # Admission bound: max_ctx in every mode, so static, contiguous and
        # paged agree on which requests fit; ring buffers and recurrent
        # states are position-unbounded (None).
        kv = self.cache.kv
        self._capacity = (max_ctx if paged or (isinstance(kv, KVCache) and not kv.window)
                          else None)

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
        req._submit_step = self._step_calls     # the deadline_steps epoch
        self.waiting.append(req)

    def cancel(self, rid: int) -> bool:
        """Cancel request `rid`, at the start of the next ``step()`` —
        nothing changes mid-step, so this is safe from an ``on_token``
        callback. A queued request leaves the queue; a live one (a chunk
        plan included) retires with its blocks freed like any retirement.
        Either comes back with ``error="cancelled"`` and the tokens it had
        emitted. Returns True iff `rid` is queued or live."""
        known = (any(r.rid == rid for r in self.waiting)
                 or any(r is not None and r.rid == rid for r in self._slots))
        if known:
            self._cancelled.add(rid)
        return known

    def _deadline_expired(self, req: Request, now: Optional[float]) -> bool:
        if req.deadline_steps is not None and req._submit_step is not None:
            if self._step_calls - req._submit_step > req.deadline_steps:
                return True
        if req.deadline_s is not None and now is not None:
            return now - req.arrival_time > req.deadline_s
        return False

    def _retire_abnormal(self, b: int, reason: str) -> Request:
        """Retire live row `b` off the normal finish path (cancellation,
        deadline, non-finite logits): mark it failed, free its blocks, reservation and chunk
        plan as a normal retirement does, and return the request with the
        tokens it emitted."""
        req = self._slots[b]
        self._fail(req, reason)
        self._release_slot(b)
        return req

    def _lifecycle_phase(self) -> List[Request]:
        """Process cancellations and deadline expiries before the step
        admits or decodes anything: queued requests leave the queue, live
        rows retire. Returns the requests retired."""
        out: List[Request] = []
        live = [r for r in self._slots if r is not None]
        if not self._cancelled and not any(
                r.deadline_s is not None or r.deadline_steps is not None
                for r in [*self.waiting, *live]):
            return out
        now = self._now()
        keep: Deque[Request] = collections.deque()
        for r in self.waiting:
            if r.rid in self._cancelled:
                self.cancellations += 1
                self._fail(r, "cancelled")
                out.append(r)
            elif self._deadline_expired(r, now):
                self.deadline_misses += 1
                self._fail(r, "deadline")
                out.append(r)
            else:
                keep.append(r)
        self.waiting = keep
        for b, r in enumerate(self._slots):
            if r is None:
                continue
            if r.rid in self._cancelled:
                self.cancellations += 1
                out.append(self._retire_abnormal(b, "cancelled"))
            elif self._deadline_expired(r, now):
                self.deadline_misses += 1
                out.append(self._retire_abnormal(b, "deadline"))
        self._cancelled.clear()     # rids already retired drop here
        return out

    def _now(self) -> Optional[float]:
        return None if self._t0 is None else time.perf_counter() - self._t0

    @staticmethod
    def _serve_tokens(req: Request) -> np.ndarray:
        """The tokens admission serves for `req`: its prompt, plus the
        tokens it generated before a preemption requeued it. Admitting
        prompt ++ generated prefills (or hits) the positions an
        uninterrupted run has resident, which is what makes a resume
        bitwise the uninterrupted stream."""
        if not req.out_tokens:
            return np.asarray(req.prompt)
        return np.concatenate([np.asarray(req.prompt, np.int64),
                               np.asarray(req.out_tokens, np.int64)])

    @staticmethod
    def _serve_len(req: Request) -> int:
        return len(req.prompt) + len(req.out_tokens or ())

    def _need_tokens(self, req: Request) -> int:
        # The first token comes from the prefill logits and writes no
        # cache slot; only the remaining max_new - 1 decode inputs do.
        # Unchanged by a preemption: the served length grows by the tokens
        # already emitted and the decode inputs still owed shrink by as many.
        return len(req.prompt) + max(req.max_new_tokens, 1) - 1

    def _need_blocks(self, req: Request) -> int:
        return -(-self._need_tokens(req) // self.block_size)

    def _bucketed(self, n: int) -> int:
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def _tier_error(self, req: Request) -> Optional[str]:
        """Resolve `req.tier` into ``req._tier_key`` (the canonical "wXaY"
        key of its view and counters; None = the storage policy). Non-None
        iff the tier can never be served here."""
        req._tier_key = None
        if req.tier is not None:
            try:
                key = quant_token(parse_tier_token(req.tier))
            except ValueError as e:
                return f"request {req.rid}: bad precision tier: {e}"
            if key not in self._tier_views:
                have = sorted(self._tier_cfgs) or "none configured"
                return (f"request {req.rid}: unknown precision tier {key!r}; "
                        f"scheduler tiers: {have} — pass tiers= / --tiers to "
                        "serve this class")
            req._tier_key = key
        # A degraded admission stays degraded for life: its tokens and its
        # registered K/V are at the degraded tier, so a resume at the asked
        # tier would splice two precisions into one stream.
        if req.degraded_to is not None:
            req._tier_key = req.degraded_to
        return None

    def _degrade_tier(self, req: Request) -> bool:
        """Point this admission attempt at the lowest configured tier
        (graceful degradation under sustained pool pressure). Transient
        until the request admits — `_tier_error` resolves `_tier_key` again
        on every attempt — and committed to `req.degraded_to` by the
        admission loop. True iff the attempt was newly lowered."""
        low = self._degrade_to
        cur = req._tier_key
        cur_bits = self._tier_cfgs[cur].w_bits if cur is not None else 1 << 30
        if req.degraded_to is None and self._tier_cfgs[low].w_bits < cur_bits:
            req._tier_key = low
            return True
        return False

    # -- preemption: victim choice, warm-resume requeue ---------------------

    def _freeable(self, b: int) -> int:
        """The `_avail` that releasing row `b` would add: its unclaimed
        reservation plus every block only it references (a shared block
        stays with its other referencers)."""
        row = self._block_tab[b]
        own = sum(1 for blk in row[row >= 0] if self._refcnt[int(blk)] == 1)
        return int(own) + int(self._reserved[b])

    @staticmethod
    def _deadline_rank(req: Request):
        """Slack order of the `latest-deadline` policy, larger = more slack
        = the preferred victim: no deadline first, then wall-clock
        deadlines by their absolute time, then step budgets by horizon."""
        if req.deadline_s is None and req.deadline_steps is None:
            return (2, 0.0)
        if req.deadline_s is not None:
            return (1, req.arrival_time + req.deadline_s)
        return (0, float((req._submit_step or 0) + req.deadline_steps))

    def _pick_victim(self, shortfall: int, exclude) -> Optional[int]:
        """A victim whose release alone covers the blocked admission's
        shortfall, or None (a cascade of evictions for one admission is
        never worth the recompute: the head waits). Rows with a chunk plan
        (their blocks are partly written) and rows admitted earlier in this
        step are never victims."""
        cands = [b for b, r in enumerate(self._slots)
                 if r is not None and b not in self._chunk_plans
                 and b not in exclude and self._freeable(b) >= shortfall]
        if not cands:
            return None
        if self.victim_policy in ("most-blocks", "block-to-host"):
            # block-to-host picks like most-blocks; it differs in where the
            # victim's K/V goes (`_preempt`).
            def key(b):
                return (self._freeable(b), -b)
        elif self.victim_policy == "lowest-tier":
            def key(b):
                t = self._slot_tier[b]
                bits = self._tier_cfgs[t].w_bits if t is not None else 1 << 30
                return (-bits, self._freeable(b), -b)
        else:  # latest-deadline
            def key(b):
                return (self._deadline_rank(self._slots[b]), self._freeable(b), -b)
        return max(cands, key=key)

    def _preempt(self, b: int) -> None:
        """Preempt row `b`: release the slot — which registers its written
        prompt and generated blocks in the prefix index
        (`_register_retired`) — and requeue the request at the back of the
        queue as prompt ++ generated. Its re-admission takes the ordinary
        warm path over those blocks (or recomputes what was evicted
        meanwhile); either way the resumed stream is bitwise the
        uninterrupted one. Under ``victim_policy="block-to-host"`` the
        victim's blocks that the release left in the LRU (hashed, no
        other referencer) spill to the host tier at once, so the
        admissions ahead of the victim cannot evict them: its resume is
        warm from host at worst."""
        req = self._slots[b]
        self.preemptions += 1
        req.preemptions += 1
        row = self._block_tab[b]
        row_blocks = [int(blk) for blk in row[row >= 0]]
        self._release_slot(b)
        if self.victim_policy == "block-to-host":
            for blk in row_blocks:
                if blk in self._lru and blk in self._block_hash:
                    self._lru.pop(blk)
                    self._spill_block(blk)
                    self._free.append(blk)
        self.waiting.append(req)

    def _bypass_candidate(self, deg: bool):
        """Head-of-line mitigation: when the queue head is pool-blocked,
        the first later request that is admissible and fits, at most
        `max_head_bypass` times in a row so the head is never starved.
        Returns (queue index, match, newly degraded) or (None, None,
        False)."""
        if self._head_bypass >= self.max_head_bypass:
            return None, None, False
        for i in range(1, len(self.waiting)):
            r = self.waiting[i]
            if self._reject_reason(r) is not None:
                continue            # rejected for real when it reaches the head
            d = self._degrade_tier(r) if deg else False
            m = self._match_prefix(r)
            if m[2] + m[3] <= self._avail:
                return i, m, d
        return None, None, False

    def _decode_call(self, params, cur: torch.Tensor) -> torch.Tensor:
        """One decode dispatch, with the ``kernel`` fault seam. An injected
        fault fires before anything is dispatched (the pool is untouched),
        and the same call is dispatched again through the same kernels:
        on the card there is no other backend to run, and a plain-version
        re-run would not be bitwise. Only `InjectedFault` is caught here; a
        real error propagates out of ``step()``."""
        try:
            if self.chaos is not None and self.chaos.fire("kernel"):
                raise InjectedFault("kernel dispatch")
            self.cache, logits = self.model.decode_step(params, self.cache, cur)
        except InjectedFault:
            self.kernel_fallbacks += 1
            self.cache, logits = self.model.decode_step(params, self.cache, cur)
        return logits

    def _reject_reason(self, req: Request) -> Optional[str]:
        """Non-None iff the request can never be served here (vs. waiting
        for pool blocks)."""
        err = self._tier_error(req)
        if err is not None:
            return err
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
        """Pool blocks referenced by a row's table (LRU-retained prefix
        blocks are resident but reclaimable, so they do not count)."""
        return self.pool_blocks - len(self._free) - len(self._lru)

    def _touch_peak(self) -> None:
        self._peak_blocks = max(self._peak_blocks, self._live_blocks)

    def _evict_lru(self) -> None:
        """Reclaim the least-recently-used retained prefix block: its
        digests leave the index and it joins the free list. Only
        refcount-0 blocks sit in the LRU, so eviction never takes a block
        from a live row or a reservation (``_avail`` counts LRU blocks as
        reclaimable). With the host tier on, the block's bytes and digests
        move to the host store instead (`_spill_block`), and a later hit
        on its chain swaps them back."""
        if not self._lru:
            raise RuntimeError("paged pool invariant violated: reservation "
                               "accounting should guarantee a free or "
                               "evictable block")
        blk, _ = self._lru.popitem(last=False)
        if self.host_tier and blk in self._block_hash:
            self._spill_block(blk)
        else:
            for h in self._block_hash.pop(blk, ()):
                self._prefix_index.pop(h, None)
            self.prefix_evictions += 1
        self._free.append(blk)

    def _take_free_block(self) -> int:
        if not self._free:
            self._evict_lru()
        return self._free.pop()

    # -- host-RAM block tier: spill, budget, swap-in -------------------------

    def _host_block_nbytes(self) -> int:
        """Host bytes one spilled block holds: K and V in every layer, and
        a quantized pool's float32 scale planes."""
        kv = self.cache.kv
        per = 2 * kv.k.shape[0] * int(np.prod(kv.k.shape[2:])) * kv.k.element_size()
        if kv.quantized:
            per += (2 * kv.k_scale.shape[0] * int(np.prod(kv.k_scale.shape[2:]))
                    * kv.k_scale.element_size())
        return per

    def _spill_block(self, blk: int) -> None:
        """Move pool block `blk`'s bytes and digests to the host store. The
        caller owns the block's pool bookkeeping (it is out of the LRU and
        about to join the free list); its digests leave the device index
        here and enter the host index, so no digest resolves to both.

        On CUDA the copy goes into pinned memory without blocking the host,
        queued on the current stream behind every kernel already queued —
        a spill inside a step reads the block's final bytes, and a kernel
        queued later that writes the block (once it is reallocated) runs
        after the copy. The entry records an event so that a host read of
        the bytes (`export_index`) waits for them; a swap-in is queued on
        the same stream and needs no wait."""
        kv = self.cache.kv
        digests = self._block_hash.pop(blk)
        for h in digests:
            self._prefix_index.pop(h, None)
        on_cuda = kv.k.is_cuda
        planes = [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.quantized else [])
        copies = []
        for a in planes:
            src = a[:, blk]
            dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=on_cuda)
            copies.append(dst.copy_(src, non_blocking=on_cuda))
        ready = None
        if on_cuda:
            ready = torch.cuda.Event()
            ready.record()
        k, v, *scales = copies
        self._add_host_entry(_HostBlock(
            k=k, v=v, k_scale=scales[0] if scales else None,
            v_scale=scales[1] if scales else None, digests=set(digests),
            nbytes=self._host_block_nbytes(), ready=ready))
        self.swap_outs += 1

    def _add_host_entry(self, entry: _HostBlock) -> None:
        """Insert an entry at the newest end of the host store and hold
        the byte budget by dropping the oldest entries (their chunks die:
        a later request prefills them again)."""
        hid = self._host_next_id
        self._host_next_id += 1
        self._host_store[hid] = entry
        self.host_bytes += entry.nbytes
        for h in entry.digests:
            self._host_index[h] = hid
        while self.host_bytes > self.host_pool_bytes and self._host_store:
            _, old = self._host_store.popitem(last=False)
            for h in old.digests:
                self._host_index.pop(h, None)
            self.host_bytes -= old.nbytes
            self.host_evictions += 1
            self.prefix_evictions += 1

    def _pop_host_entry(self, hid: int) -> _HostBlock:
        """Take a host entry out for a swap-in. Its digests leave the host
        index first, so a spill the swap-in's allocation causes cannot
        drop it under the budget."""
        entry = self._host_store.pop(hid)
        for h in entry.digests:
            self._host_index.pop(h, None)
        self.host_bytes -= entry.nbytes
        return entry

    def _drop_host_digest(self, h: bytes) -> None:
        """A device registration of digest `h` supersedes its host copy:
        drop the digest from its host entry, and the entry once no digest
        reaches it (the two indexes stay disjoint)."""
        hid = self._host_index.pop(h, None)
        if hid is None:
            return
        entry = self._host_store[hid]
        entry.digests.discard(h)
        if not entry.digests:
            del self._host_store[hid]
            self.host_bytes -= entry.nbytes

    def _swap_in_hits(self, slot: int, host_hits, n_full: int) -> None:
        """Swap row `slot`'s host-resident prefix hits back into the pool:
        each allocates a block from the row's reservation (`_alloc_block`,
        whose eviction may spill another LRU block to host) and gets the
        host bytes verbatim (`write_pool_block`). A full-chunk hit
        registers its digests against the new block, so a same-prefix
        admission shares it like any cached block; a partial-chunk hit
        does not, because the row appends into that block in place (a
        live row's partial block is never shared) and its retirement
        registers the final bytes."""
        for j, hid in host_hits:
            entry = self._pop_host_entry(hid)
            self._alloc_block(slot, j)
            blk = int(self._block_tab[slot, j])
            write_pool_block(self.cache, blk, entry.k, entry.v, entry.k_scale,
                             entry.v_scale)
            self.swap_ins += 1
            self.host_hit_blocks += 1
            if j < n_full:
                for h in entry.digests:
                    self._prefix_index[h] = blk
                    self._block_hash.setdefault(blk, set()).add(h)

    # -- durable prefix index: export, import, save, load ---------------------

    def _pool_geometry(self) -> dict:
        """The pool's block geometry under the JAX package's names: the
        dtype as JAX spells it ("bfloat16", "int8", "float32") and
        ``kv_shape`` = [L, block_size, NKV, H]."""
        kv = self.cache.kv
        return {"block_size": self.block_size,
                "quantized": bool(kv.quantized),
                "kv_shape": [int(kv.k.shape[0]), *(int(x) for x in kv.k.shape[2:5])],
                "kv_dtype": str(kv.k.dtype).removeprefix("torch.")}

    def export_index(self) -> dict:
        """Every cached chunk the scheduler could serve a hit from — hashed
        device blocks (live or in the LRU) and host entries — as a
        JSON-able dict in the JAX package's format: the schema header
        with the pool geometry, a list of blocks (each plane's bytes
        C-contiguous, little-endian, base64) and a digest (hex) → block
        map. `import_index` on a fresh scheduler puts them in its host
        tier. Digests are tier-seeded, so a mixed-tier index round-trips
        as it is."""
        kv = self.cache.kv
        names = ("k", "v", "k_scale", "v_scale")
        blocks: List[dict] = []
        digests: Dict[str, int] = {}

        def add(planes, hs) -> None:
            entry = {n: None for n in names}
            for n, a in zip(names, planes):
                entry[n] = base64.b64encode(_le_bytes(a)).decode("ascii")
            for h in hs:
                digests[h.hex()] = len(blocks)
            blocks.append(entry)

        if self.paged:
            dev = [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.quantized else [])
            for blk, hs in self._block_hash.items():
                add([a[:, blk].cpu() for a in dev], hs)
            for hb in self._host_store.values():
                add(hb.planes(), hb.digests)
        return {"schema": INDEX_SCHEMA, "version": INDEX_VERSION,
                **self._pool_geometry(), "blocks": blocks, "digests": digests}

    def import_index(self, data) -> int:
        """Load an `export_index` snapshot (the port's or the JAX
        package's) into the host tier, where its entries count against
        ``host_pool_bytes`` like spills (the oldest dropped first when it
        exceeds the budget). Returns the number of digests now
        resolvable. Never raises on bad input: a payload that is not an
        index, another version, another pool geometry, a digest table
        that is not hex or points past the blocks, or block bytes of the
        wrong size each warn and load 0 — a stale index must not take
        down a server that can prefill again."""
        if not self.host_tier:
            if data:
                warnings.warn("prefix-index import skipped: the host-RAM tier is "
                              "disabled (host_pool_bytes=0)")
            return 0
        if not isinstance(data, dict) or data.get("schema") != INDEX_SCHEMA:
            warnings.warn("prefix-index import: unrecognized payload (not an index "
                          "snapshot) — cold start")
            return 0
        if data.get("version") != INDEX_VERSION:
            warnings.warn(f"prefix-index import: unsupported version "
                          f"{data.get('version')!r} (want {INDEX_VERSION}) — cold start")
            return 0
        geo = self._pool_geometry()
        theirs = {k: data.get(k) for k in geo}
        if theirs != geo:
            warnings.warn(f"prefix-index import: pool geometry mismatch ({theirs} != "
                          f"{geo}) — cold start")
            return 0
        blocks, digests = data.get("blocks"), data.get("digests")
        if not isinstance(blocks, list) or not isinstance(digests, dict):
            warnings.warn("prefix-index import: malformed blocks/digests tables — "
                          "cold start")
            return 0
        by_block: Dict[int, set] = {}
        try:
            for hx, idx in digests.items():
                idx = int(idx)
                if not 0 <= idx < len(blocks):
                    warnings.warn(f"prefix-index import: digest {hx!r} references "
                                  f"out-of-range block {idx} (have {len(blocks)}) — "
                                  "cold start")
                    return 0
                by_block.setdefault(idx, set()).add(bytes.fromhex(hx))
        except (TypeError, ValueError) as e:
            warnings.warn(f"prefix-index import: bad digest table ({e}) — cold start")
            return 0
        L, bs, nkv, hd = geo["kv_shape"]
        kv = self.cache.kv
        specs = [("k", kv.k.dtype, hd), ("v", kv.k.dtype, hd)]
        if geo["quantized"]:
            specs += [("k_scale", torch.float32, 1), ("v_scale", torch.float32, 1)]
        pin = kv.k.is_cuda
        loaded, entries = 0, []
        try:
            for idx, hs in by_block.items():
                e = blocks[idx]
                planes = [_from_le_bytes(base64.b64decode(e[n]), dt, (L, bs, nkv, w), pin)
                          for n, dt, w in specs]
                live = {h for h in hs
                        if h not in self._prefix_index and h not in self._host_index}
                if not live:
                    continue            # a resident copy is at least as fresh
                k, v, *scales = planes
                entries.append(_HostBlock(
                    k=k, v=v, k_scale=scales[0] if scales else None,
                    v_scale=scales[1] if scales else None, digests=live,
                    nbytes=self._host_block_nbytes()))
                loaded += len(live)
        except (KeyError, TypeError, ValueError) as e:
            warnings.warn(f"prefix-index import: corrupt block payload ({e}) — "
                          "cold start")
            return 0
        for entry in entries:
            self._add_host_entry(entry)
        return loaded

    def save_index(self, path) -> int:
        """Write `export_index` to `path` as JSON. Returns the number of
        digests written."""
        data = self.export_index()
        with open(path, "w") as f:
            json.dump(data, f)
            f.write("\n")
        return len(data["digests"])

    def load_index(self, path) -> int:
        """Load a `save_index` file (either package's) into the host tier
        through `import_index`. A missing, truncated or corrupt file warns
        and loads 0; nothing raises."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(f"prefix-index load from {path!s} failed ({e}) — cold start")
            return 0
        return self.import_index(data)

    def _alloc_block(self, slot: int, j: int) -> None:
        blk = self._take_free_block()
        self._refcnt[blk] = 1
        self._block_tab[slot, j] = blk
        self._reserved[slot] -= 1
        self._table_dirty = True
        self._touch_peak()

    def _decref(self, blk: int) -> None:
        """Drop one table reference. At refcount 0 a prefix-cached block is
        retained (LRU end, evicted lazily under pool pressure, so a repeat
        of the prompt still hits); an uncached block frees at once."""
        self._refcnt[blk] -= 1
        if self._refcnt[blk] == 0:
            if blk in self._block_hash:
                self._lru[blk] = None
            else:
                self._free.append(blk)
            self._avail += 1

    def _ensure_private_block(self, b: int, j: int) -> None:
        """Make virtual block `j` of row `b` writable: allocate it if
        empty, and copy it on write when the row shares it — with other
        rows (refcount > 1) or with the prefix cache itself (a registered
        digest describes its bytes, so even a sole referencer must not
        append in place). The sharers keep the pristine block; the copy
        is charged to the row's reservation like any allocation."""
        blk = int(self._block_tab[b, j])
        if blk < 0:
            self._alloc_block(b, j)
        elif self._refcnt[blk] > 1 or blk in self._block_hash:
            dst = self._take_free_block()
            self._refcnt[dst] = 1
            copy_pool_block(self.cache, blk, dst)
            self._block_tab[b, j] = dst
            self._decref(blk)
            self._reserved[b] -= 1
            self._table_dirty = True
            self.cow_copies += 1
            self._touch_peak()

    def _alloc_boundary_blocks(self) -> None:
        """Back the position each live (decoding) slot writes this step."""
        for b, req in enumerate(self._slots):
            if req is None or b in self._chunk_plans:
                continue
            j = int(self._pos_host[b]) // self.block_size
            if j < self._max_blocks:
                self._ensure_private_block(b, j)

    def _alloc_blocks_through(self, b: int, last_pos: int) -> None:
        """Back every position row `b` writes in a speculation round —
        [pos, last_pos] spans the draft writes and the verify chunk — with
        writable (private) blocks, before any of them runs. Blocks backed
        for drafts that verification rejects stay allocated: they sit
        inside the row's admission reservation and its next decode steps
        write them anyway."""
        first = int(self._pos_host[b]) // self.block_size
        last = min(last_pos // self.block_size, self._max_blocks - 1)
        for j in range(first, last + 1):
            self._ensure_private_block(b, j)

    def _push_spec_table(self, spec_slots) -> None:
        """Device block table for the draft phase, written in place: only
        speculating rows keep their real blocks. Every other row — live
        decoders, chunk plans, free slots — is masked to -1, so the draft
        decode steps route its writes to the trash block and attend over
        nothing (its logits are discarded). Without this a draft step
        would write *draft-policy* K/V at a non-speculating row's live
        position, possibly into a block it shares. Marks the table dirty
        so the real table is pushed again before the normal decode."""
        tab = self._block_tab.copy()
        for b in range(self.max_batch):
            if b not in spec_slots:
                tab[b, :] = -1
        self.cache.kv.block_table.copy_(torch.from_numpy(tab))
        self._table_dirty = True

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
        """Retire row `b`. On the paged pool its blocks are decref'd
        (shared blocks stay with their other referencers, last-reference
        cached blocks go to the LRU, the rest are freed) and its unclaimed
        reservation returns. What the row wrote — prompt AND generated
        tokens — is registered in the prefix index here, once the row has
        stopped appending into its tail block. A contiguous row is simply
        overwritten by its next admission."""
        req = self._slots[b]
        tier = self._slot_tier[b]
        self._slots[b] = None
        self._slot_tier[b] = None
        if not self.paged:
            return
        if self._chunk_plans.pop(b, None) is not None:
            self._chunk_queue.remove(b)
            self._slot_hashes[b] = None     # unwritten blocks hold nothing
        if self.prefix_cache:
            self._register_retired(b, req, tier)
        self._slot_hashes[b] = None
        row = self._block_tab[b]
        for blk in row[row >= 0]:
            self._decref(int(blk))
        row[:] = -1
        self._avail += int(self._reserved[b])
        self._reserved[b] = 0
        self._table_dirty = True

    # -- prefix cache: digests, matching, claiming, registration -----------

    def _hash_chunks(self, tokens, tier: Optional[str] = None
                     ) -> Tuple[List[bytes], Optional[bytes]]:
        """Chain digests of `tokens` at block granularity: one per full
        block-sized chunk (each covers every token up to the end of its
        chunk, so a hit at chunk j means the whole prefix matches) and one
        for a trailing partial chunk, tagged so it never aliases a full
        block. The chain is seeded with the precision tier — a tier's K/V
        bytes differ from another's, so tiers never share blocks — and
        tier None keeps the untiered seed. Byte-equal to the JAX
        scheduler's digests."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        bs = self.block_size
        full, h = [], b"m4bram-prefix" + (tier.encode() if tier else b"")
        for j in range(len(toks) // bs):
            h = hashlib.blake2b(h + toks[j * bs:(j + 1) * bs].tobytes(),
                                digest_size=16).digest()
            full.append(h)
        r = len(toks) % bs
        partial = (hashlib.blake2b(h + toks[len(toks) - r:].tobytes() + b"#partial",
                                   digest_size=16).digest() if r else None)
        return full, partial

    def _req_hashes(self, req: Request) -> Tuple[List[bytes], Optional[bytes]]:
        """The digests of `req`'s served tokens (prompt ++ generated) at its
        tier, memoized on the request: a pool-blocked queue head is matched
        again every step, and the served length in the key drops the memo
        when a preemption requeues the request with more tokens."""
        key = (self.block_size, req._tier_key, self._serve_len(req))
        if req._prefix_hashes is None or req._prefix_hashes[0] != key:
            req._prefix_hashes = (key, self._hash_chunks(self._serve_tokens(req),
                                                         req._tier_key))
        return req._prefix_hashes[1]

    def _match_prefix(self, req: Request):
        """Longest resident prefix of `req`'s served tokens, without touching the
        allocator. Returns (hits [(virtual j, pool block)], resident token
        count, revive = hits that must leave the LRU, reserve = blocks the
        row may still allocate (uncovered blocks, plus one for a
        copy-on-write of a shared partial block), the (full, partial)
        digests for registration, host_hits [(virtual j, host id)] = chain
        positions resident in the host tier).

        The chain walk tries the device index and then the host index at
        each digest, so a chain that is part device, part host matches
        end to end. Host hits count in ``resident`` (their bytes land
        before any prefill) but not against the reservation: each takes a
        pool block through `_alloc_block` when it is swapped in."""
        need = self._need_blocks(req)
        if not self.prefix_cache:
            return [], 0, 0, need, None, []
        hashes = self._req_hashes(req)
        full, partial = hashes
        hits: List[Tuple[int, int]] = []
        host_hits: List[Tuple[int, int]] = []
        for j, h in enumerate(full):
            blk = self._prefix_index.get(h)
            if blk is not None:
                hits.append((j, blk))
                continue
            hid = self._host_index.get(h)
            if hid is None:
                break
            host_hits.append((j, hid))
        dev_full = len(hits)        # device full-chunk hits claim for free
        n_full = dev_full + len(host_hits)
        resident = n_full * self.block_size
        if n_full == len(full) and partial is not None:
            blk = self._prefix_index.get(partial)
            if blk is not None:
                hits.append((n_full, blk))
                resident = self._serve_len(req)
            elif partial in self._host_index:
                host_hits.append((n_full, self._host_index[partial]))
                resident = self._serve_len(req)
        revive = sum(1 for _, b in hits if self._refcnt[b] == 0)
        return hits, resident, revive, need - dev_full, hashes, host_hits

    def _claim_hits(self, slot: int, hits) -> None:
        """Map matched blocks into row `slot`, incref'ing each; a
        refcount-0 block leaves the LRU, which spends one unit of
        reclaimable capacity (``_avail``)."""
        for j, blk in hits:
            if self._refcnt[blk] == 0:
                self._lru.pop(blk)
                self._avail -= 1
            self._refcnt[blk] += 1
            self._block_tab[slot, j] = blk
        if hits:
            self._table_dirty = True

    def _register_full(self, slot: int, limit: Optional[int] = None) -> None:
        """Index row `slot`'s full prompt blocks once their bytes are final
        (appends land past the prompt). A chunk plan passes ``limit`` to
        register only the blocks its landed chunks cover."""
        full, _ = self._slot_hashes[slot]
        if limit is not None:
            full = full[:limit]
        for j, h in enumerate(full):
            blk = int(self._block_tab[slot, j])
            if blk < 0 or h in self._prefix_index:
                continue
            # The fresh device bytes supersede a host copy of the digest.
            self._drop_host_digest(h)
            self._prefix_index[h] = blk
            self._block_hash.setdefault(blk, set()).add(h)

    def _register_partial(self, slot: int) -> None:
        """Index the trailing partial prompt block, at retirement only: a
        live row appends into it in place, so it is never shared while
        the row lives."""
        full, partial = self._slot_hashes[slot]
        j = len(full)
        if partial is None or j >= self._max_blocks:
            return
        blk = int(self._block_tab[slot, j])
        if blk < 0 or partial in self._prefix_index:
            return
        self._drop_host_digest(partial)
        self._prefix_index[partial] = blk
        self._block_hash.setdefault(blk, set()).add(partial)

    def _register_retired(self, b: int, req: Optional[Request],
                          tier: Optional[str]) -> None:
        """Register what row `b` wrote, at retirement: first the prompt's
        chain (full blocks and the now-immutable partial tail, so a repeat
        of the prompt hits it whole and copies on write when it appends),
        then the chain over prompt ++ generated tokens up to the row's
        position (the last sampled token's K/V never lands), so a
        multi-turn follow-up that resubmits the conversation hits past
        the prompt. Both chains are hashed at the row's tier. Digests the
        chains share register once."""
        if self._slot_hashes[b] is None or req is None:
            return
        self._register_full(b)
        self._register_partial(b)
        pos = int(self._pos_host[b])
        toks = self._serve_tokens(req)[:pos]
        self._slot_hashes[b] = self._hash_chunks(toks, tier)
        self._register_full(b)
        self._register_partial(b)

    def _lifecycle_stats(self) -> dict:
        """Lifecycle and fault counters, under the JAX scheduler's names
        (the preemption and pressure counters stay 0 off the pool).
        ``kernel_fallbacks`` counts decode calls dispatched again after an
        injected fault, through the same kernels."""
        return {"preemptions": self.preemptions,
                "cancellations": self.cancellations,
                "deadline_misses": self.deadline_misses,
                "pool_pressure_events": self.pool_pressure_events,
                "queue_wait_steps": self.queue_wait_steps,
                "head_bypasses": self.head_bypasses,
                "degrade": self.degrade,
                "degraded_requests": self.degraded_requests,
                "preempt": self.preempt,
                "victim_policy": self.victim_policy,
                "callback_errors": self.callback_errors,
                "nan_logit_events": self.nan_logit_events,
                "kernel_fallbacks": self.kernel_fallbacks,
                "chaos": self.chaos.counts() if self.chaos else None}

    def pool_stats(self) -> dict:
        """KV-memory utilization, prefix-cache, host-tier, chunked-prefill,
        speculation, lifecycle and per-tier counters.

        ``prefill_tokens_computed`` counts the token positions admission
        runs through a prefill kernel, bucket padding included: a cold or
        partial-hit admission its bucketed prompt or suffix (or its chunks
        of ``prefill_budget``), a whole-prompt hit under chunked prefill 1
        — the one token ``paged_prefill`` runs there with ``store=False``,
        where the JAX scheduler runs and counts a suffix bucket."""
        kv = self.cache.kv
        if not self.paged:
            # The whole contiguous reservation (a ring) and/or recurrent
            # state is resident for life.
            planes = (kv.k, kv.v, kv.k_scale, kv.v_scale) if kv is not None else ()
            for st, names in ((self.cache.rec, ("h", "conv_tail")),
                              (self.cache.rwkv, ("wkv", "tm_shift", "cm_shift"))):
                if st is not None:
                    planes += tuple(getattr(st, n) for n in names)
            total = sum(a.numel() * a.element_size() for a in planes
                        if a is not None)
            return {"paged": False, "resident_kv_bytes": total,
                    "reserved_kv_bytes": total, "chunked_prefill": False,
                    **self._lifecycle_stats()}
        per_token = (kv.k.shape[0] * int(np.prod(kv.k.shape[3:]))
                     * 2 * kv.k.element_size())
        if kv.quantized:
            per_token += kv.k.shape[0] * kv.k.shape[3] * 2 * 4
        allocated = self._live_blocks
        seen = self.prompt_tokens_seen
        return {
            "paged": True,
            "block_size": self.block_size,
            "pool_blocks": self.pool_blocks,
            "free_blocks": len(self._free),
            # Live = referenced by a row's table; retained = refcount-0
            # prefix blocks kept for later hits, reclaimable on demand.
            "allocated_blocks": allocated,
            "retained_prefix_blocks": len(self._lru),
            "peak_allocated_blocks": self._peak_blocks,
            "capacity_tokens": self.pool_blocks * self.block_size,
            "resident_kv_bytes": allocated * self.block_size * per_token,
            "peak_resident_kv_bytes":
                self._peak_blocks * self.block_size * per_token,
            # The contiguous scheduler's reservation for the same settings
            # (max_ctx + 8 decode-headroom slots per slot, as in JAX).
            "reserved_kv_bytes": self.max_batch * (self.max_ctx + 8) * per_token,
            "prefix_cache": self.prefix_cache,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": seen,
            "prefix_hit_rate": self.prefix_hit_tokens / seen if seen else 0.0,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.prefix_evictions,
            "cached_prefix_blocks": len(self._prefix_index),
            "prefill_tokens_computed": self.prefill_tokens_computed,
            # The host-RAM block tier under the pool.
            "host_tier": self.host_tier,
            "host_pool_bytes": self.host_pool_bytes,
            "host_blocks": len(self._host_store),
            "host_bytes": self.host_bytes,
            "swap_ins": self.swap_ins,
            "swap_outs": self.swap_outs,
            "host_evictions": self.host_evictions,
            "host_hit_blocks": self.host_hit_blocks,
            "host_hit_tokens": self.host_hit_tokens,
            "host_hit_rate": self.host_hit_tokens / seen if seen else 0.0,
            "chunked_prefill": self.chunked_prefill,
            "prefill_budget": self.prefill_budget,
            "prefill_chunks_run": self.prefill_chunks_run,
            "decode_steps_stalled": self.decode_steps_stalled,
            "prefill_tokens_per_step":
                self.prefill_chunk_tokens / max(self.prefill_chunk_steps, 1),
            "prefill_chunk_steps": self.prefill_chunk_steps,
            "speculate": self.speculate,
            "spec_rounds": self.spec_rounds,
            "spec_draft_tokens": self.spec_draft_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_acceptance_rate": (self.spec_accepted_tokens / self.spec_draft_tokens
                                     if self.spec_draft_tokens else 0.0),
            "spec_verify_calls": self.spec_verify_calls,
            "spec_verify_rows": self.spec_verify_rows,
            **self._lifecycle_stats(),
            "tier_serving": bool(self._tier_cfgs),
            "tiers": {
                (k or "base"): {**tc, "spec_acceptance_rate":
                                (tc["spec_accepted_tokens"] / tc["spec_draft_tokens"]
                                 if tc["spec_draft_tokens"] else 0.0)}
                for k, tc in self.tier_counters.items()},
        }

    # -- admission / retirement --------------------------------------------

    def _fail(self, req: Request, reason: str) -> None:
        req.error = reason
        if req.out_tokens is None:
            req.out_tokens = []
        req.t_done = self._now()

    def _claim_tier(self, req: Request, slot: int) -> Optional[str]:
        """Record `req`'s (validated) tier on `slot` and count the
        admission: every compute call of the slot — prefill, chunk,
        decode group, verify — then runs the tier's view params."""
        tier = req._tier_key
        self._slot_tier[slot] = tier
        self.tier_counters[tier]["requests"] += 1
        return tier

    def _claim_row(self, req: Request, slot: int, match) -> None:
        """The allocator half of a paged admission: count the prompt and
        its hits, reserve what the row may still allocate, map the hit
        blocks, swap the host-resident hits back in and allocate the other
        prompt blocks into row `slot` (the prompt of a resumed request is
        its served tokens). The swap-ins are queued before any prefill of
        the row, so a resume's or a suffix's recompute starts after
        them."""
        n = self._serve_len(req)
        hits, resident, _, reserve, hashes, host_hits = match
        bs = self.block_size
        self.prompt_tokens_seen += n
        self.prefix_hit_blocks += len(hits) + len(host_hits)
        self.prefix_hit_tokens += resident
        self.host_hit_tokens += sum(min(bs, n - j * bs) for j, _ in host_hits)
        if self.prefix_cache:
            self._slot_hashes[slot] = hashes
        self._avail -= reserve
        self._reserved[slot] = reserve
        self._claim_hits(slot, hits)       # revives pay into _avail here
        if host_hits:
            self._swap_in_hits(slot, host_hits, len(hashes[0]))
        for j in range(-(-n // self.block_size)):
            if self._block_tab[slot, j] < 0:
                self._alloc_block(slot, j)
        self._touch_peak()

    def _admit(self, req: Request, slot: int, match=None) -> Optional[Request]:
        """Prefill `req` — its whole prompt solo (right-padded to the
        bucket), or only the uncached suffix of a prefix hit — and scatter
        its cache into row `slot`: its pool blocks, or its contiguous row.
        A preempted request admits here with prompt ++ generated, so the
        warm path picks up the blocks its preemption registered (see
        `_resume_tail` for whole-prompt admission). Returns the request if
        it finished on its first token."""
        toks = self._serve_tokens(req)
        n = len(toks)
        resident = 0
        self._claim_tier(req, slot)
        if self.paged:
            match = match if match is not None else self._match_prefix(req)
            self._claim_row(req, slot, match)
            resident = match[1]
        self._slots[slot] = req
        if self.paged and not self.chunked_prefill and n > len(req.prompt):
            logits = self._resume_tail(req, slot, resident)
        elif resident:
            logits = self._prefill_suffix(req, slot, resident)
        else:
            logits = self._flash_prefill(slot, toks, 0)
        if self.paged and self.prefix_cache:
            self._register_full(slot)
        self._pos_host[slot] = n
        return self._first_token(req, slot, logits)

    def _prefill_suffix(self, req: Request, slot: int, resident: int):
        """Prefill a prefix hit at the slot's tier: at least the last prompt
        token is run (the first token is sampled from its logits), and no
        resident position is ever written. Whole-prompt admission runs
        ``prefill_suffix`` (the flash kernel over the gathered prefix ++
        suffix) and scatters the suffix into the row's fresh blocks, or, on
        a full hit, only sets the row's table. Under chunked prefill a full
        hit runs its last token through the chunk kernel with
        ``store=False`` over the shared blocks, so each mode computes warm
        the function it computes cold. ``prefill_tokens_computed`` counts
        what runs: the bucketed suffix, or that one token. (The JAX
        scheduler runs its suffix route there and counts a whole bucket, so
        the port's count is JAX's less bucket - 1 for each such hit.)
        Returns the logits."""
        toks = self._serve_tokens(req)
        if self.chunked_prefill:
            # Only a full hit comes here (a partial one gets a chunk plan).
            return self._read_only_chunk(slot, toks)
        return self._flash_prefill(slot, toks, resident)

    def _read_only_chunk(self, slot: int, toks):
        """The last token of `toks`, resident whole in row `slot`'s blocks,
        through the chunk kernel with ``store=False``: its logits, nothing
        written."""
        n = len(toks)
        self.prefill_tokens_computed += 1
        self.cache, logits = self.model.prefill_chunk(
            self._tier_views[self._slot_tier[slot]], self.cache, {
                "tokens": torch.from_numpy(toks[None, n - 1:].astype(np.int64)).to(
                    self.device),
                "lengths": [1], "start": n - 1, "slot": slot, "store": False,
                "blocks": torch.from_numpy(
                    self._block_tab[slot, :-(-n // self.block_size)].copy())})
        return logits

    def _flash_prefill(self, slot: int, toks, resident: int):
        """Whole-prompt admission's prefill of `toks` into row `slot`:
        cold (``resident`` 0), the whole of it solo, right-padded to the
        bucket, scattered into the row's pool blocks or contiguous row;
        after a prefix hit, ``prefill_suffix`` (the flash kernel over the
        gathered prefix ++ suffix) from the block boundary ``resident``,
        scattered into the row's fresh blocks, or on a full hit the last
        token alone, setting only the row's table. Returns the logits."""
        n = len(toks)
        bs = self.block_size
        view = self._tier_views[self._slot_tier[slot]]
        if not resident:
            L = self._bucketed(n)
            tokens = np.zeros((1, L), np.int64)
            tokens[0, :n] = toks
            solo, logits = self.model.prefill(view, {
                "tokens": torch.from_numpy(tokens).to(self.device),
                "lengths": torch.tensor([n], dtype=torch.int32)})
            if self.paged:
                self.prefill_tokens_computed += L
                # The scatter writes this row's device table too;
                # _table_dirty stays set so rows freed earlier sync.
                scatter_into_paged(self.cache, solo, slot, self._block_tab[slot])
            else:
                scatter_into_slot(self.cache, solo, slot)
            return logits
        start = min(resident, n - 1)
        ls = n - start
        Ls = self._bucketed(ls)
        self.prefill_tokens_computed += Ls
        tokens = np.zeros((1, Ls), np.int64)
        tokens[0, :ls] = toks[start:]
        kv = self.cache.kv
        batch = {
            "tokens": torch.from_numpy(tokens).to(self.device),
            "lengths": [ls],
            "start": start,
            "pool_k": kv.k,
            "pool_v": kv.v,
            "prefix_blocks": torch.from_numpy(self._block_tab[slot, :-(-start // bs)].copy()),
        }
        if kv.quantized:
            batch["pool_k_scale"] = kv.k_scale
            batch["pool_v_scale"] = kv.v_scale
        solo, logits = self.model.prefill_suffix(view, batch)
        if resident < n:
            # Below a full hit only whole blocks are shared: the suffix
            # starts exactly at the block boundary `resident`.
            scatter_suffix_into_paged(self.cache, solo, slot, self._block_tab[slot],
                                      resident // bs)
        else:
            set_paged_row(self.cache, solo, slot, self._block_tab[slot])
        return logits

    def _resume_tail(self, req: Request, slot: int, resident: int):
        """A preempted request's resume under whole-prompt admission: every
        position the pool no longer holds is recomputed by the function
        that computed it in the uninterrupted run. The prompt positions
        past `resident` go through whole-prompt prefill (the flash kernel,
        `_flash_prefill`), the generated ones through the chunk kernel,
        which is bitwise the decode step that wrote them (on the int8 pool
        the flash kernel reads dequantized values, where decode scores the
        codes and scales after: other bits). A resume resident whole runs
        its last token read-only. (The JAX scheduler prefills the whole
        served suffix through its suffix route.) Returns the logits of the
        last served token."""
        toks = self._serve_tokens(req)
        n, n_prompt = len(toks), len(req.prompt)
        if resident >= n:
            return self._read_only_chunk(slot, toks)
        start = resident
        if start < n_prompt:
            self._flash_prefill(slot, toks[:n_prompt], start)
            start = n_prompt
        while start < n:
            t = min(self.prefill_budget, n - start)
            logits = self._chunk_call(slot, toks, start, t)
            start += t
        return logits

    def _chunk_call(self, slot: int, toks, start: int, t: int):
        """Positions [start, start + t) of `toks` through the chunk kernel
        into row `slot`'s blocks, one `prefill_budget`-wide call at the
        slot's tier. Returns the logits of its last real token."""
        Lc = self.prefill_budget
        tokens = np.zeros((1, Lc), np.int64)
        tokens[0, :t] = toks[start:start + t]
        covering = -(-(start + t) // self.block_size)
        self.cache, logits = self.model.prefill_chunk(
            self._tier_views[self._slot_tier[slot]], self.cache, {
                "tokens": torch.from_numpy(tokens).to(self.device),
                "lengths": [t],
                "start": start,
                "slot": slot,
                "blocks": torch.from_numpy(self._block_tab[slot, :covering].copy()),
            })
        self.prefill_tokens_computed += Lc
        return logits

    def _admit_chunked(self, req: Request, slot: int, match) -> None:
        """Claim row `slot` as `_admit` does (reservation, hit claiming,
        prompt blocks) and enqueue a chunk plan from the first uncached
        position: below a full hit that is a block boundary, so no chunk
        writes a block shared with other rows. The slot stays masked out
        of decoding until its last chunk lands."""
        self._claim_tier(req, slot)
        self._claim_row(req, slot, match)
        self._pos_host[slot] = 0
        self._cur[slot, 0] = 0          # dummy decode input while prefilling
        self._slots[slot] = req
        toks = self._serve_tokens(req)
        self._chunk_plans[slot] = {"req": req, "next": match[1], "n": len(toks),
                                   "toks": toks}
        self._chunk_queue.append(slot)
        self._table_dirty = True

    def _run_chunk(self, slot: int) -> Optional[Request]:
        """Run one `prefill_budget`-token chunk of row `slot`'s plan and
        register the blocks it has fully landed. On the final chunk the
        slot graduates to decoding and samples its first token. Returns
        the request if it finished on that token."""
        plan = self._chunk_plans[slot]
        req, n, start = plan["req"], plan["n"], plan["next"]
        t = min(self.prefill_budget, n - start)
        logits = self._chunk_call(slot, plan["toks"], start, t)
        self.prefill_chunks_run += 1
        self.prefill_chunk_tokens += t
        plan["next"] = start + t
        if self.prefix_cache:
            # Blocks this chunk completed are final: a same-prefix request
            # admitted on a later step shares them.
            self._register_full(slot, limit=plan["next"] // self.block_size)
        if plan["next"] < n:
            return None
        del self._chunk_plans[slot]
        self._pos_host[slot] = n
        self._table_dirty = True       # unmask the row for the decode step
        return self._first_token(req, slot, logits)

    def _first_token(self, req: Request, slot: int, logits) -> Optional[Request]:
        """Sample the admission's token from its prefill logits and arm the
        slot's decode state. A resumed request keeps its earlier tokens and
        draws at step ``len(out_tokens)``, the stream index an
        uninterrupted run uses there, so a resume is bitwise even when
        sampling. Returns the request if it finished on that token."""
        step0 = len(req.out_tokens or ())
        key = sampling.request_key(self.seed, req.rid)
        tok = int(sampling.sample_tokens(
            logits[:, -1, :], [req.temperature], [req.top_k], key[None], [step0])[0])
        self._cur[slot, 0] = tok
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._keys[slot] = key
        self._steps[slot] = step0 + 1
        if req.out_tokens:
            req.out_tokens.append(tok)      # resumed: extend, do not reset
        else:
            req.out_tokens = [tok]
        if req.t_first is None:
            req.t_first = self._now()
        self._emit(req, tok)
        if self._finished(req, tok):
            self._release_slot(slot)
            return req
        return None

    def _emit(self, req: Request, tok: int) -> None:
        """Count the token and stream it to the request's and the
        scheduler's ``on_token`` callbacks. They are user code: one that
        raises fails only this request (``_finished`` then retires it at
        the caller), never the step. The ``callback`` fault seam draws only
        when there is a callback to call."""
        self.tokens_emitted += 1
        self.tier_counters[req._tier_key]["tokens"] += 1
        callbacks = [cb for cb in (req.on_token, self.on_token) if cb is not None]
        if not callbacks:
            return
        try:
            if self.chaos is not None and self.chaos.fire("callback"):
                raise InjectedFault("on_token callback")
            for cb in callbacks:
                cb(req, tok)
        except Exception as e:  # noqa: BLE001 — contain user-code faults
            self.callback_errors += 1
            req.error = f"on_token callback raised: {e!r}"

    @staticmethod
    def _finished(req: Request, tok: int) -> bool:
        return (req.failed or len(req.out_tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    # -- self-speculative decoding -----------------------------------------

    def _spec_phase(self) -> List[Request]:
        """One speculation round: draft up to ``speculate`` tokens per
        eligible slot with the plane-truncated view params (draft K/V lands
        in the row's own pool blocks), then verify the slots' ``[current
        token, drafts]`` windows in one full-policy multi-row chunk call and
        emit each slot's longest matching prefix.

        Eligibility: greedy slots only (acceptance compares argmaxes), not
        mid-chunk-plan, at a tier whose weight bits lie above the draft's
        (a w2 slot has nothing cheaper than itself to draft with), and at
        least 2 tokens still owed (with 1 owed the trailing decode is
        cheaper than draft + verify). Verify runs one call per tier group,
        at that tier's view.

        Rollback is a metadata write: verification recomputes all k+1
        positions at the full policy — its K/V overwrites the draft's bytes
        in place — so rejecting a tail only restores ``pos``/``length`` to
        the accepted frontier (:func:`set_decode_positions`). Every
        speculative write lands at a position >= the prompt length, inside
        blocks the round made private first (:meth:`_alloc_blocks_through`),
        so shared prefix blocks are never touched. Returns the requests
        that finished in the round."""
        spec: Dict[int, int] = {}       # slot -> draft count this round
        for b, req in enumerate(self._slots):
            if req is None or b in self._chunk_plans or req.temperature > 0:
                continue
            tier = self._slot_tier[b]
            if tier is not None and self._tier_cfgs[tier].w_bits <= self._draft_bits:
                continue
            k_eff = min(self.speculate, req.max_new_tokens - len(req.out_tokens) - 1)
            if k_eff >= 1:
                spec[b] = k_eff
        if not spec:
            return []
        # Back every position the round writes — drafts at [pos, pos+k) and
        # the verify chunk at [pos, pos+k] — before any kernel runs; all of
        # them sit inside the row's admission reservation.
        for b, k_eff in spec.items():
            self._alloc_blocks_through(b, int(self._pos_host[b]) + k_eff)
        self._push_spec_table(set(spec))

        # Lockstep draft: every speculating row advances one token per
        # iteration through the ordinary decode step with the view params.
        # Rows that reach their own draft count are masked out again (their
        # surplus writes would overrun the blocks backed above).
        active = set(spec)
        drafts: Dict[int, List[int]] = {b: [] for b in spec}
        cur = self._cur.copy()
        for _ in range(max(spec.values())):
            todo = {b for b in active if len(drafts[b]) < spec[b]}
            if todo != active:
                active = todo
                self._push_spec_table(active)
            logits = self._decode_call(self._draft_params,
                                       torch.from_numpy(cur).to(self.device))
            toks = logits[:, -1, :].to(torch.float32).argmax(dim=-1).cpu().numpy()
            for b in active:
                drafts[b].append(int(toks[b]))
                cur[b, 0] = int(toks[b])

        # Verify: one multi-row call per tier group, at the group's view,
        # over its rows' windows [current token, d_1 .. d_k]; position i's
        # argmax is the token sequential greedy decode would emit there.
        finished: List[Request] = []
        Lc = self.speculate + 1
        R = self.max_batch
        vgroups: Dict[Optional[str], List[int]] = {}
        for b in spec:
            vgroups.setdefault(self._slot_tier[b], []).append(b)
        for tkey in sorted(vgroups, key=lambda k: (k is not None, k or "")):
            slots_g = vgroups[tkey]
            nbp = min(self._max_blocks, max(
                -(-(int(self._pos_host[b]) + spec[b] + 1) // self.block_size)
                for b in slots_g))
            tokens = np.zeros((R, Lc), np.int64)
            lengths = np.zeros((R,), np.int32)
            starts = np.zeros((R,), np.int32)
            slot_ids = np.full((R,), -1, np.int32)
            btab = np.full((R, nbp), -1, np.int32)
            for b in slots_g:
                t = spec[b] + 1
                tokens[b, 0] = self._cur[b, 0]
                tokens[b, 1:t] = drafts[b]
                lengths[b] = t
                starts[b] = int(self._pos_host[b])
                slot_ids[b] = b
                btab[b] = self._block_tab[b, :nbp]
            self.cache, logits = self.model.prefill_chunk_logits_multi(
                self._tier_views[tkey], self.cache, {
                    "tokens": torch.from_numpy(tokens).to(self.device),
                    "lengths": lengths, "starts": starts, "slots": slot_ids,
                    "blocks": torch.from_numpy(btab)})
            self.spec_verify_calls += 1
            self.spec_verify_rows += len(slots_g)
            lg = logits.argmax(dim=-1).cpu().numpy()
            tc = self.tier_counters[tkey]
            for b in slots_g:
                k_eff = spec[b]
                req = self._slots[b]
                p = int(self._pos_host[b])
                emitted = greedy_accept(lg[b, :k_eff + 1], drafts[b])
                self.spec_draft_tokens += k_eff
                self.spec_accepted_tokens += len(emitted) - 1
                tc["spec_draft_tokens"] += k_eff
                tc["spec_accepted_tokens"] += len(emitted) - 1
                req.spec_drafted += k_eff
                req.spec_accepted += len(emitted) - 1
                m, done = 0, False
                for tok in emitted:
                    req.out_tokens.append(tok)
                    self._emit(req, tok)
                    m += 1
                    if self._finished(req, tok):
                        done = True
                        break
                self._pos_host[b] = p + m
                self._steps[b] += m
                if done:
                    self._release_slot(b)
                    finished.append(req)
                else:
                    self._cur[b, 0] = emitted[m - 1]
        # Roll every row back to its accepted frontier in one write. Other
        # rows are safe to overwrite: a chunk plan's next chunk sets its own
        # row, free rows sit behind an all -1 table, and live decoders'
        # device positions equal _pos_host before the round began.
        set_decode_positions(self.cache, self._pos_host, self._pos_host)
        self._table_dirty = True       # the real table goes back before decode
        self.spec_rounds += 1
        return finished

    # -- the decode loop ----------------------------------------------------

    def _decode_tier_groups(self, groups: Dict[Optional[str], List[int]],
                            cur: torch.Tensor) -> torch.Tensor:
        """Mixed-tier decode: one decode call per tier group (sorted as in
        JAX), each with the group's view params and every other row masked
        to -1 in the device table (its writes go to the trash block and it
        attends over nothing; :meth:`_push_spec_table`). A row's logits
        depend on its own row alone, so a group call computes for its rows
        what an engine serving only that tier computes.

        Each decode call advances every row's device pos/length by one, so
        before each later call they are reset to the pre-decode frontier,
        and after the last set to frontier + 1: the state one decode call
        leaves (one :func:`set_decode_positions` write each). Returns the
        (B, V) last-position logits, each row from its group's call,
        assembled on the device."""
        pos0 = self._pos_host.copy()
        out = None
        for i, key in enumerate(sorted(groups, key=lambda k: (k is not None, k or ""))):
            if i:
                set_decode_positions(self.cache, pos0, pos0)
            self._push_spec_table(set(groups[key]))
            logits = self._decode_call(self._tier_views[key], cur)
            self.tier_counters[key]["decode_calls"] += 1
            last = logits[:, -1, :]
            if out is None:
                out = torch.zeros_like(last)
            rows = torch.tensor(groups[key], dtype=torch.int64, device=last.device)
            out.index_copy_(0, rows, last.index_select(0, rows))
        set_decode_positions(self.cache, pos0 + 1, pos0 + 1)
        self._table_dirty = True       # the real table goes back next step
        return out

    def step(self) -> List[Request]:
        """One scheduler step: process cancellations and deadline expiries,
        admit waiting requests into free slots (at most one new chunk plan
        per step; solo, suffix and full-hit admissions into every free
        slot), run one budgeted prefill chunk, then a speculation round
        (with ``speculate``) and one batched decode (one call per tier
        group), retire rows whose logits are non-finite, sample, and retire
        finished slots.
        When the pool cannot cover the head's revive + reservation draw (a
        pool-pressure event), the step may preempt one victim for it, or
        admit a later request past it (the bounded bypass); otherwise the
        head waits. Returns the requests that finished this step (including
        rejected, cancelled, expired and failed ones, which carry
        ``error``)."""
        self._step_calls += 1
        finished: List[Request] = self._lifecycle_phase()
        pressure = chunk_admitted = preempted = False
        admitted_now: set = set()
        free = collections.deque(
            b for b in range(self.max_batch) if self._slots[b] is None)
        deg = self.degrade and self._pressure_streak >= self.degrade_after
        while free and self.waiting and not chunk_admitted:
            slot = free[0]
            head = self.waiting[0]
            reason = self._reject_reason(head)
            if reason is not None:
                self.waiting.popleft()
                self._fail(head, reason)
                finished.append(head)
                continue
            idx = 0
            was_degraded = self._degrade_tier(head) if deg else False
            match = self._match_prefix(head) if self.paged else None
            if self.paged:
                short = match[2] + match[3] > self._avail
                if not short and self.chaos is not None and self.chaos.fire("alloc"):
                    short = True        # an injected reservation failure
                if short:
                    pressure = True
                    self.pool_pressure_events += 1
                    shortfall = match[2] + match[3] - self._avail
                    # (1) Preempt one victim a step, never for a head that
                    # was itself preempted (no ping-pong).
                    if self.preempt and not preempted and head.preemptions == 0:
                        victim = self._pick_victim(shortfall, admitted_now)
                        if victim is not None:
                            self._preempt(victim)
                            preempted = True
                            free.append(victim)
                            continue    # the head again, against the freed blocks
                    # (2) The bounded bypass of the blocked head.
                    idx, match, was_degraded = self._bypass_candidate(deg)
                    if idx is None:
                        break           # the head keeps FIFO priority: wait
                    self.head_bypasses += 1
                    self._head_bypass += 1
            req = self.waiting[idx]
            del self.waiting[idx]
            if idx == 0:
                self._head_bypass = 0   # the head itself admits
            if was_degraded and req.degraded_to is None:
                req.degraded_to = req._tier_key
                self.degraded_requests += 1
            if self.chunked_prefill and match[1] < self._serve_len(req):
                # An uncached tail gets a chunk plan, one per step: a
                # same-prefix follower admitted now would match an index
                # this plan has not written yet; admitted next step, it
                # hits the blocks the plan has landed by then. (A full hit
                # writes nothing and admits at once.)
                self._admit_chunked(req, slot, match)
                admitted_now.add(slot)
                chunk_admitted = True
                free.popleft()
                continue
            done = self._admit(req, slot, match)
            if done is not None:
                finished.append(done)   # finished on its first token: the
                continue                # slot is free again this step
            admitted_now.add(slot)
            free.popleft()
        self._pressure_streak = self._pressure_streak + 1 if pressure else 0
        self.queue_wait_steps += len(self.waiting)

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
        if self.speculate:
            # A speculation round stands in for several sequential decode
            # steps of the greedy slots; survivors still join the decode
            # below, which is exactly their next sequential step.
            finished.extend(self._spec_phase())
            decoding = [b for b, r in enumerate(self._slots)
                        if r is not None and b not in self._chunk_plans]
            if not decoding:
                return finished         # every live slot retired in the round
        if chunk_ran:
            self.decode_steps_stalled += 1
        if self.paged:
            self._alloc_boundary_blocks()
            self._sync_table()
        cur = torch.from_numpy(self._cur).to(self.device)
        groups: Dict[Optional[str], List[int]] = {}
        for b in decoding:
            groups.setdefault(self._slot_tier[b], []).append(b)
        if len(groups) == 1:
            # Homogeneous batch (the untiered engine included): one call at
            # the group's view, what an engine serving only this tier runs.
            key = next(iter(groups))
            last = self._decode_call(self._tier_views[key], cur)[:, -1, :]
            self.tier_counters[key]["decode_calls"] += 1
        else:
            last = self._decode_tier_groups(groups, cur)
        if self.chaos is not None and self.chaos.fire("nan"):
            # Poison one live row's logits: the detector below must fail
            # that request alone.
            last = last.clone()
            last[decoding[self.chaos.pick(len(decoding))]] = float("nan")
        # The always-on detector: a row with a non-finite logit cannot
        # sample a meaningful token, so its request retires with
        # error="nan-logits" (its K/V writes this step were its own row's).
        # The mask is computed on the device and comes back with the
        # sampled tokens in one copy.
        toks = sampling.sample_tokens(last, self._temps, self._top_ks, self._keys,
                                      self._steps)
        bad = ~torch.isfinite(last).all(dim=-1)
        toks, bad = torch.stack([toks.to(torch.int64), bad.to(torch.int64)]).cpu().numpy()
        self._steps += 1
        self.steps_run += 1
        for b in decoding:
            if bad[b]:
                self.nan_logit_events += 1
                finished.append(self._retire_abnormal(b, "nan-logits"))
        for b in decoding:
            req = self._slots[b]
            if req is None:
                continue                # retired by the detector
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
