"""Serving CLI: initialize a model from a seed, pack its weights, and
serve a stream of synthetic requests, as a static batch or through the
continuous scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --policy "w4a8;wo=w8a8" [--static | --continuous] [--kv-int8] \
      [--requests 8] [--max-new 16] [--max-batch 4] [--rate 20] \
      [--block-size 16] [--pool-blocks N] [--no-paged] \
      [--prefix-cache | --no-prefix-cache] [--shared-prefix N] \
      [--prefill-budget 32] [--no-chunked-prefill] \
      [--speculate K] [--draft-policy w4a8] [--tiers w8a8,w4a8,w2a8] \
      [--deadline-ms MS] [--no-preempt] [--victim-policy most-blocks] \
      [--degrade] [--chaos-seed S] [--chaos-rate 0.05] \
      [--chaos-max-faults N] [--host-pool-bytes N] [--index FILE] \
      [--backend cuda|reference] [--plans FILE] [--reduced] [--layers N] \
      [--ckpt DIR] [--device cpu]

Port of ``repro.launch.serve`` for the flags above; it prints what the
JAX serve CLI prints for them. It runs on CUDA unless ``--device cpu`` is
given, serving with the hand-written kernels on the card and their plain
PyTorch versions on the CPU. --quant applies one uniform QuantConfig;
--policy is a per-layer PrecisionPolicy spec matched against parameter
paths (a wXaYrZZ token packs Table III mixed-group layers).
``--arch`` is olmo-1b, nemotron-4-15b, nemotron-4-340b, stablelm-12b
(qk-norm), mixtral-8x22b, llama4-maverick-400b-a17b, rwkv6-3b or
recurrentgemma-9b. paligemma-3b and hubert-xlarge exit before any
weights are drawn: an encoder has no decode step (the JAX package's
words), and the serving stack passes no patch embeddings to the VLM
(JAX's serve fails there with a KeyError); both run through the model
API (``models.build_model``). ``--arch rwkv6-3b`` serves the RWKV-6 family
unquantized (as the JAX package does; --policy/--quant raise), on its
constant-size recurrent state: static, or --continuous with solo
whole-prompt admission. ``--arch recurrentgemma-9b`` serves the Griffin
hybrid the same way (unquantized, static or --continuous with solo
whole-prompt admission) on its recurrent states and window-sized ring KV
caches; --kv-int8 leaves the rings in bf16, as the JAX package does.
The MoE archs (mixtral-8x22b, top-2 of 8 experts under a 4096-token
sliding window; llama4-maverick-400b-a17b, top-1 of 128) route each
token through capacity-bounded expert buffers, so a row's output depends
on its batch: they serve static, or --continuous with solo whole-prompt
admission (no chunked prefill, prefix cache or --speculate, as in JAX),
mixtral on its window-sized ring (bf16, or int8 under --kv-int8) and
llama4 on the paged pool. --layers N serves the config's first N layers
(every width unchanged): a cut of depth for quick runs at full width,
and what fits one card for the largest archs (mixtral-8x22b at 4 of 56
layers, llama4-maverick at 1 of 48, nemotron-4-340b at 2 of 96). --ckpt DIR serves the newest
checkpoint there (``launch.train --ckpt``, or the JAX trainer's: one
format) instead of weights drawn from a seed; the flags that shape the
model (--arch, --reduced, --layers) must match the trained ones.

--backend selects the kernel registry's backend for the run: ``cuda``
(the hand-written kernels, CUDA tensors only) or ``reference`` (the
plain PyTorch versions, which needs --device cpu); without it the
backend follows the device. --plans FILE persists the registry's block
plans (the matmul kernels' tiles and K splits, none changing a bit):
loaded before serving if the file exists, saved back on exit, in the
JAX package's schema.

Without --continuous (or with --static) the engine serves static batches
of --max-batch requests: whole-prompt prefill, then a decode loop on the
contiguous cache. --continuous serves through the continuous-batching
scheduler: on the paged KV pool with chunked prefill (--prefill-budget
prompt tokens per step) by default, with solo whole-prompt admission
under --no-chunked-prefill, on the contiguous per-slot cache under
--no-paged. One warmup pass runs first, so steady-state throughput and
throughput including the warmup are reported separately.

Cross-request prefix caching is on by default whenever the pool is
paged: prompts sharing a prefix — --shared-prefix N prepends a common
N-token prompt to every synthetic request — reuse each other's resident
prompt blocks (refcounted, copied on write), and admission prefills only
the uncached suffix, bitwise a cold prefill. --no-prefix-cache turns it
off, --prefix-cache forces it on (and raises where it cannot be). The
engine keeps its scheduler, so the timed pass of a paged continuous run
admits from whatever blocks of the warmup pass the pool still holds:
all of them where the pool is large enough or the prompts share a
prefix, few where the LRU evicted them first. Its tok/s includes that
mix of hits and evictions; the hit rate and evictions are reported after
a continuous run.

Self-speculative decoding: --speculate K drafts K tokens per scheduler
step from a plane-truncated view of the resident packed weights (the
draft reads only the top bit-planes — no second weight copy) and
verifies all K+1 positions in one chunk-shaped full-policy call,
emitting the longest matching prefix. Greedy requests' tokens are
bitwise identical to --speculate 0; sampled requests decode normally.
--draft-policy picks the draft precision (w4a8 / w2a8 — the plane
subset to keep). It needs --continuous, a quant policy (--quant /
--policy) and the paged pool; anything else raises. Draft/acceptance
counters are reported after the run.

Per-request precision tiers: --tiers "w8a8,w4a8,w2a8" assigns the
synthetic requests a tier round-robin, all served from the one packed
weight set inside the same continuous batch: a tier is a plane-truncated
view of the stored weights, and the scheduler runs one decode call per
tier group per step. A request served at tier T emits the greedy tokens
an engine serving only tier T emits. It composes with --speculate (the
draft must sit strictly below a slot's tier) and with the prefix cache
(digests are tier-scoped). It needs --continuous and a quant policy;
per-tier counters are reported after the run.

--deadline-ms gives every synthetic request a wall-clock deadline: one
not finished that many ms after its arrival retires with
error="deadline", its blocks freed like any retirement.

Pool pressure: when --pool-blocks leaves the pool short for the queue
head, the scheduler preempts one live victim a step (--victim-policy
most-blocks, lowest-tier, latest-deadline or block-to-host; --no-preempt
queues instead), requeues it as prompt ++ generated and resumes it warm
from its registered blocks, bitwise the uninterrupted stream; a smaller request
may admit past the blocked head at most 4 times in a row. --degrade
(needs --tiers) admits under sustained pressure at the lowest tier.
--chaos-seed arms the seeded fault injector at its four seams (alloc,
kernel, nan, callback) with per-visit rate --chaos-rate, at most
--chaos-max-faults faults. A lifecycle line reports deadline misses,
cancellations, pressure events, preemptions, bypasses and degraded
admissions when a request failed or any of the first four happened, and
a chaos line the faults fired and what survived them.

Host-RAM block tier: --host-pool-bytes N puts a host store of N bytes
under the paged pool. Prefix blocks the pool evicts move there instead
of dying, and a prefix hit on a host-resident chain swaps them back into
free pool blocks before admission: a warm-from-host stream's greedy
tokens are bitwise the cold stream's. --victim-policy block-to-host
spills a preempted victim's blocks there at once, so it resumes warm
even when the pool reclaims its blocks before its turn. --index FILE
persists the prefix index (digest chains and block bytes, the JAX
package's format): loaded into the host tier at start-up if the file
exists, saved back at exit, so a restarted server serves a repeated
prefix warm from host. A host-tier line reports the swaps and host hits.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="olmo-1b, nemotron-4-15b, nemotron-4-340b, stablelm-12b, "
                         "mixtral-8x22b, llama4-maverick-400b-a17b, rwkv6-3b or "
                         "recurrentgemma-9b (paligemma-3b and hubert-xlarge "
                         "are refused: the model API serves them)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the config's first N layers (widths unchanged)")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--policy", default=None,
                    help="per-layer precision spec, e.g. 'w4a8;wo=w8a8'")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--continuous", action="store_true",
                    help="serve via the continuous-batching scheduler")
    ap.add_argument("--static", action="store_true",
                    help="serve static batches (the default without "
                         "--continuous)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s (0 = all "
                         "requests queued at t=0)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV cache block size (tokens per block)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="shared KV pool size in blocks (default: the "
                         "contiguous worst case max_batch * max_ctx)")
    ap.add_argument("--no-paged", action="store_true",
                    help="continuous scheduler on the contiguous per-slot "
                         "max_ctx cache instead of the paged pool")
    ap.add_argument("--prefix-cache", dest="prefix_cache", action="store_true",
                    default=None,
                    help="force cross-request prefix caching on (default: on "
                         "whenever the pool is paged)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache", action="store_false",
                    help="disable cross-request prefix caching")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common N-token prompt to every synthetic "
                         "request (exercises the prefix cache)")
    ap.add_argument("--prefill-budget", type=int, default=32,
                    help="chunked prefill: max prompt tokens prefilled per "
                         "scheduler step (the decode-stall bound)")
    ap.add_argument("--no-chunked-prefill", dest="chunked_prefill",
                    action="store_false", default=None,
                    help="admit by solo whole-prompt prefill instead of "
                         "chunked prefill")
    ap.add_argument("--speculate", type=int, default=0,
                    help="self-speculative decoding: draft tokens per "
                         "scheduler step from the plane-truncated view "
                         "of the packed weights (0 = off; greedy "
                         "requests only, needs --quant/--policy)")
    ap.add_argument("--draft-policy", default="w4a8",
                    help="draft precision for --speculate: the plane "
                         "subset of the resident weights the draft "
                         "contracts (e.g. w4a8, w2a8)")
    ap.add_argument("--tiers", default=None,
                    help="per-request precision tiers, e.g. "
                         "'w8a8,w4a8,w2a8': requests are assigned a tier "
                         "round-robin and served through plane-truncated "
                         "views of the one packed weight set inside the "
                         "same continuous batch (needs --continuous and "
                         "--quant/--policy)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request wall-clock deadline: requests not "
                         "finished this many ms after arrival retire "
                         "with error='deadline'")
    ap.add_argument("--no-preempt", dest="preempt", action="store_false",
                    default=None,
                    help="never preempt a live slot under pool pressure "
                         "(queue instead; default: preempt on the paged "
                         "pool, resume warm from prefix-cached blocks)")
    ap.add_argument("--victim-policy", default="most-blocks",
                    choices=("most-blocks", "lowest-tier", "latest-deadline",
                             "block-to-host"),
                    help="which live slot pool-pressure preemption evicts "
                         "(block-to-host picks like most-blocks and spills "
                         "the victim's blocks to the host tier; needs "
                         "--host-pool-bytes)")
    ap.add_argument("--degrade", action="store_true",
                    help="under sustained pool pressure admit new requests "
                         "at the lowest precision tier (needs --tiers; "
                         "sticky for the request's life)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="arm the seeded fault injector (alloc/kernel/nan/"
                         "callback seams) with this seed")
    ap.add_argument("--chaos-rate", type=float, default=0.05,
                    help="per-seam-visit fault probability when "
                         "--chaos-seed is set")
    ap.add_argument("--chaos-max-faults", type=int, default=None,
                    help="cap total injected faults (default unbounded)")
    ap.add_argument("--host-pool-bytes", type=int, default=0,
                    help="host-RAM block tier budget in bytes (0 = off): "
                         "evicted prefix blocks move to a pinned host store "
                         "and swap back bitwise on a prefix hit")
    ap.add_argument("--index", default=None,
                    help="prefix-index JSON (digest chains and block bytes): "
                         "loaded into the host tier at start-up if it "
                         "exists, saved back at exit (needs "
                         "--host-pool-bytes)")
    ap.add_argument("--backend", default=None, choices=("cuda", "reference"),
                    help="kernel backend: the CUDA kernels, or the plain "
                         "PyTorch versions (needs --device cpu); default: "
                         "the device's own")
    ap.add_argument("--plans", default=None,
                    help="block-plan cache JSON: loaded at startup if it "
                         "exists, saved back (with any new plans) on exit")
    ap.add_argument("--ckpt", default=None,
                    help="serve the newest checkpoint in this directory (a "
                         "TrainState written by either package's trainer) "
                         "instead of seeded weights")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def synthetic_requests(cfg, args) -> list:
    """The JAX serve CLI's request stream: prompts of 8-12 random tokens
    after a common --shared-prefix prompt, greedy and temperature-0.7
    requests alternating, Poisson arrivals at --rate. Every call
    reproduces the same stream."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, args.shared_prefix)
    reqs = [Request(rid=i,
                    prompt=np.concatenate([
                        shared, rng.integers(0, cfg.vocab, 8 + (i % 5))]).astype(np.int64),
                    max_new_tokens=args.max_new,
                    temperature=0.0 if i % 2 == 0 else 0.7)
            for i in range(args.requests)]
    if args.rate > 0:
        t = 0.0
        for r in reqs:
            r.arrival_time = t
            t += float(rng.exponential(1.0 / args.rate))
    return reqs


def assign_lifecycle(reqs, args) -> list:
    """Give the requests their --tiers tier, round-robin by position, and
    the --deadline-ms deadline, as the JAX serve CLI does (requests keep
    their own where neither flag is given). Returns `reqs`."""
    tier_list = args.tiers.split(",") if args.tiers else None
    for i, r in enumerate(reqs):
        if tier_list:
            r.tier = tier_list[i % len(tier_list)]
        if args.deadline_ms:
            r.deadline_s = args.deadline_ms / 1e3
    return reqs


def run(args, make_requests: Optional[Callable[[object, object], List]] = None,
        params=None):
    """Build the engine for `args` and serve `make_requests(cfg, args)`,
    with --tiers and --deadline-ms applied, twice (warmup, then timed);
    with --index, load the prefix index first (if the file exists) and
    save it after; with --plans, likewise the kernel registry's block
    plans; with --backend, serve under that backend. Returns (engine,
    done, report dict)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels.registry import get_registry

    if args.index and not args.host_pool_bytes:
        raise SystemExit("--index persists blocks into the host tier; "
                         "add --host-pool-bytes")
    if args.victim_policy == "block-to-host" and not args.host_pool_bytes:
        raise SystemExit("--victim-policy block-to-host spills to the host "
                         "tier; add --host-pool-bytes")
    if args.continuous and args.static:
        raise SystemExit("--continuous and --static are mutually exclusive")
    if args.quant and args.policy:
        raise SystemExit("--quant and --policy are mutually exclusive")
    if args.speculate and not args.continuous:
        raise SystemExit("--speculate runs inside the continuous "
                         "scheduler; add --continuous")
    if args.speculate and not (args.quant or args.policy):
        raise SystemExit("--speculate drafts from the resident bit-plane "
                         "weights; add a quant policy (e.g. --quant w8a8)")
    if args.tiers and not args.continuous:
        raise SystemExit("--tiers groups slots inside the continuous "
                         "scheduler; add --continuous")
    if args.tiers and not (args.quant or args.policy):
        raise SystemExit("--tiers serves plane-truncated views of packed "
                         "weights; add a quant policy (e.g. --quant w8a8)")
    if args.degrade and not args.tiers:
        raise SystemExit("--degrade lowers admissions to the floor tier; "
                         "add --tiers")
    want = {"reference": "cpu", "cuda": "cuda"}.get(args.backend)
    if want and torch.device(args.device or "cuda").type != want:
        raise SystemExit(f"--backend {args.backend} runs on {want} tensors; the "
                         f"device is {args.device or 'cuda'} (add --device {want})")
    device = resolve_device(args.device)
    with get_registry().use(args.backend) if args.backend else contextlib.nullcontext():
        return _serve(args, device, make_requests, params)


def restore_params(cfg, ckpt: str, device):
    """The params of the newest checkpoint in `ckpt`, restored as a
    TrainState (default TrainConfig: no error-feedback leaves) onto
    `device`; prints the step, as JAX's serve does."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_train_state

    model = build_model(cfg)
    state, _, step = CheckpointManager(ckpt).restore(
        lambda: init_train_state(model.init(seed=0, device="meta"), TrainConfig()),
        device=device)
    print(f"restored checkpoint step {step}")
    return state.params


def _serve(args, device, make_requests, params):
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core.precision import parse_policy_spec, parse_quant_token
    from repro_torch.kernels.registry import get_registry
    from repro_torch.models import build_model
    from repro_torch.models.model_zoo import check_policy
    from repro_torch.serving import FaultInjector, ServingEngine

    if args.plans and os.path.exists(args.plans):
        n = get_registry().load_plans(args.plans)
        print(f"loaded {n} block plans from {args.plans}")
    make_requests = make_requests or synthetic_requests
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    if cfg.frontend == "patch_stub":
        raise SystemExit(f"{cfg.name}: the serving stack passes no patches (the JAX "
                         "package's serve fails on it with KeyError: 'patches'); "
                         "drive the VLM through build_model(cfg).prefill with "
                         "batch['patches'] and decode_step")
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.num_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has {cfg.num_layers} layers")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    quant = None
    if args.policy:
        quant = parse_policy_spec(args.policy)
    elif args.quant and args.quant != "none":
        quant = parse_quant_token(args.quant)
    try:
        check_policy(cfg, quant)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.policy:
        print(f"precision policy: {quant.describe()}")
    # --kv-int8 is accepted for every arch; a recurrent state ignores it,
    # and so does griffin's ring cache (kept in the model dtype, as in JAX).
    cfg = dataclasses.replace(cfg, kv_cache_quant=args.kv_int8)
    if params is None and args.ckpt:
        params = restore_params(cfg, args.ckpt, device)
    elif params is None:
        params = build_model(cfg).init(seed=0, device=device)
        print("serving randomly initialized weights (no --ckpt)")
    chaos = None
    if args.chaos_seed is not None:
        p = args.chaos_rate
        chaos = FaultInjector(args.chaos_seed, p_alloc=p, p_kernel=p, p_nan=p,
                              p_callback=p, max_faults=args.chaos_max_faults)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch, quant=quant,
                           bucket=32, paged=False if args.no_paged else None,
                           block_size=args.block_size,
                           pool_blocks=args.pool_blocks,
                           prefix_cache=args.prefix_cache,
                           chunked_prefill=args.chunked_prefill,
                           prefill_budget=args.prefill_budget,
                           speculate=args.speculate,
                           draft_policy=args.draft_policy, tiers=args.tiers,
                           preempt=args.preempt, victim_policy=args.victim_policy,
                           degrade=args.degrade, chaos=chaos,
                           host_pool_bytes=args.host_pool_bytes, device=device)
    if args.index and os.path.exists(args.index):
        n = engine.load_index(args.index)
        print(f"loaded {n} prefix digests from {args.index}")
    serve = engine.generate if args.continuous else engine.generate_static

    def stream():
        return assign_lifecycle(make_requests(cfg, args), args)

    def sync():
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    warm = serve(stream())
    sync()
    t_warm = time.perf_counter() - t0

    reqs = stream()                       # identical stream, warm caches
    t1 = time.perf_counter()
    done = serve(reqs)
    sync()
    dt = time.perf_counter() - t1
    total = sum(len(r.out_tokens or ()) for r in done)
    mode = "continuous" if args.continuous else "static"
    print(f"{len(done)} requests, {total} tokens, {dt:.1f}s [{mode}]")
    print(f"  steady-state: {total/dt:.1f} tok/s | "
          f"total incl. compile: {total/(t_warm + dt):.1f} tok/s "
          f"(warmup {t_warm:.1f}s)")
    stats = None
    if args.continuous:
        lat = [r.t_done - r.arrival_time for r in done if r.t_done is not None]
        print(f"  mean request latency: {np.mean(lat)*1e3:.0f} ms "
              f"(rate={args.rate or 'inf'}/s)")
        stats = engine.pool_stats()
        if stats["paged"]:
            print(f"  paged KV pool: {stats['peak_allocated_blocks']}/"
                  f"{stats['pool_blocks']} blocks peak "
                  f"(block_size={stats['block_size']}) — peak resident "
                  f"{stats['peak_resident_kv_bytes']/1e6:.2f} MB vs "
                  f"{stats['reserved_kv_bytes']/1e6:.2f} MB contiguous "
                  "reservation")
            if stats["prefix_cache"]:
                print(f"  prefix cache: {stats['prefix_hit_rate']:.0%} of "
                      f"prompt tokens served from resident blocks "
                      f"({stats['prefix_hit_blocks']} block hits, "
                      f"{stats['cow_copies']} CoW copies, "
                      f"{stats['prefix_evictions']} evictions, "
                      f"{stats['retained_prefix_blocks']} retained)")
            if stats["host_tier"]:
                print(f"  host tier: {stats['host_hit_rate']:.0%} of prompt "
                      f"tokens served warm-from-host "
                      f"({stats['host_hit_blocks']} block hits, "
                      f"{stats['swap_outs']} swap-outs, "
                      f"{stats['swap_ins']} swap-ins, "
                      f"{stats['host_blocks']} resident / "
                      f"{stats['host_bytes']/1e6:.2f} MB of "
                      f"{stats['host_pool_bytes']/1e6:.2f} MB budget, "
                      f"{stats['host_evictions']} host evictions)")
        else:
            what = {"ssm": "recurrent state",
                    "hybrid": "ring KV cache + recurrent state"}.get(
                        cfg.family, "contiguous KV cache")
            print(f"  {what}: {stats['resident_kv_bytes']/1e6:.2f} MB resident "
                  "(full per-slot reservation)")
        if stats["chunked_prefill"]:
            print(f"  chunked prefill: {stats['prefill_chunks_run']} "
                  f"chunks (budget={stats['prefill_budget']}), "
                  f"{stats['decode_steps_stalled']} decode steps "
                  f"shared a step with a chunk, "
                  f"{stats['prefill_tokens_per_step']:.1f} prefill tok/step")
        if stats.get("speculate"):
            print(f"  speculative decode: k={stats['speculate']}, "
                  f"{stats['spec_accepted_tokens']}/"
                  f"{stats['spec_draft_tokens']} drafts accepted "
                  f"({stats['spec_acceptance_rate']:.0%}) over "
                  f"{stats['spec_rounds']} rounds, "
                  f"{stats['spec_verify_rows']} rows in "
                  f"{stats['spec_verify_calls']} verify calls")
        if stats.get("tier_serving"):
            print("  precision tiers:")
            for name, tc in stats["tiers"].items():
                if not tc["requests"]:
                    continue
                line = (f"    {name}: {tc['requests']} requests, "
                        f"{tc['tokens']} tokens, "
                        f"{tc['decode_calls']} decode calls")
                if tc["spec_draft_tokens"]:
                    line += (f", {tc['spec_accepted_tokens']}/"
                             f"{tc['spec_draft_tokens']} drafts accepted "
                             f"({tc['spec_acceptance_rate']:.0%})")
                print(line)
        failed = [r for r in done if r.error]
        if (failed or stats["preemptions"] or stats["deadline_misses"]
                or stats["pool_pressure_events"]):
            print(f"  lifecycle: {stats['deadline_misses']} deadline misses, "
                  f"{stats['cancellations']} cancellations, "
                  f"{stats['pool_pressure_events']} pressure events, "
                  f"{stats['callback_errors']} callback errors, "
                  f"{stats['preemptions']} preemptions "
                  f"(policy={stats['victim_policy']}), "
                  f"{stats['head_bypasses']} head-of-line bypasses, "
                  f"{stats['degraded_requests']} degraded admissions")
        if stats["chaos"]:
            ch = stats["chaos"]
            fired = ", ".join(f"{k}={v}" for k, v in ch["fired"].items())
            print(f"  chaos: seed={ch['seed']} {ch['total_fired']} faults fired "
                  f"({fired}); {stats['kernel_fallbacks']} re-dispatched decode "
                  f"calls, {stats['nan_logit_events']} NaN-logit retirements, "
                  f"{stats['callback_errors']} callback errors survived")
        for r in failed[:4]:
            print(f"  req {r.rid} failed: {r.error}")
    print(f"  quant={args.policy or args.quant or 'off'} kv_int8={args.kv_int8}")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {(r.out_tokens or [])[:10]}")
    if args.plans:
        n = get_registry().save_plans(args.plans)
        print(f"saved {n} block plans to {args.plans}")
    if args.index:
        n = engine.save_index(args.index)
        print(f"saved {n} prefix digests to {args.index}")
    report = {"requests": len(done), "tokens": total, "seconds": dt,
              "tok_per_s": total / dt, "warmup_s": t_warm, "stats": stats,
              "warmup_tokens": {r.rid: r.out_tokens for r in warm}}
    return engine, done, report


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
