#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

1. Builds the fourteen CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together): the seven ports of the
   Pallas kernels, ``dense_matmul`` (the batch-invariant bf16 product,
   with a float32 store for Griffin's gate projections), ``expert_matmul``
   (the MoE layers' grouped expert product on ``dense_matmul``'s block
   routine), ``rglru``
   (Griffin's gates and recurrence in one pass) and, for training,
   ``flash_attention_bwd``, ``wkv6_bwd``, ``rglru_bwd`` and
   ``expert_matmul_bwd`` (the gradients of flash attention, of the two
   recurrences and of the grouped expert product).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it: integers (codes, accumulators,
   activation scales, int8 pool bytes, scale planes) bitwise; attention
   outputs within atol = rtol = 2e-2 in bf16 (summation order, expf and
   P rounded to bf16 for the tensor cores differ from a one-pass float32
   softmax) and 1e-4 in float32, also at head dims 80, 256, 160 and
   GQA 6 (``check_head_dims``); ``quantize_rows`` bitwise on float32 and
   bfloat16 rows; the Table III mixed-group matmul bitwise equal to its
   plain version and to the fused kernel's two-group route
   (``check_mixed_group``), and a Table III leaf launching exactly one
   ``quantize_rows``, two ``bitplane_matmul`` dequant kernels and at most
   two folds (``check_table3_launches``, under torch.profiler); the fused
   quantize -> packed matmul bitwise in both output
   forms, (acc, scales) and the dequantized product in x's dtype at a
   column offset, at M in {4, 32, 1280} with float32 and bfloat16 rows
   (``check_fused``); wkv6 within 1e-4 in float32 (and bitwise
   independent of padding); ``bitplane_matmul`` bitwise at M in {4, 17,
   64, 200, 1280}
   (each tile plan) and on a ragged shape; ``dense_matmul`` within 2e-2 of
   ``x @ w`` and its rows bitwise the same at M in {1, 4, 17, 64, 65, 128,
   200, 640, 1280} (every tiling, split and unsplit K). The SASS of the
   bf16 tensor-core kernels (the flash backward's too) must hold HMMA,
   bitplane_matmul's and the fused kernel's IMMA, and the three backward
   kernels' no atomic (``count_hmma``). The attention kernels
   share one order (tiles of 32 keys, splits of 64, csrc/attend_tile.cuh):
   chunked prefill, paged decode and contiguous decode must be bitwise
   whole-prompt flash attention on the same keys (``check_one_order``:
   several splits, GQA 4, 6 and 8, head dims 80 / 128 / 160 / 256, block
   sizes 16 / 32 / 64, NaN in every slot no row may see). At the widths
   of nemotron-4-15b and stablelm-12b (K up to 24 576, N 1280-24 576,
   ``check_new_widths``): ``quantize_rows``, the fused kernel under w4a8
   and the Table III leaf bitwise their plain versions at M 4 and 32.
   At recurrentgemma-9b's shapes: paged_attention's ring entry (B = 4,
   a 2048-slot ring wrapped once and twice, NQ 16 / NKV 1 / H 256, and
   the reduced ring of 16 in bf16 and float32) within tolerance of its
   plain version and bitwise the windowed flash kernel's rows with NaN in
   every empty slot (``check_ring_decode``); windowed flash at T 320 and
   2304 within tolerance, its key tiles wholly outside every row's
   window never read (``check_windowed_flash``); the RG-LRU within 1e-4
   at T 320 and 2304, two calls with the carry bitwise one, the step
   bitwise the call, rows alone, in a pair and in a three bitwise their
   rows in a batch of 4, so every tile plan is held, timed at B 4 / T 320,
   B 2 / T 2304, B 1 / T 320 and the step beside a copy of the same bytes,
   its launches split into prompts and steps (``check_rglru``);
   ``dense_matmul``'s float32 store at 4096 -> 4096
   within 1e-4, its rows at M = 1-9 and 1280 bitwise their M = 4 rows
   (``check_dense_f32``); the norms' row mean bitwise across M = 1-9 at
   every width, hubert-xlarge's 1280 and rwkv6's 64-wide group-norm rows
   (40 a token) among them (``check_norm_rows``). At the frontend
   families' masks (``check_frontend_flash``): the flash kernel under
   prefix-LM at MQA 8/1, H 256 (P = 8 and 256, with and without a window,
   q_offset 0 and 16) and bidirectional (causal = 0) at MHA 16/16, H 80,
   in bf16 and float32, its rows bitwise independent of padding and of
   the 64-row block they share. At the MoE family's shapes
   (``check_expert_matmul``, ``moe_kernel_checks``): ``expert_matmul``
   (EXPERT_CASES: mixtral's decode, 8 experts at 6144 -> 16384 and
   16384 -> 6144, its static prefill at capacity 400 at both widths (two
   consumer warpgroups with one K slice and with two), llama4's decode,
   4 rows in 4 of 128 experts at 5120 -> 8192, and its prefill, 1 280
   rows over all 128 at capacity 16) within 2e-2 of its plain version,
   every kept row bitwise ``dense_matmul`` of that row alone, sampled
   rows alone at capacity 8 (and 16) bitwise their rows in the full
   buffer, every count 0 all zeros, rows
   past an expert's count zero with NaN in their buffer rows, timed
   beside its bound, the plain version, ``torch.bmm`` over the whole
   buffer and the call with every expert full; its SASS holds HGMMA and
   UTMALDG, no HMMA and no atomic, and its ptxas log no note that
   serializes wgmma (C7517, C7518); the ring entry at mixtral's decode (B 4, window
   4096, NQ 48 / NKV 8, H 128) in bf16 and int8 and windowed flash over a
   4200-token prompt within 2e-2, timed; the fused kernel and the Table
   III leaf at nemotron-4-340b's FFN widths (K up to 73 728) bitwise
   their plain versions, the fused kernel timed at its w_up decode.
3. Times each kernel, its plain version and one PyTorch library call on
   the same inputs where one computes the same function, at the
   decode and the prefill shape of the matmuls (CUDA events,
   median of 20, L2 flushed before each, the card held until the host
   has enqueued the call).
4. Serves olmo-1b and rwkv6-3b at full width, cut to 4 and 8 layers
   (``DEPTH``; random weights from a seed) through
   ``repro_torch.launch.serve``: 8 requests with prompts of 64-320
   tokens, 32 new tokens each, 4 slots, in sixteen runs — olmo
   continuous with chunked prefill on a bf16 pool (Table III policy
   "w4a6r25;wo=w8a8") and an int8 pool ("w4a8;wo=w8a8"); (a) static,
   Table III policy; (b) static, int8 cache; (c) continuous with solo
   whole-prompt admission on the paged bf16 pool, Table III policy; (d)
   continuous on the contiguous cache; rwkv6-3b (e) static and (f)
   continuous, unquantized bf16; olmo unpacked (no policy, every dense
   product on ``dense_matmul``) (g) static and (h) continuous; and the
   prefix cache, every prompt after one shared 200-token prompt: (i)
   chunked on the bf16 pool, Table III policy, and (j) whole-prompt
   admission on the int8 pool; and self-speculative decoding: (k)
   --speculate 4 with a w4a8 draft on the int8 pool ("w4a8;wo=w8a8":
   the draft truncates the w8 `wo` leaves to plane_lo 2) and (l)
   --speculate 3 with a w2a8 draft on the bf16 pool with the 200-token
   shared prefix ("w4a8r25;wo=w8a8": Table III leaves drafted at
   plane_lo 1, `wo` at 3); and per-request precision tiers, the
   requests at w8a8, w4a8 and w2a8 round-robin in one batch: (m) "w8a8"
   storage on the bf16 pool with the 200-token shared prefix (the fused
   kernel at plane_lo 0, 2 and 3 in consecutive group calls, tier-scoped
   prefix hits) and (n) "w4a8r25;wo=w8a8" on the int8 pool with
   --speculate 3 and a w2a8 draft (w8a8 and w4a8 slots speculate, each
   tier group verified in a call of its own, w2a8 slots do not; Table III
   leaves at plane_lo 1 at w2a8); and, first, nemotron-4-15b and
   stablelm-12b at full width, 8 layers each (every head and vocab
   entry; raw weights drawn, packed once per arch and dropped, both runs on the
   packed tree, everything dropped before the next arch; ``ARCH_RUNS``,
   ``serve_new_archs``) on the stream's first 4 requests: (o) nemotron
   continuous, chunked, bf16 pool, Table III policy (K up to 24 576, GQA
   48/8) and (p) static, gated greedy ≡ (o), chunked ≡ whole-prompt
   first-token logits bitwise and solo ≡ mid-decode; (q) stablelm
   (qk-norm, head dim 160) continuous on the int8 pool, "w4a8;wo=w8a8",
   and (r) the same with --speculate 4 and a w4a8 draft, gated greedy ≡
   (q) in both passes, the speculation counters, ``verify_vs_decode`` at
   head dim 160, solo ≡ mid-decode on (q); each untied head's rows at M
   = 1-9 bitwise its rows at M = 4 (``head_rows``); the peak device
   memory of every init, pack and run printed. Each run must launch the
   kernels of its path, a paged pool must hold its allocator invariants after the run,
   and each run's repeated pass must give identical greedy tokens. The
   prefix cache is on in every paged continuous run, but this gates warm
   against cold only where the pool keeps the warmup's blocks (runs (i)
   and (j)): the runs without a shared prefix hold exactly 4 slots'
   blocks, so the LRU evicts most of them before the timed pass reaches
   them, and those passes are mostly cold (their tok/s includes the
   evictions).
   Prefix-cache gates (``compare_prefix``): runs (i) and (j) emit the
   greedy tokens of their stream served with --no-prefix-cache, in both
   passes; a partial and a whole-prompt hit give first-token logits
   bitwise those of the cold admission, chunked and whole-prompt, on
   bf16 and int8 pools; run (i) hits blocks and copies one on write.
   Speculation gates (``compare_speculation``): runs (k) and (l) emit the
   greedy tokens of their stream served without --speculate, in both
   passes; the verify chunk's logits are bitwise the decode steps' it
   replaces and the pool bytes it writes over the draft's are bitwise the
   decode-written ones, on the int8 and the bf16 pool, with dead rows
   left as they were (``verify_vs_decode``); the draft/accept/verify
   counters hold together.
   Tier gates (``compare_tiers``): in both passes of runs (m) and (n)
   every request (greedy and sampled) emits the tokens an engine
   configured with that request's tier alone emits (same weights, pool,
   flags and max_batch), 8/8; after every mixed-tier step the device
   pos/length of each decoding row equal the host's (``watch_tiers``);
   (m) hits prefix blocks; in (n) w2a8 requests draft nothing and each
   round makes one verify call per speculating tier group, also in the
   rounds with two groups that (n)'s three greedy requests make when
   served together; the per-tier counters agree with the requests. Lifecycle gates
   (``check_lifecycle``, int8 pool, the same stream in-process): a
   request cancelling itself from ``on_token`` after 5 tokens, one
   cancelled while queued, one past its ``deadline_steps`` mid-decode
   and one whose callback raises each return their error and a prefix
   of their unperturbed stream, every other request its unperturbed
   tokens, the counters 2 / 1 / 1, no block leaked; and the serve CLI
   with --tiers and --deadline-ms prints its per-tier and lifecycle
   reports. Preemption gates (``check_preemption``, in-process, the
   same stream on pools too small for it: P1 chunked prefill on the int8
   pool, P2 whole-prompt admission on the bf16 pool with the Table III
   policy, P3 whole-prompt admission on the int8 pool behind the shared
   prefix, each also a pair sized so that its victim resumes from its
   registered blocks): every request's tokens, greedy and sampled, those
   of the matching run without pressure, at least two preemptions on
   the stream and one warm resume on the pair, the pool invariants after
   every step; the gap between each first resume's logits and the
   uninterrupted decode's is printed. Chaos gates (``check_chaos``, run
   (k)'s flags on a small pool, a seeded ``FaultInjector`` at all four
   seams): every seam fires, the requests no fault failed emit run (k)'s
   tokens, each failed one a prefix of them with a nan-logits or
   callback error, the counters equal the faults fired; and the serve
   CLI with --chaos-seed prints its lifecycle and chaos lines. Host-tier
   gates (``check_host_tier``, in-process, the same stream, 512 MiB of
   host memory, the pool invariants — host half included — after every
   step): H1 and H2 serve the stream twice through one scheduler on a
   44-block pool with run (i)'s and run (j)'s flags, every request's
   tokens those of the run in both rounds and round 2 swapping blocks in
   from host; H3 re-serves P1-P3 under ``block-to-host``: tokens those of
   the unpressured run, at least two preemptions each, every resume warm,
   and with a budget of 8 blocks' bytes the host store evicts and stays
   within it; H4 saves run (j)'s int8 prefix index from one engine and
   loads it into a fresh one before its first generate: the same tokens,
   host hits and fewer prefill tokens, and a bf16 pool refuses that
   index; the serve CLI with --index run twice saves and then loads it,
   with a host-tier line. Every serve run above has no preemption,
   re-dispatched decode call or NaN-logits retirement.
   The read-only (store=False) form of ``paged_prefill`` is bitwise the
   storing call and leaves the pool unchanged. Gated across paths (see
   ``compare_paths``): chunked and whole-prompt first-token logits bitwise
   equal on the bf16 pool, and identical greedy tokens whole-prompt (c)
   vs chunked and static (a) vs continuous (c); rwkv6's static batch vs
   solo first-token logits bitwise equal and greedy (e) vs (f) identical
   (``compare_rwkv6``); unpacked olmo's static batch vs solo and chunked
   vs whole-prompt first-token logits bitwise equal and greedy (g) vs (h)
   identical (``compare_unpacked``); a greedy request served alone and
   admitted mid-decode emits identical tokens (olmo bf16 and int8 pools,
   rwkv6); small float32 models (olmo-1b, nemotron-4-15b, stablelm-12b,
   rwkv6-3b) give the same logits on the card (kernels) as on the CPU
   (plain versions).
   The kernel registry (``check_registry``): ``autotune`` at run (o)'s
   decode shape of the fused kernel, both groups of a Table III leaf and
   two ``dense_matmul`` shapes, every candidate's output bitwise the
   heuristic plan's; ``save_plans`` / ``load_plans`` into a fresh
   registry give the same plans; the serve CLI with --plans twice on
   chunked-int8's flags saves N >= 1 plans, then loads N and plans
   nothing anew, both with that run's tokens; --backend reference on the
   card exits with its message.
   recurrentgemma-9b (Griffin: RG-LRU recurrence, local attention over
   2048-slot rings) at full width (10.4 B parameters, random bf16
   weights, unquantized as the JAX package serves it; ``GRIFFIN_RUNS``,
   ``serve_griffin``), after (o)-(r), on the stream's first 4 requests:
   (s) static and (t) continuous, gated greedy (t) ≡ (s), first-token
   logits bitwise static batch vs solo, solo ≡ mid-decode, the untied
   head's rows at M = 1-9 bitwise M = 4, and the ring-wrap pair (a
   2300-token prompt that wraps the ring inside prefill, a 2040-token one
   that wraps it while decoding 24 tokens) static ≡ continuous; reduced
   float32 card vs CPU within 1e-3 (``card_vs_cpu_griffin``).
   The frontend families at full width and depth through
   ``build_model(cfg)`` (``serve_frontends``; the serve CLI refuses both,
   as the JAX package's does), after (s) and (t): paligemma-3b (18
   layers, 2.51 B parameters, tied 257 216-wide head) under the Table
   III policy on the contiguous bf16 cache, 4 rows of 256 random patch
   embeddings and 64-320 text tokens, prefill (flash under the prefix-LM
   mask) and 8 greedy decode steps, gated bitwise: its tied head's rows
   at M = 1-9, teacher-forced prefill ≡ decode step, each row alone ≡ its
   batch row (logits and tokens), the prefix-LM visibility;
   hubert-xlarge (48 layers, 0.95 B) under "w4a8;wo=w8a8", 4 clips of
   500 frames through ``forward_hidden``, its logits and ``prefill``
   (flash with causal = 0), gated: each clip alone ≡ its batch row's
   hidden states bitwise, logits within 1e-2, the last frame moves the
   first position; reduced float32 card vs CPU within 1e-3 for both
   (``card_vs_cpu_frontends``).
   The MoE family and nemotron-4-340b at full width (``serve_moe_archs``,
   after (o)-(r); DEPTH's 4, 1 and 2 layers; on the stream's first 4
   requests; raw bf16 weights drawn once an arch, packed under each
   run's policy, the experts and router left unpacked as in JAX): (u)
   mixtral static, Table III, the bf16 ring; (v) mixtral continuous on
   the int8 ring, "w4a8;wo=w8a8"; (w) llama4 static and (x) llama4
   continuous on the paged pool with solo admission, "w4a8;wo=w8a8"; (y)
   nemotron-4-340b chunked on the bf16 pool and (z) static, Table III.
   Gated: each run's kernels launched (``expert_matmul`` in every MoE
   run), the untied heads' rows at M = 1-9 bitwise M = 4, (u)'s and (w)'s
   static first-token logits bitwise when prefilled twice, mixtral's ring
   wrap (a 4200-token prompt then 4 decode steps at capacity factor 16 vs
   prefill over the same tokens: on the bf16 ring logits and ring
   bitwise; on the int8 ring slot positions, layer 0 and every slot no
   decode step wrote bitwise, logits within 0.25; a planted write one
   slot on fails that ring gate), a full-width bf16 MoE layer of mixtral
   and of llama4 through ``moe_apply`` on the kernel within 2e-2 of the
   same call on the plain version (``moe_layer_vs_plain``),
   (z) ≡ (y) greedy and chunked ≡ whole-prompt first-token logits
   bitwise; reduced float32 mixtral and llama4 ``moe_apply`` (keep mask
   bitwise, out within 1e-4) and logits (1e-3) card vs CPU
   (``card_vs_cpu_moe``).

5. Trains (``check_backward_kernels`` and ``train_phase``, after the
   frontend phase): the flash
   backward's dQ/dK/dV against the plain version's autograd gradients on
   the card for every mask and head dim (``BWD_CASES``; within 1e-4 of
   max |g| in float32, the scalar route, and 2e-2 in bf16, the
   tensor-core route, whose tile edges two cases cross; zero on rows that
   see no key, two calls bitwise), timed at olmo-1b's training shape
   beside SDPA's backward (there also batch row 3 alone bitwise row 3 of
   the batch of 8) and at paligemma's prefix-LM and hubert's
   bidirectional shapes, and at Griffin's (MQA 16/1, H 256, window
   2048, T 512); the recurrences' backward kernels against their plain
   versions (``check_wkv6_backward``: rwkv6-3b's training shape B 8, T
   512, H 40, K = V = 64, bf16, a T no multiple of the chunk, a carried
   state with dstate_out, decays down to 1e-6, B 1; ``check_rglru_backward``:
   Griffin's B 8, T 512, W 4096, bf16 y, zero and carried h0, Lambda near
   the clamp; within ``WKV_BWD_TOL`` / ``RGLRU_BWD_TOL`` of max |g|, two
   calls bitwise, row 0 alone bitwise its batch row, timed beside their
   bounds and plain versions, ``wkv6_bwd`` also launch by launch under
   torch.profiler and ``rglru_bwd`` beside a copy of its bytes, every
   ``rglru.BWD_PLANS`` tiling run); the autograd wrappers change no bit of
   olmo-1b's ``forward_hidden`` (4 layers, full width) nor its launches;
   reduced float32 olmo-1b (plain and QAT), rwkv6-3b and recurrentgemma-9b
   train 3 steps on the card as on the CPU (``TRAIN_TOL``; in the
   recurrent rows every param element apart by more than 1e-3 is named,
   its first-step gradient held within ``NEAR_ZERO_ULPS`` of zero on both
   devices and its first nonzero gradient of opposite signs on the two);
   ``python -m
   repro_torch.launch.train --arch olmo-1b --steps 20 --global-batch 8
   --seq 512 --qat w4a8`` at full width and depth (1.18 B parameters),
   ``--arch rwkv6-3b --steps 10 --lr 1e-3`` at full width and depth (2.86
   B) and recurrentgemma-9b at full width cut to 8 layers, QAT w4a8, 10
   steps through ``train/loop.py`` (3.68 B; finite losses and grad norms,
   the last loss below the first, the backward kernels launched; s/step,
   tokens/s and the peak memory printed); a 4-layer full-width QAT
   olmo-1b run saves at steps 5 and 10 (about
   4.5 GB each, in a temporary directory removed after), its restored
   state bitwise the saved one, steps 10-14 after a restart bitwise the
   uninterrupted run's; ``serve --ckpt`` of that checkpoint prints
   the restored step, its greedy tokens those of an in-process engine on
   the restored params; rwkv6-3b at full width, 2 layers, and the
   reduced recurrentgemma-9b restart bitwise the same way through
   ``wkv6_bwd`` and ``rglru_bwd`` (``check_restarts``). MoE training
   (slice 23): ``expert_matmul_bwd``'s dX and dW within 2e-2 of max |g| of
   the plain version at mixtral's and llama4's training shapes and a
   sparse case, a repeat bitwise, NaN past the counts changing no bit
   (``check_expert_backward``); a full-width bf16 mixtral MoE layer's
   gradients on the kernels against the plain call
   (``check_moe_layer_grads``); the reduced float32 mixtral-8x22b and
   llama4-maverick in the card-vs-CPU training rows; mixtral-8x22b at
   full width cut to MIXTRAL_TRAIN_LAYERS, QAT w4a8, 10 steps at
   MIXTRAL_TRAIN_LR, its aux loss printed each step; the reduced bf16 mixtral's bitwise restart.
   No serve run launches the backward.

Prints ``dense_matmul``'s numbers as one JSON line, the kernel table
(the seven ports of TPU kernels, then ``rglru``, ``flash_attention_bwd``,
``wkv6_bwd``, ``rglru_bwd``, ``expert_matmul``, ``expert_matmul_bwd`` and
``dense_matmul``,
which replace XLA code,
with a ``note`` saying so; each row's headline
times the entry the serve paths launch, so ``bitplane_matmul``'s is its
dequant entry and the JAX-signature int32 entry is a sub-entry;
paged_attention's entries time the paged, contiguous and ring entries)
as another, then the card's name and power limit, then ``{"ok": true, "device": {...}}`` as the last line. Any
failed check raises, so the exit code is non-zero and no result prints.
With ``CHIP_SMOKE_OUT=<dir>`` set, the detailed numbers are also
written to ``<dir>/chip_smoke.json``. The whole run walks one ordered
table of phases, PHASES. A partial run, ``python3 chip_smoke.py <mode>``,
walks the subset MODES names for it, prints no result line, writes its
report to ``<dir>/chip_smoke_<mode>.json`` and exits 3: ``kernels`` (the
build and every kernel check), ``moe``, ``archs``, ``griffin``,
``frontends`` (a slice's kernel checks, serve runs and card-vs-CPU
checks), ``train``, ``bwd`` (the backward kernels, and for ``train``
the training phase), ``spec``, ``tiers``, ``preempt`` and ``host`` (the
serve runs their comparisons need, and those). Three diagnostics exit 3
too: ``profile [run ...]`` profiles one serve pass per run (see
``profile_serve``), ``paths`` measures how far the prefill paths'
logits part (see ``paths_diagnostic``) and ``profile-train [arch ...]``
breaks a training step of olmo-1b (the default), rwkv6-3b,
recurrentgemma-9b or mixtral-8x22b down by part and by kernel group (see
``profile_train``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12     # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12      # float32 outside the tensor cores
ATOL = RTOL = 2e-2
F32_TOL = 1e-4
POLICY = "w4a8;wo=w8a8"
MIXED_POLICY = "w4a6r25;wo=w8a8"   # the paper's Table III setting
# Table III at a8: a w2a8 draft view of it truncates every leaf without
# changing an activation width (a6 leaves would refuse an a8 draft).
SPEC_TABLE3_POLICY = "w4a8r25;wo=w8a8"
REPLACES = {
    "fused_quantize_matmul": "src/repro/kernels/fused_matmul.py:114",
    "paged_attention": "src/repro/kernels/paged_attention.py:119",
    "paged_prefill": "src/repro/kernels/paged_prefill.py:172",
    "quantize_rows": "src/repro/kernels/pack_quant.py:41",
    "bitplane_matmul": "src/repro/kernels/bitplane_matmul.py:109",
    "flash_attention": "src/repro/kernels/flash_attention.py:89",
    "wkv6": "src/repro/kernels/wkv6.py:85",
    # No Pallas kernel: the JAX package leaves these to XLA.
    "dense_matmul": "src/repro/models/common.py:49",
    "rglru": "src/repro/models/griffin.py:126",
    "flash_attention_bwd": "src/repro/models/common.py:151",
    "wkv6_bwd": "src/repro/models/rwkv6.py:40",
    "rglru_bwd": "src/repro/models/griffin.py:126",
    "expert_matmul": "src/repro/models/moe.py:41",
    "expert_matmul_bwd": "src/repro/models/moe.py:44",
}
NOT_PALLAS = {"dense_matmul": "XLA x @ w in linear (no Pallas kernel)",
              "rglru": "XLA _rglru_coeffs + associative_scan _rglru_scan (no Pallas "
                       "kernel)",
              "flash_attention_bwd": "XLA autodiff of chunked_attention (no Pallas "
                                     "kernel has a VJP)",
              "wkv6_bwd": "XLA autodiff of the chunked jnp wkv6_chunked (the Pallas "
                          "wkv6 kernel has no VJP)",
              "rglru_bwd": "XLA autodiff of _rglru_coeffs + associative_scan (no "
                           "Pallas kernel)",
              "expert_matmul": "XLA einsum('ecd,edf->ecf') in _expert_ffn (no Pallas "
                               "kernel)",
              "expert_matmul_bwd": "XLA autodiff of einsum('ecd,edf->ecf') in _expert_ffn "
                                   "(no Pallas kernel)"}
SOURCES = {
    "fused_quantize_matmul": "src/repro_torch/kernels/csrc/fused_matmul.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_prefill": "src/repro_torch/kernels/csrc/paged_prefill.cu",
    "quantize_rows": "src/repro_torch/kernels/csrc/quantize_rows.cu",
    "bitplane_matmul": "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "wkv6": "src/repro_torch/kernels/csrc/wkv6.cu",
    "dense_matmul": "src/repro_torch/kernels/csrc/dense_matmul.cu",
    "rglru": "src/repro_torch/kernels/csrc/rglru.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "wkv6_bwd": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
    "rglru_bwd": "src/repro_torch/kernels/csrc/rglru_bwd.cu",
    "expert_matmul": "src/repro_torch/kernels/csrc/expert_matmul.cu",
    "expert_matmul_bwd": "src/repro_torch/kernels/csrc/expert_matmul_bwd.cu",
}
SHARED_PREFIX = 200
TIERS = "w8a8,w4a8,w2a8"
# Serve runs: name → (serve.py flags, policy, kernels its path must launch).
# ``contig_attention`` is paged_attention's second entry, the paged decode
# kernel's code run over the contiguous cache (one TPU kernel, two entries).
SERVE_RUNS = {
    "chunked-bf16": (["--continuous"], MIXED_POLICY,
                     ("fused_quantize_matmul", "paged_attention", "paged_prefill",
                      "quantize_rows", "bitplane_matmul")),
    "chunked-int8": (["--continuous", "--kv-int8"], POLICY,
                     ("fused_quantize_matmul", "paged_attention", "paged_prefill")),
    "a-static": (["--static"], MIXED_POLICY,
                 ("flash_attention", "quantize_rows", "bitplane_matmul",
                  "fused_quantize_matmul", "contig_attention")),
    "b-static-int8": (["--static", "--kv-int8"], POLICY,
                      ("flash_attention", "fused_quantize_matmul", "contig_attention")),
    "c-solo-paged": (["--continuous", "--no-chunked-prefill"], MIXED_POLICY,
                     ("flash_attention", "quantize_rows", "bitplane_matmul",
                      "paged_attention", "fused_quantize_matmul")),
    "d-contiguous": (["--continuous", "--no-paged"], POLICY,
                     ("flash_attention", "fused_quantize_matmul", "contig_attention")),
    # olmo-1b unpacked (no policy): every dense product on dense_matmul.
    "g-olmo-unpacked-static": (["--static"], None,
                               ("flash_attention", "contig_attention", "dense_matmul")),
    "h-olmo-unpacked-continuous": (["--continuous"], None,
                                   ("paged_attention", "paged_prefill", "dense_matmul")),
    # The prefix cache: every prompt after one shared 200-token prompt
    # (12 whole 16-token blocks and a block it shares only in part, so a
    # whole-prompt hit copies its partial block on write). (i) chunked on
    # the bf16 pool; (j) whole-prompt admission on the int8 pool, its
    # suffixes through the flash kernel over dequantized blocks.
    "i-prefix-chunked": (["--continuous", "--shared-prefix", str(SHARED_PREFIX)],
                         MIXED_POLICY,
                         ("fused_quantize_matmul", "paged_attention", "paged_prefill",
                          "quantize_rows", "bitplane_matmul")),
    "j-prefix-solo-int8": (["--continuous", "--no-chunked-prefill", "--kv-int8",
                            "--shared-prefix", str(SHARED_PREFIX)], POLICY,
                           ("flash_attention", "fused_quantize_matmul",
                            "paged_attention")),
    # Self-speculative decoding. (k) int8 pool: a w4a8 draft truncates only
    # the w8 `wo` leaves (plane_lo 2); (l) bf16 pool, Table III leaves and
    # the prefix cache: a w2a8 draft shifts both filter groups of each
    # Table III leaf by one plane and `wo` by three.
    "k-spec-int8": (["--continuous", "--kv-int8", "--speculate", "4",
                     "--draft-policy", "w4a8"], POLICY,
                    ("fused_quantize_matmul", "paged_attention", "paged_prefill")),
    "l-spec-table3-prefix": (["--continuous", "--speculate", "3", "--draft-policy",
                              "w2a8", "--shared-prefix", str(SHARED_PREFIX)],
                             SPEC_TABLE3_POLICY,
                             ("fused_quantize_matmul", "paged_attention", "paged_prefill",
                              "quantize_rows", "bitplane_matmul")),
    # Precision tiers: the requests take w8a8, w4a8 and w2a8 round-robin,
    # served from one packed weight set in one batch. (m) w8a8 storage on
    # the bf16 pool with the shared prefix: the fused kernel at plane_lo
    # 0/2/3 in consecutive group calls, tier-scoped prefix hits, chunks at
    # the slot's tier; (n) Table III storage on the int8 pool with a w2a8
    # draft: w8a8 and w4a8 slots speculate (one verify call per tier
    # group), w2a8 slots do not, and w2a8 runs the Table III leaves at
    # plane_lo 1 (``ops.packed_matmul(..., packed8=)``).
    "m-tiers-prefix": (["--continuous", "--tiers", TIERS, "--shared-prefix",
                        str(SHARED_PREFIX)], "w8a8",
                       ("fused_quantize_matmul", "paged_attention", "paged_prefill")),
    "n-tiers-spec-table3-int8": (["--continuous", "--kv-int8", "--tiers", TIERS,
                                  "--speculate", "3", "--draft-policy", "w2a8"],
                                 SPEC_TABLE3_POLICY,
                                 ("fused_quantize_matmul", "paged_attention",
                                  "paged_prefill", "quantize_rows", "bitplane_matmul")),
    # rwkv6-3b at full width, bf16 weights, no policy (the JAX package
    # serves rwkv6 unquantized): its recurrent state, no KV cache.
    "e-rwkv6-static": (["--arch", "rwkv6-3b", "--static"], None,
                       ("wkv6", "dense_matmul")),
    "f-rwkv6-continuous": (["--arch", "rwkv6-3b", "--continuous"], None,
                           ("wkv6", "dense_matmul")),
}


# Runs (o)-(r): nemotron-4-15b and stablelm-12b at full width, cut to
# DEPTH's 8 layers (every head, the full vocab; random weights from seed
# 0), each arch's two runs on one packed weight set, on the stream's
# first 4 requests (prompts of 64, 320, 128 and 256 tokens; the whole
# stream took the script to 884.8 s of its 1200 s limit on the H100).
ARCH_STREAM = ["--requests", "4"]
ARCH_RUNS = {
    # nemotron-4-15b: the bf16 pool, chunked prefill, Table III at K up to
    # 24 576, GQA 48/8 (G = 6); (p) static, gated greedy ≡ (o).
    "o-nemotron-chunked": (["--arch", "nemotron-4-15b", "--continuous", *ARCH_STREAM],
                           MIXED_POLICY,
                           ("fused_quantize_matmul", "paged_attention", "paged_prefill",
                            "quantize_rows", "bitplane_matmul")),
    "p-nemotron-static": (["--arch", "nemotron-4-15b", "--static", *ARCH_STREAM],
                          MIXED_POLICY,
                          ("flash_attention", "quantize_rows", "bitplane_matmul",
                           "fused_quantize_matmul", "contig_attention")),
    # stablelm-12b: qk-norm, head dim 160 on the int8 pool; (r) speculates,
    # gated greedy ≡ (q).
    "q-stablelm-int8": (["--arch", "stablelm-12b", "--continuous", "--kv-int8",
                         *ARCH_STREAM], POLICY,
                        ("fused_quantize_matmul", "paged_attention", "paged_prefill")),
    "r-stablelm-spec-int8": (["--arch", "stablelm-12b", "--continuous", "--kv-int8",
                              "--speculate", "4", "--draft-policy", "w4a8", *ARCH_STREAM],
                             POLICY,
                             ("fused_quantize_matmul", "paged_attention", "paged_prefill")),
}
# Runs (s) and (t): recurrentgemma-9b (Griffin) at full width (38 layers,
# d_model and rnn_width 4096, 16 query heads of 256 over 1 KV head, vocab
# 256 000, window 2048; random bf16 weights from seed 0, no policy: the
# JAX package serves griffin unquantized), on the stream's first 4
# requests: windowed flash prefill, ring decode, the RG-LRU kernel and
# every dense product on dense_matmul (the gate projections with its
# float32 store). (t) is gated greedy ≡ (s). ``rglru_prefill`` and
# ``rglru_step`` are the RG-LRU's prompt (T > 1) and step (T = 1) launches.
GRIFFIN_KERNELS = ("flash_attention", "ring_attention", "dense_matmul", "rglru",
                   "rglru_prefill", "rglru_step")
GRIFFIN_RUNS = {
    "s-griffin-static": (["--arch", "recurrentgemma-9b", "--static", *ARCH_STREAM], None,
                         GRIFFIN_KERNELS),
    "t-griffin-continuous": (["--arch", "recurrentgemma-9b", "--continuous", *ARCH_STREAM],
                             None, GRIFFIN_KERNELS),
}
# The depth at which the paths are served (``serve --layers``; every
# width, head and vocab entry kept). Served at full depth, the whole
# script took 912.7 s of its 1200 s limit on the H100, so only
# recurrentgemma-9b keeps all its layers (38). The MoE family and
# nemotron-4-340b need more than one card at full depth: mixtral-8x22b
# serves 4 of 56 layers (20.8 GB of bf16 weights), llama4-maverick 1 of 48
# (36.5 GB: 128 experts of 3 x 5120 x 8192 a layer, 2 layers would hold
# 68.8 GB before any activation), nemotron-4-340b 2 of 96 (32.6 GB drawn,
# its untied embedding and head 18.9 GB of them).
DEPTH = {"olmo-1b": 4, "rwkv6-3b": 8, "nemotron-4-15b": 8, "stablelm-12b": 8,
         "mixtral-8x22b": 4, "llama4-maverick-400b-a17b": 1, "nemotron-4-340b": 2}


def serve_config(arch):
    """`arch`'s config at the depth its runs serve (DEPTH)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=DEPTH.get(arch, cfg.num_layers))


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median CUDA-event time of `fn` over `iters` calls, with the L2
    cache flushed (a 128 MB write) before each timed call. The card then
    sleeps ~5 ms (``torch.cuda._sleep``) before the first event, so the
    host has enqueued all of `fn` by the time the card reaches it: the
    time is the card's, not the wrapper's Python, whatever the host's
    speed (for a plain version whose host work exceeds the sleep, the
    excess still shows)."""

    SLEEP_CYCLES = 10_000_000

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)



def device_ms_by_group(torch, fn, groups, iters: int = 10):
    """Device time of each group of kernels (group -> substrings of the
    kernel names) a call of `fn` launches, in ms a call: `fn` run `iters`
    times under torch.profiler after a warmup, L2 not flushed between the
    calls. Raises if a group recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {g: 0.0 for g in groups}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for g, keys in groups.items():
            if any(k in e.key for k in keys):
                out[g] += e.self_device_time_total / 1e3 / iters
                break
    missing = [g for g, ms in out.items() if ms <= 0]
    if missing:
        raise AssertionError(f"no device time recorded for {missing}")
    return out


# wkv6_bwd's four launches, by kernel name.
WKV_BWD_LAUNCHES = {"state": ("wkv6_bwd_state_kernel",), "pass": ("wkv6_bwd_pass_kernel",),
                    "chunk": ("wkv6_bwd_chunk_kernel",), "du": ("wkv6_bwd_du_kernel",)}


def wkv6_bwd_launch_bounds(B, T, H, K, C):
    """The least time of each of wkv6_bwd's four launches on the H100 (ms,
    and what bounds it), from the bytes it must move and the float32
    operations it must do, K = V, bf16 r/k/v: the state kernel reads r,
    w and dout and writes W_c and D_c (W_c = sum_t (r_t e^Lsh_t)
    dout_t^T: 2 C K V a chunk); the pass reads W_c, D_c and dstate_out and
    writes G_c+1 over W_c and dstate_in (G = D_c G + W_c: 2 K V a chunk);
    the chunk kernel reads r, k, v, w, dout, S_c and G_c+1 and writes dr,
    dk, dv, dw and a du partial (the bound's other products, the gated
    sums and one exp a gate); du sums the partials over rows and chunks."""
    nc = -(-T // C)
    elems, states = B * T * H * K, B * H * nc * K * K
    per = 2 * (C * C * K + 4 * C * K * K + C * C * K // 2 + 3 * C * C * K // 2) + C * C * K
    state_ops = 2 * C * K * K
    parts = {
        "state": (2 * elems + 4 * elems * 2 + 4 * states + 4 * B * H * nc * K,
                  B * H * nc * state_ops),
        "pass": (2 * 4 * states + 4 * B * H * nc * K + 2 * 4 * B * H * K * K,
                 B * H * nc * 2 * K * K),
        "chunk": (3 * 2 * elems + 2 * 4 * elems + 2 * 4 * states + 3 * 2 * elems
                  + 4 * elems + 4 * B * H * nc * K, B * H * nc * (per - state_ops)),
        "du": (4 * B * H * nc * K + 4 * H * K, B * H * nc * K)}
    out = {}
    for name, (nbytes, ops) in parts.items():
        ms, by = bound_ms(nbytes, ops, FP32_FLOPS_PER_S)
        out[name] = {"bound_ms": ms, "bound_by": by}
    return out

# -- kernels against their plain versions ------------------------------------

OLMO_KN = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 1536))
FUSED_M = (4, 32, 1280)   # decode, a prefill chunk, a static prefill of 4 x 320


def check_fused(torch, dev, timer):
    """The fused kernel against its plain versions on the card, bitwise:
    the (acc, scales) form at M in FUSED_M (and a ragged M = 37, K = 200,
    N = 100), olmo-1b's (K, N), w2/w4/w8, a8 signed and a4 unsigned,
    every plane_lo (0-3 on w8, the speculative drafts' 2 and 3 included,
    0-1 on w4), float32 and bfloat16 rows; the dequant form against
    ``(acc.float() * xs * ws).to(dtype)`` (``ref.packed_matmul_ref``) at
    M in FUSED_M, float32 and bfloat16, every plane_lo, written at a column
    offset of a wider output; and a two-group leaf through
    ``ops.packed_matmul`` (8-bit group at column 0, the low group at
    column n8, on one row pass). Times the (acc, scales) form at decode
    (M = 4) and at a static prefill (M = 1280) with float32 rows (the
    shapes earlier PRs timed), the bfloat16 rows the serving path gives
    it, and the dequant form at both M."""
    from repro_torch.core.bitplane import pack_weights, unpack_weights
    from repro_torch.kernels import fused_matmul, ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = deq = 0

    def codes_of(K, N, bits):
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
        c = torch.randint(lo, hi, (K, N), generator=gen, device=dev, dtype=torch.int32)
        return pack_weights(c, bits, axis=0)

    shapes = [(M, K, N) for M in FUSED_M for K, N in OLMO_KN[:3]] + [(37, 200, 100)]
    for M, K, N in shapes:
        for bits in (2, 4, 8):
            packed = codes_of(K, N, bits)
            scale = torch.rand((1, N), generator=gen, device=dev) * 0.01
            x = torch.randn((M, K), generator=gen, device=dev)
            for a_bits, signed in ((8, True), (4, False)):
                for dtype in (torch.float32, torch.bfloat16):
                    xs = (x if signed else x.abs()).to(dtype)
                    for plane_lo in range(bits // 2):
                        kw = dict(w_bits=bits, a_bits=a_bits, act_signed=signed,
                                  w_plane_lo=plane_lo)
                        what = (f"fused M={M} K={K} N={N} w{bits} a{a_bits} signed={signed} "
                                f"lo={plane_lo} {dtype} plan={fused_matmul.plan(M, K, N)}")
                        acc, s = fused_matmul.launch(xs, packed, **kw)
                        acc_r, s_r = ref.fused_quantize_matmul_ref(xs.float(), packed, **kw)
                        torch.cuda.synchronize()
                        if not (torch.equal(acc, acc_r) and torch.equal(s, s_r)):
                            raise AssertionError(
                                f"{what}: {(acc != acc_r).sum().item()} acc mismatches, "
                                f"scales equal={torch.equal(s, s_r)}")
                        cases += 1
                        if a_bits != 8:
                            continue
                        out = torch.full((M, N + 24), float("nan"), dtype=dtype, device=dev)
                        fused_matmul.launch_dequant(xs, packed, scale, out, col=16, **kw)
                        want = ref.packed_matmul_ref(xs, packed, scale, **kw)
                        torch.cuda.synchronize()
                        if not (torch.equal(out[:, 16:16 + N], want)
                                and out[:, :16].isnan().all() and out[:, 16 + N:].isnan().all()):
                            raise AssertionError(f"{what}: the dequant form is not bitwise "
                                                 f"(acc * xs * ws).to(dtype) at column 16")
                        deq += 1
    # A two-group leaf (8-bit codes first, then the low group), unsigned
    # and plane-truncated: one output, no concatenation.
    for M in FUSED_M:
        K, N8, NL = 2048, 512, 1536
        p8, pl = codes_of(K, N8, 8), codes_of(K, NL, 4)
        s8 = torch.rand((1, N8), generator=gen, device=dev) * 0.01
        sl = torch.rand((1, NL), generator=gen, device=dev) * 0.01
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            for signed, lo in ((False, 0), (True, 1)):
                kw = dict(a_bits=8, act_signed=signed, w_plane_lo=lo)
                xs = x if signed else x.abs()
                got = ops.packed_matmul(xs, pl, sl, w_bits=4, packed8=p8, scale8=s8, **kw)
                want = torch.cat([ref.packed_matmul_ref(xs, p8, s8, w_bits=8, **kw),
                                  ref.packed_matmul_ref(xs, pl, sl, w_bits=4, **kw)], dim=1)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"packed_matmul two-group leaf M={M} {dtype} "
                                         f"signed={signed} lo={lo}: not bitwise")
                deq += 1
    log(f"fused_quantize_matmul: {cases} (acc, scales) cases (M in {FUSED_M} and 37, "
        f"float32 and bfloat16 rows, plane_lo 0-3 on w8 and 0-1 on w4) and {deq} dequant "
        "cases (a column offset, two-group leaves) bitwise equal to the plain versions")

    # Timing: w_up/w_gate of a w4a8 layer (2048 -> 8192) at decode and at
    # a static prefill (M = 4 x 320). Library: torch.matmul on bf16
    # weights at decode, torch._int_mm on the unpacked codes at prefill
    # (the activations' quantization not counted).
    K, N = 2048, 8192
    packed = codes_of(K, N, 4)
    scale = torch.rand((1, N), generator=gen, device=dev) * 0.01
    kw = dict(w_bits=4, a_bits=8, act_signed=True, w_plane_lo=0)
    w_bf16 = (unpack_weights(packed, 4).float() * 0.01).to(torch.bfloat16)
    w8 = unpack_weights(packed, 4).to(torch.int8).contiguous()
    entries = {}
    for name, M in (("decode", 4), ("prefill", 1280)):
        x = torch.randn((M, K), generator=gen, device=dev)
        xb = x.to(torch.bfloat16)
        nbytes = M * K * 4 + K * N * 4 // 8 + M * N * 4 + M * 4
        b_ms, b_by = bound_ms(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
        if name == "decode":
            lib_ms, lib = timer(lambda: torch.matmul(xb, w_bf16)), "torch.matmul, bf16 W"
        else:
            xq = ref.quantize_rows_ref(x, 8, True)[0]
            lib_ms = timer(lambda: torch._int_mm(xq, w8))
            lib = "torch._int_mm on the codes (quantization not counted)"
        entries[name] = {
            "ms": timer(lambda: fused_matmul.launch(x, packed, **kw)),
            "plain_ms": timer(lambda: ref.fused_quantize_matmul_ref(x, packed, **kw)),
            "library_ms": lib_ms, "library": lib, "bound_ms": b_ms, "bound_by": b_by,
            "plan": fused_matmul.plan(M, K, N)._asdict(),
            "shape": f"M={M} K={K} N={N} w4a8 f32 rows"}
        # The serving path's bf16 rows, and the dequant form writing bf16.
        out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        nbytes = M * K * 2 + K * N * 4 // 8 + M * N * 2 + N * 4
        b_ms, b_by = bound_ms(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
        entries[f"{name}_bf16"] = {
            "ms": timer(lambda: fused_matmul.launch(xb, packed, **kw)),
            "plain_ms": timer(lambda: ref.fused_quantize_matmul_ref(xb.float(), packed, **kw)),
            "library_ms": lib_ms, "library": lib, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"M={M} K={K} N={N} w4a8 bf16 rows"}
        entries[f"{name}_dequant"] = {
            "ms": timer(lambda: fused_matmul.launch_dequant(xb, packed, scale, out, **kw)),
            "plain_ms": timer(lambda: ref.packed_matmul_ref(xb, packed, scale, **kw)),
            "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
            "library": "torch.matmul, bf16 W", "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"M={M} K={K} N={N} w4a8 bf16 rows -> bf16 y"}
    return {**entries["decode"], "max_abs_err": 0.0, "cases": cases, "dequant_cases": deq,
            "entries": entries}


def _pool(torch, dev, gen, nb, bs, nkv, H, quant):
    kf = torch.randn((nb, bs, nkv, H), generator=gen, device=dev)
    vf = torch.randn((nb, bs, nkv, H), generator=gen, device=dev)
    if quant:
        from repro_torch.models.kv_cache import quantize_kv

        pk, ks = quantize_kv(kf)
        pv, vs = quantize_kv(vf)
        return pk, pv, ks, vs
    return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None


def _close(torch, got, want, what, tol=ATOL):
    g, w = got.float(), want.float()
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        err = (g - w).abs().max().item()
        raise AssertionError(f"{what}: max |err| {err} beyond atol=rtol={tol}")
    return (g - w).abs().max().item()


def check_paged_attention(torch, dev, timer):
    from repro_torch.kernels import paged_attention, ref

    gen = torch.Generator(device=dev).manual_seed(2)
    B, nkv, G, H, bs, maxb = 4, 16, 1, 128, 16, 32
    ctx = [512, 300, 37, 0]               # ragged; the last row is freed
    nb = B * maxb + 1
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = torch.full((B, maxb), -1, dtype=torch.int32, device=dev)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // bs)
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    pos = torch.tensor([max(c - 1, 0) for c in ctx], dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, nkv * G, H), generator=gen, device=dev).to(torch.bfloat16)
    out = {}
    max_err = 0.0
    for quant in (False, True):
        pk, pv, ks, vs = _pool(torch, dev, gen, nb, bs, nkv, H, quant)
        got = paged_attention.launch(q, pk, pv, table, pos, ks, vs)
        want = ref.paged_attention_ref(q, pk, pv, table, pos, ks, vs)
        torch.cuda.synchronize()
        if not bool((got[3] == 0).all()):
            raise AssertionError("paged_attention: the all -1 row is not zero")
        max_err = max(max_err, _close(torch, got, want,
                                      f"paged_attention quant={quant}"))
        out[quant] = (pk, pv, ks, vs)
    log(f"paged_attention: bf16 and int8 pools within atol=rtol={ATOL} "
        f"(max |err| {max_err:.3g}), all -1 row zero")

    # The contiguous-cache entry (launch_contig) on the same keys laid out
    # as the static engine's cache: within tolerance of its plain version,
    # and bitwise the paged kernel (one tile routine).
    from repro_torch.models.common import decode_attention as decode_plain

    S = maxb * bs + 8
    tbl = table.clamp(min=0).long()
    for quant in (False, True):
        pk, pv, ks, vs = out[quant]
        contig = [None if a is None else
                  torch.nn.functional.pad(a[tbl].reshape(B, maxb * bs, *a.shape[2:]),
                                          (0, 0) * (a.ndim - 2) + (0, 8))
                  for a in (pk, pv, ks, vs)]
        slots = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
        kpos = torch.where(slots < torch.tensor(ctx, device=dev)[:, None], slots, -1)
        kpos = kpos.to(torch.int32).contiguous()
        got = paged_attention.launch_contig(q, contig[0], contig[1], kpos, pos,
                                            contig[2], contig[3])
        want = decode_plain(q, contig[0], contig[1], kpos, pos, k_scale=contig[2],
                            v_scale=contig[3])
        paged_out = paged_attention.launch(q, pk, pv, table, pos, ks, vs)
        torch.cuda.synchronize()
        max_err = max(max_err, _close(torch, got[:3], want[:3],
                                      f"contig_attention quant={quant}"))
        if not torch.equal(got, paged_out):
            raise AssertionError(f"contig_attention quant={quant}: not bitwise the "
                                 "paged kernel on the same keys")
    log(f"contig_attention (contiguous cache): bf16 and int8 within atol=rtol={ATOL} "
        f"of its plain version, bitwise the paged kernel on the same keys")

    pk, pv, _, _ = out[False]
    ms = timer(lambda: paged_attention.launch(q, pk, pv, table, pos))
    plain_ms = timer(lambda: ref.paged_attention_ref(q, pk, pv, table, pos))
    # Yardstick: SDPA over an already contiguous copy of the same K/V.
    S = maxb * bs
    tbl = table.clamp(min=0).long()
    kc = pk[tbl].reshape(B, S, nkv, H).transpose(1, 2).contiguous()
    vc = pv[tbl].reshape(B, S, nkv, H).transpose(1, 2).contiguous()
    kpos = torch.arange(S, device=dev)
    mask = ((kpos[None, :] <= pos[:, None]) & (table >= 0).repeat_interleave(bs, 1))
    mask = mask[:, None, None, :]
    qs = q.transpose(1, 2)
    F = torch.nn.functional
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask))
    live = sum(-(-c // bs) for c in ctx)
    kv_bytes = live * bs * nkv * H * 2 * 2
    nbytes = q.numel() * 2 * 2 + kv_bytes + table.numel() * 4 + B * 4
    flops = 4 * nkv * G * H * sum(ctx)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    paged = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "bound_ms": b_ms, "bound_by": b_by,
             "shape": f"B={B} ctx={ctx} NQ=NKV={nkv} H={H} bs={bs} bf16"}
    contig = time_contig_attention(torch, dev, timer, gen)
    return {**paged, "max_abs_err": max_err,
            "entries": {"paged": paged, "contiguous": contig}}


def time_contig_attention(torch, dev, timer, gen):
    """paged_attention's contiguous entry at the static engine's decode
    shape on full-size olmo-1b: a batch of 4 (prompts 64/320/128/256, the
    first static batch of the serve runs) 16 tokens into its decode, over
    a 384-slot bf16 cache (the 320-token bucket plus headroom, grown to
    the next bucket); each row sees its slots 0..q_pos. Times the kernel,
    its plain version (``common.decode_attention``) and SDPA on the same
    cache."""
    from repro_torch.kernels import paged_attention
    from repro_torch.models.common import decode_attention as decode_plain

    B, S, nkv, H = 4, 384, 16, 128
    ctx = [80, 336, 144, 272]
    q = torch.randn((B, 1, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((B, S, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    live = slots < torch.tensor(ctx, device=dev)[:, None]
    kpos = torch.where(live, slots, -1).to(torch.int32).contiguous()
    pos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32, device=dev)
    ms = timer(lambda: paged_attention.launch_contig(q, kc, vc, kpos, pos))
    plain_ms = timer(lambda: decode_plain(q, kc, vc, kpos, pos))
    mask = live[:, None, None, :]
    qs, ks, vs = (t.transpose(1, 2) for t in (q, kc, vc))
    F = torch.nn.functional
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    # Each row reads its visible keys' K/V and slot positions once.
    nbytes = q.numel() * 2 * 2 + sum(ctx) * (nkv * H * 2 * 2 + 4) + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * nkv * H * sum(ctx), BF16_FLOPS_PER_S)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "shape": f"B={B} S={S} ctx={ctx} NQ=NKV={nkv} H={H} bf16"}


def check_paged_prefill(torch, dev, timer):
    from repro_torch.kernels import paged_prefill, ref

    gen = torch.Generator(device=dev).manual_seed(3)
    nkv, G, H, bs, Lc, mb = 16, 1, 128, 16, 32, 24
    nb = mb + 8
    blocks = (torch.randperm(nb - 1, generator=gen, device=dev)[:mb] + 1).to(torch.int32)
    max_err = 0.0
    for quant in (False, True):
        for start, length in ((0, 32), (37, 32), (290, 20)):
            pk, pv, ks, vs = _pool(torch, dev, gen, nb, bs, nkv, H, quant)
            q = torch.randn((1, Lc, nkv * G, H), generator=gen, device=dev).to(torch.bfloat16)
            kn = torch.randn((1, Lc, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
            vn = torch.randn((1, Lc, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
            cover = -(-(start + length) // bs)
            blk = blocks.clone()
            blk[cover:] = -1
            planes = [t.clone() if t is not None else None for t in (pk, pv, ks, vs)]
            got = paged_prefill.launch(q, kn, vn, *planes[:2], blk, start, length,
                                       planes[2], planes[3])
            want = ref.paged_prefill_ref(q, kn, vn, pk, pv, blk, start, length, ks, vs)
            torch.cuda.synchronize()
            what = f"paged_prefill quant={quant} start={start} length={length}"
            max_err = max(max_err, _close(torch, got[0], want[0], what))
            if not bool((got[0][0, length:] == 0).all()):
                raise AssertionError(f"{what}: padded queries are not zero")
            for name, g, w in zip(("pool_k", "pool_v", "k_scale", "v_scale"),
                                  got[1:], want[1:]):
                if w is not None and not torch.equal(g[1:], w[1:]):
                    raise AssertionError(f"{what}: {name} differs (trash block skipped)")
    log(f"paged_prefill: cold and mid-block chunks, bf16 and int8 pools: pool "
        f"bytes and scale planes bitwise, attention within atol=rtol={ATOL} "
        f"(max |err| {max_err:.3g})")
    max_err = max(max_err, check_paged_prefill_read_only(torch, dev, gen))

    start, length = 256, 32
    pk, pv, _, _ = _pool(torch, dev, gen, nb, bs, nkv, H, False)
    q = torch.randn((1, Lc, nkv * G, H), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((1, Lc, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((1, Lc, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
    cover = -(-(start + length) // bs)
    blk = blocks[:cover].contiguous()
    ms = timer(lambda: paged_prefill.launch(q, kn, vn, pk, pv, blk, start, length))
    plain_ms = timer(lambda: ref.paged_prefill_ref(q, kn, vn, pk, pv, blk, start, length))
    S = start + length
    kc = pk[blk.long()].reshape(1, cover * bs, nkv, H)[:, :S].transpose(1, 2).contiguous()
    vc = pv[blk.long()].reshape(1, cover * bs, nkv, H)[:, :S].transpose(1, 2).contiguous()
    qi = torch.arange(Lc, device=dev)[:, None] + start
    mask = torch.arange(S, device=dev)[None, :] <= qi
    qs = q.transpose(1, 2)
    F = torch.nn.functional
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask))
    elem = nkv * H * 2
    nbytes = (q.numel() + kn.numel() + vn.numel()) * 2 + start * elem * 2 \
        + length * elem * 2 + q.numel() * 2 + blk.numel() * 4
    flops = 4 * nkv * G * H * sum(start + i + 1 for i in range(length))
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    # The read-only form as a whole-prompt prefix hit runs it: the last
    # token of a resident 384-token prompt over its blocks, nothing written.
    blk = blocks.contiguous()
    S = blk.shape[0] * bs
    ro_start = S - 1
    q1, k1, v1 = q[:, :1].contiguous(), kn[:, :1].contiguous(), vn[:, :1].contiguous()
    ro_got = paged_prefill.launch(q1, k1, v1, pk, pv, blk, ro_start, 1, store=False)[0]
    ro_want = ref.paged_prefill_ref(q1, k1, v1, pk, pv, blk, ro_start, 1, store=False)[0]
    torch.cuda.synchronize()
    ro_err = _close(torch, ro_got, ro_want,
                    f"paged_prefill store=False timed shape (Lc=1 at {ro_start})")
    max_err = max(max_err, ro_err)
    ro_ms = timer(lambda: paged_prefill.launch(q1, k1, v1, pk, pv, blk, ro_start, 1,
                                               store=False))
    ro_plain = timer(lambda: ref.paged_prefill_ref(q1, k1, v1, pk, pv, blk, ro_start, 1,
                                                   store=False))
    kc = pk[blk.long()].reshape(1, S, nkv, H).transpose(1, 2).contiguous()
    vc = pv[blk.long()].reshape(1, S, nkv, H).transpose(1, 2).contiguous()
    qs1 = q1.transpose(1, 2)
    ro_lib = timer(lambda: F.scaled_dot_product_attention(qs1, kc, vc))
    ro_bound = bound_ms(2 * q1.numel() * 2 + S * elem * 2 + blk.numel() * 4,
                        4 * nkv * G * H * S, BF16_FLOPS_PER_S)
    read_only = {"ms": ro_ms, "plain_ms": ro_plain, "library_ms": ro_lib,
                 "max_abs_err": ro_err, "bound_ms": ro_bound[0], "bound_by": ro_bound[1],
                 "shape": f"store=False, Lc=1 at {ro_start} (a resident {S}-token prompt) "
                          f"NQ=NKV={nkv} H={H} bs={bs} bf16"}
    verify = check_paged_prefill_verify(torch, dev, timer, gen)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max(max_err, verify["max_abs_err"]),
            "shape": f"Lc={Lc} start={start} NQ=NKV={nkv} H={H} bs={bs} bf16",
            "entries": {"read_only": read_only, "verify": verify}}


def check_paged_prefill_verify(torch, dev, timer, gen):
    """The speculative verify call's shape: a chunk of Lc = 5 (the current
    token and 4 drafts) at start 300 on a bf16 pool whose positions
    300-303 a draft already wrote (other K/V, one decode-style write a
    position): the kernel overwrites the draft's bytes with the chunk's
    (bitwise the plain version's pool), its output within atol=rtol of
    the plain version. Timed against the plain version and SDPA over the
    same 305 keys. Returns the entry; its ``launches`` are filled from the
    serve runs' verify rows."""
    from repro_torch.kernels import paged_prefill, ref
    from repro_torch.models.kv_cache import paged_cache_write

    nkv, H, bs, Lc, start = 16, 128, 16, 5, 300
    mb = -(-(start + Lc) // bs)
    nb = mb + 4
    blk = (torch.randperm(nb - 1, generator=gen, device=dev)[:mb] + 1).to(torch.int32)
    pk, pv, _, _ = _pool(torch, dev, gen, nb, bs, nkv, H, False)
    q, kn, vn = (torch.randn((1, Lc, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(3))
    table = blk[None]
    for i in range(Lc - 1):           # the draft's writes at 300..303
        kd, vd = (torch.randn((1, 1, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        paged_cache_write(pk, pv, table, kd, vd,
                          torch.tensor([start + i], dtype=torch.int32, device=dev), bs)
    wk, wv = pk.clone(), pv.clone()
    got = paged_prefill.launch(q, kn, vn, pk, pv, blk, start, Lc)
    want = ref.paged_prefill_ref(q, kn, vn, wk, wv, blk, start, Lc)
    torch.cuda.synchronize()
    what = f"paged_prefill verify (Lc={Lc} at {start} over draft-written positions)"
    err = _close(torch, got[0], want[0], what)
    if not (torch.equal(pk[1:], want[1][1:]) and torch.equal(pv[1:], want[2][1:])):
        raise AssertionError(f"{what}: the pool is not bitwise the plain version's")
    ms = timer(lambda: paged_prefill.launch(q, kn, vn, pk, pv, blk, start, Lc))
    plain_ms = timer(lambda: ref.paged_prefill_ref(q, kn, vn, pk, pv, blk, start, Lc))
    S = start + Lc
    kc = pk[blk.long()].reshape(1, mb * bs, nkv, H)[:, :S].transpose(1, 2).contiguous()
    vc = pv[blk.long()].reshape(1, mb * bs, nkv, H)[:, :S].transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, :]
            <= torch.arange(Lc, device=dev)[:, None] + start)
    qs = q.transpose(1, 2)
    F = torch.nn.functional
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask))
    elem = nkv * H * 2
    nbytes = 3 * q.numel() * 2 + start * elem * 2 + Lc * elem * 2 + q.numel() * 2 \
        + blk.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 4 * nkv * H * sum(start + i + 1 for i in range(Lc)),
                          BF16_FLOPS_PER_S)
    log(f"paged_prefill verify: Lc={Lc} at {start} over draft-written positions: pool "
        f"bitwise the plain version's, max |err| {err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"verify Lc={Lc} at {start} over draft-written positions, "
                     f"NQ=NKV={nkv} H={H} bs={bs} bf16"}


def check_paged_prefill_read_only(torch, dev, gen):
    """The store=False form (a whole-prompt prefix hit's last token over
    shared blocks), bf16 and int8 pools: a chunk stored first, then the
    same chunk read-only gives bitwise the stored call's output and
    leaves every pool byte and scale unchanged; within atol=rtol of the
    plain store=False version. Cases: a 32-row chunk (20 live rows, and
    one), and the serve path's own shape, one query row (Lc = 1) at the
    last token of resident prompts, in the middle and at the end of a
    block and past one 512-key span. Returns the max |err| against the
    plain version."""
    from repro_torch.kernels import paged_prefill, ref

    nkv, H, bs = 16, 128, 16
    nb = 48
    blocks = (torch.randperm(nb - 1, generator=gen, device=dev)[:nb - 8] + 1).to(torch.int32)
    worst = 0.0
    for quant in (False, True):
        for Lc, start, length in ((32, 290, 20), (32, 243, 1), (1, 243, 1), (1, 263, 1),
                                  (1, 383, 1), (1, 519, 1)):
            pk, pv, ks, vs = _pool(torch, dev, gen, nb, bs, nkv, H, quant)
            q, kn, vn = (torch.randn((1, Lc, nkv, H), generator=gen, device=dev)
                         .to(torch.bfloat16) for _ in range(3))
            blk = blocks.clone()
            blk[-(-(start + length) // bs):] = -1
            stored = paged_prefill.launch(q, kn, vn, pk, pv, blk, start, length, ks, vs)[0]
            before = [t.clone() for t in (pk, pv, ks, vs) if t is not None]
            got = paged_prefill.launch(q, kn, vn, pk, pv, blk, start, length, ks, vs,
                                       store=False)[0]
            want = ref.paged_prefill_ref(q, kn, vn, pk, pv, blk, start, length, ks, vs,
                                         store=False)[0]
            torch.cuda.synchronize()
            what = (f"paged_prefill store=False quant={quant} Lc={Lc} start={start} "
                    f"length={length}")
            if not torch.equal(got, stored):
                raise AssertionError(f"{what}: differs from the storing call")
            after = [t for t in (pk, pv, ks, vs) if t is not None]
            if not all(torch.equal(a, b) for a, b in zip(before, after)):
                raise AssertionError(f"{what}: the pool changed")
            worst = max(worst, _close(torch, got, want, what))
    log(f"paged_prefill store=False: Lc=32 (length 20, 1) and Lc=1 at 243, 263, 383, "
        f"519, bf16 and int8 pools: bitwise the storing call, pool unchanged, within "
        f"atol=rtol={ATOL} of its plain version (max |err| {worst:.3g})")
    return worst


# olmo-1b's rows, a ragged K, rows of no whole vector, and rows past one
# span of 16 384 values, which the kernel walks twice: two spans, three
# with element loads, and nemotron-4-340b's d_ff (five).
QUANT_K = (2048, 8192, 200, 203, 20480, 40003, 73728)


def check_quantize_rows(torch, dev, timer):
    """quantize_rows against its plain version, bitwise: float32 and
    bfloat16 rows (the bf16 codes are those of the rows as float32), M in
    {4, 1280}, K in QUANT_K (203: the kernel's element-load path), bits
    2..8 signed and unsigned, an all-zero row. Times M = 1280, K = 2048,
    a6 with float32 rows (the shape earlier PRs timed) and with the
    serving path's bfloat16 rows, and decode (M = 4, bf16 rows)."""
    from repro_torch.kernels import pack_quant, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    cases = 0
    for M in (4, 1280):
        for K in QUANT_K:
            x = torch.randn((M, K), generator=gen, device=dev) * 3
            x[1] = 0                                  # an all-zero row
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                for bits in range(2, 9):
                    for signed in (True, False):
                        got = pack_quant.launch(xd, bits=bits, signed=signed)
                        want = ref.quantize_rows_ref(xd, bits, signed)
                        torch.cuda.synchronize()
                        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                            raise AssertionError(
                                f"quantize_rows M={M} K={K} {dtype} bits={bits} "
                                f"signed={signed}: {(got[0] != want[0]).sum().item()} code "
                                f"mismatches, scales equal={torch.equal(got[1], want[1])}")
                        cases += 1
    log(f"quantize_rows: {cases} cases (M in {{4, 1280}}, K in {QUANT_K}, float32 and "
        "bfloat16 rows, bits 2..8, signed and unsigned) bitwise equal to the plain version")

    K, bits = 2048, 6              # a w4a6r25 layer's rows
    entries = {}
    for name, M, dtype in (("prefill", 1280, torch.float32),
                           ("prefill_bf16", 1280, torch.bfloat16),
                           ("decode", 4, torch.bfloat16)):
        x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        nbytes = M * K * x.element_size() + M * K + M * 4
        b_ms, b_by = bound_ms(nbytes, 6 * M * K, FP32_FLOPS_PER_S)
        entries[name] = {
            "ms": timer(lambda: pack_quant.launch(x, bits=bits, signed=True)),
            "plain_ms": timer(lambda: ref.quantize_rows_ref(x, bits, True)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"M={M} K={K} a{bits} signed, {str(dtype)[6:]} rows"}
    return {**entries["prefill"], "max_abs_err": 0.0, "cases": cases, "entries": entries}


BITPLANE_M = (4, 17, 64, 200, 1280)   # each plan switch (32/64/128 rows), a ragged tile
BITPLANE_RAGGED = (37, 200, 100)       # (M, K, N): no 16-byte rows, partial tiles


def int_mm_time(torch, timer, xq, w8):
    """torch._int_mm's time on xq, or, where xq has fewer rows than it
    accepts (more than 16 on CUDA), on xq padded with zero rows to the
    smallest M it takes: returns (ms, M timed)."""
    for m in (xq.shape[0], 17, 24, 32):
        if m < xq.shape[0]:
            continue
        xm = torch.nn.functional.pad(xq, (0, 0, 0, m - xq.shape[0]))
        try:
            torch._int_mm(xm, w8)
        except RuntimeError:
            continue
        return timer(lambda: torch._int_mm(xm, w8)), m
    raise AssertionError(f"torch._int_mm takes none of the M tried for {tuple(xq.shape)}")


def check_bitplane(torch, dev, timer):
    from repro_torch.core.bitplane import pack_weights
    from repro_torch.kernels import bitplane_matmul, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    cases = 0

    def case(M, K, N, w_bits):
        nonlocal cases
        lo, hi = -(1 << (w_bits - 1)), (1 << (w_bits - 1))
        codes = torch.randint(lo, hi, (K, N), generator=gen, device=dev, dtype=torch.int32)
        packed = pack_weights(codes, w_bits, axis=0)
        for a_bits in (2, 4, 6, 8):
            for signed in (True, False):
                alo, ahi = ((-(1 << (a_bits - 1)), 1 << (a_bits - 1))
                            if signed else (0, 1 << a_bits))
                xq = torch.randint(alo, ahi, (M, K), generator=gen,
                                   device=dev, dtype=torch.int32).to(torch.int8)
                for plane_lo in range(w_bits // 2):
                    kw = dict(w_bits=w_bits, a_bits=a_bits,
                              act_signed=signed, w_plane_lo=plane_lo)
                    got = bitplane_matmul.launch(xq, packed, **kw)
                    want = ref.bitplane_matmul_ref(xq, packed, a_bits, signed,
                                                   plane_lo, w_bits=w_bits)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"bitplane M={M} K={K} N={N} w{w_bits} a{a_bits} "
                            f"signed={signed} lo={plane_lo} plan={bitplane_matmul.plan(M, K, N)}: "
                            f"{(got != want).sum().item()} mismatches")
                    cases += 1

    for M in BITPLANE_M:
        for K, N in OLMO_KN:
            for w_bits in (2, 4, 8):
                case(M, K, N, w_bits)
    for w_bits in (2, 4, 8):
        case(*BITPLANE_RAGGED, w_bits)
    log(f"bitplane_matmul: {cases} cases (M in {BITPLANE_M}, (K, N) in {OLMO_KN}, and "
        f"(M, K, N) = {BITPLANE_RAGGED}; w2/w4/w8, a2/4/6/8 signed and unsigned, plane_lo "
        "0-1 on w4 and 0-3 on w8) bitwise equal to the plain version")

    # Timing: the dequant entry, the one the serving path launches, at the
    # two groups of a w4a6r25 w_up (2048 -> 8192: n8 = 2048 8-bit columns,
    # then 6144 4-bit ones) with a bf16 output at their column offsets, at
    # static prefill (M = 4·320) and decode (M = 4); beside each, the int32
    # entry on the same operands (its zero fill included where the plan
    # splits K). The headline is the 4-bit group at M = 1280. Then the int32
    # entry's own rows at the 4-bit group's shape, as earlier PRs timed it.
    K, n8, nl = 2048, 2048, 6144
    groups = {}
    for wb, n in ((8, n8), (4, nl)):
        lo = -(1 << (wb - 1))
        codes = torch.randint(lo, -lo, (K, n), generator=gen, device=dev, dtype=torch.int32)
        packed = codes.to(torch.int8) if wb == 8 else pack_weights(codes, wb, axis=0)
        ws = torch.rand((n,), generator=gen, device=dev) * 1e-2 + 1e-4
        groups[wb] = (packed, codes.to(torch.int8).contiguous(), ws)
    entries = {}
    for M, when in ((1280, "prefill"), (4, "decode")):
        xq = torch.randint(-32, 32, (M, K), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        xs = torch.rand((M, 1), generator=gen, device=dev) * 1e-2
        out = torch.empty((M, n8 + nl), dtype=torch.bfloat16, device=dev)
        for wb, col in ((4, n8), (8, 0)):
            packed, w8, ws = groups[wb]
            n = w8.shape[1]
            kw = dict(w_bits=wb, a_bits=6)
            ikw = dict(kw, act_signed=True, w_plane_lo=0)

            def plain():
                acc = ref.bitplane_matmul_ref(xq, packed, 6, True, 0, w_bits=wb)
                return ((acc.to(torch.float32) * xs) * ws).to(torch.bfloat16)

            bitplane_matmul.launch_dequant(xq, packed, xs, ws, out, col=col, **kw)
            if not torch.equal(out[:, col:col + n], plain()):
                raise AssertionError(f"bitplane_matmul dequant M={M} w{wb} N={n}: not "
                                     "bitwise the plain version")
            lib_ms, lib_m = int_mm_time(torch, timer, xq, w8)
            nbytes = M * K + K * n * wb // 8 + n * 4 + M * 4 + M * n * 2
            b_ms, b_by = bound_ms(nbytes, 2 * M * K * n, INT8_OPS_PER_S)
            name = when if wb == 4 else f"{when}_w8"
            entries[name] = {
                "ms": timer(lambda: bitplane_matmul.launch_dequant(xq, packed, xs, ws, out,
                                                                   col=col, **kw)),
                "int32_entry_ms": timer(lambda: bitplane_matmul.launch(xq, packed, **ikw)),
                "plain_ms": timer(plain), "library_ms": lib_ms,
                "library": f"torch._int_mm at M={lib_m} (int32 out)",
                "bound_ms": b_ms, "bound_by": b_by,
                "plan": bitplane_matmul.plan(M, K, n)._asdict(),
                "shape": f"dequant M={M} K={K} N={n} w{wb}a6 -> bf16 y at column {col}"}
        packed, w8, _ = groups[4]
        ikw = dict(w_bits=4, a_bits=6, act_signed=True, w_plane_lo=0)
        lib_ms, lib_m = int_mm_time(torch, timer, xq, w8)
        b_ms, b_by = bound_ms(M * K + K * nl // 2 + M * nl * 4, 2 * M * K * nl,
                              INT8_OPS_PER_S)
        entries[f"int32_{when}"] = {
            "ms": timer(lambda: bitplane_matmul.launch(xq, packed, **ikw)),
            "plain_ms": timer(lambda: ref.bitplane_matmul_ref(xq, packed, 6, True, 0,
                                                              w_bits=4)),
            "library_ms": lib_ms, "library": f"torch._int_mm at M={lib_m}",
            "bound_ms": b_ms, "bound_by": b_by,
            "plan": bitplane_matmul.plan(M, K, nl)._asdict(),
            "shape": f"int32 entry M={M} K={K} N={nl} w4a6"}
    return {**entries["prefill"], "max_abs_err": 0.0, "cases": cases, "entries": entries}


TABLE3_M = (4, 8, 9, 17, 64, 200, 1280)   # unsplit and split plans, last block and fold


def check_mixed_group(torch, dev, timer):
    """The Table III leaf through ops.mixed_group_matmul on the card (one
    quantize_rows launch, then bitplane_matmul's dequant entry once per
    filter group, each writing its columns of one output), bitwise equal
    to the plain version (ref.mixed_group_matmul_ref, rounded once to x's
    dtype) and to the fused kernel's two-group route (ops.packed_matmul
    with packed8), which computes the same function: at M in TABLE3_M for
    olmo-1b's three Table III shapes at w4a6r25 and a ragged (37, 200,
    100), float32 and bfloat16 rows, each called twice in a row (a split
    counter left set would show in the second call). One leaf is written
    into a wider output whose other columns hold NaN, which must survive.
    Times the w_up leaf (2048 -> 8192) with bfloat16 rows at M = 4 and
    1280, beside the fused route on the same leaf."""
    from repro_torch.core.bitplane import unpack_weights
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.quantized_linear import pack_weight
    from repro_torch.kernels import bitplane_matmul, ops, pack_quant, ref

    gen = torch.Generator(device=dev).manual_seed(6)
    cfg = QuantConfig(w_bits=4, a_bits=6, mixed_ratio_8b=0.25)
    leaves = {}

    def leaf(K, N):
        """(packed weight, its mixed_group_matmul arguments, the low codes)."""
        if (K, N) not in leaves:
            w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
            pw = pack_weight(w, cfg)
            n8 = pw.n8
            leaves[K, N] = (pw, (pw.packed8, pw.packed, pw.scale[:, :n8], pw.scale[:, n8:]),
                            unpack_weights(pw.packed, 4))
        return leaves[K, N]

    def plain(x, K, N):
        pw, (p8, _, s8, sl), wl = leaf(K, N)
        return ref.mixed_group_matmul_ref(x, p8, wl, s8, sl, 6).to(x.dtype)

    def fused_route(x, K, N):
        pw, (p8, pl, s8, sl), _ = leaf(K, N)
        return ops.packed_matmul(x, pl, sl, w_bits=4, a_bits=6, packed8=p8, scale8=s8)

    cases = 0
    shapes = [(M, K, N) for M in TABLE3_M for K, N in OLMO_KN[:3]] + [(37, 200, 100)]
    for M, K, N in shapes:
        args = leaf(K, N)[1]
        x = torch.randn((M, K), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            want, fused = plain(xd, K, N), fused_route(xd, K, N)
            for call in range(2):
                got = ops.mixed_group_matmul(xd, *args, w_bits=4, a_bits=6)
                torch.cuda.synchronize()
                what = (f"mixed_group_matmul M={M} K={K} N={N} n8={args[0].shape[1]} {dtype} "
                        f"call {call + 1} plans {bitplane_matmul.plan(M, K, args[0].shape[1])} "
                        f"{bitplane_matmul.plan(M, K, args[1].shape[1])}")
                if not torch.equal(got, want):
                    raise AssertionError(f"{what}: {(got != want).sum().item()} elements "
                                         "differ from the plain version")
                if not torch.equal(got, fused):
                    raise AssertionError(f"{what}: {(got != fused).sum().item()} elements "
                                         "differ from the fused two-group route")
                cases += 1
    # A leaf written at a column offset of a wider output: its other
    # columns keep their NaN (col 3 of a float32 output: unaligned stores).
    K, N = 2048, 8192
    for M, dtype, col in ((4, torch.bfloat16, 16), (1280, torch.bfloat16, 16),
                          (9, torch.float32, 3)):
        p8, pl, s8, sl = leaf(K, N)[1]
        n8 = p8.shape[1]
        x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        xq, xs = pack_quant.launch(x, bits=6, signed=True)
        out = torch.full((M, N + 40), float("nan"), dtype=dtype, device=dev)
        bitplane_matmul.launch_dequant(xq, p8, xs, s8, out, col=col, w_bits=8, a_bits=6)
        bitplane_matmul.launch_dequant(xq, pl, xs, sl, out, col=col + n8, w_bits=4, a_bits=6)
        torch.cuda.synchronize()
        if not (torch.equal(out[:, col:col + N], plain(x, K, N))
                and out[:, :col].isnan().all() and out[:, col + N:].isnan().all()):
            raise AssertionError(f"bitplane_matmul dequant M={M} {dtype} at column {col}: "
                                 "not bitwise the plain version, or a sentinel was overwritten")
        cases += 1
    log(f"mixed_group_matmul (w4a6r25): {cases} cases (M in {TABLE3_M} at (K, N) in "
        f"{OLMO_KN[:3]}, and (37, 200, 100); float32 and bfloat16 rows; two calls each; a "
        "column offset) bitwise equal to the plain version and the fused two-group route")

    # Timing: the w_up leaf, bf16 rows (the serving path's) -> bf16 y.
    pw, args, _ = leaf(K, N)
    n8 = pw.n8
    w_bf16 = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
    entries = {}
    for name, M in (("table3_w_up_decode", 4), ("table3_w_up_prefill", 1280)):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        nbytes = K * n8 + K * (N - n8) * 4 // 8 + N * 4 + M * K * 2 + M * N * 2
        b_ms, b_by = bound_ms(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
        entries[name] = {
            "ms": timer(lambda: ops.mixed_group_matmul(x, *args, w_bits=4, a_bits=6)),
            "fused_route_ms": timer(lambda: fused_route(x, K, N)),
            "plain_ms": timer(lambda: plain(x, K, N)),
            "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
            "library": "torch.matmul, bf16 W", "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"M={M} {K}->{N} (n8={n8}) w4a6r25 bf16 rows -> bf16 y"}
    return {"cases": cases, "entries": entries}


def check_table3_launches(torch, dev):
    """A Table III leaf (w_up, bf16 rows) at decode (M = 4) and at a
    static prefill (M = 1280) under torch.profiler, after a warm call: its
    device work must be exactly one quantize_rows launch and two
    bitplane_matmul dequant launches, plus at most two fold launches at M
    = 1280 (none at M = 4), and nothing else: no copy, cast, product, fill
    or concatenation. Returns M -> the kernels' names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.quantized_linear import pack_weight
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(9)
    K, N = 2048, 8192
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    pw = pack_weight(w, QuantConfig(w_bits=4, a_bits=6, mixed_ratio_8b=0.25))
    args = (pw.packed8, pw.packed, pw.scale[:, :pw.n8], pw.scale[:, pw.n8:])
    seen = {}
    for M in (4, 1280):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        ops.mixed_group_matmul(x, *args, w_bits=4, a_bits=6)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ops.mixed_group_matmul(x, *args, w_bits=4, a_bits=6)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        n_q = sum("quantize_rows_kernel" in n for n in names)
        n_d = sum("imma_dequant_kernel" in n for n in names)
        n_f = sum("fold_kernel" in n for n in names)
        if (n_q, n_d) != (1, 2) or n_f > (2 if M > 8 else 0) or len(names) != n_q + n_d + n_f:
            raise AssertionError(f"Table III leaf at M={M}: device work {names}, not one "
                                 "quantize_rows, two dequant matmuls and at most two folds")
        seen[M] = names
    log("Table III leaf launches: " + "; ".join(
        f"M={M}: {', '.join(re.search(r'(\w+_kernel)', x).group(1) for x in n)}"
        for M, n in seen.items()))
    return seen


def check_flash(torch, dev, timer):
    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device=dev).manual_seed(7)
    B, H = 4, 128
    max_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases = 0
    for nq, nkv in ((16, 16), (16, 4)):
        for T in (37, 320):
            for qd, kd in ((torch.bfloat16, torch.bfloat16),
                           (torch.float32, torch.float32),
                           (torch.bfloat16, torch.float32)):
                for window in (0, 64):
                    for q_off in (0, 16):
                        Tk = T + q_off
                        q = torch.randn((B, T, nq, H), generator=gen, device=dev).to(qd)
                        k = torch.randn((B, Tk, nkv, H), generator=gen, device=dev).to(kd)
                        v = torch.randn((B, Tk, nkv, H), generator=gen, device=dev).to(kd)
                        kw = dict(causal=True, window=window, q_offset=q_off)
                        got = flash_attention.launch(q, k, v, **kw)
                        want = ref.flash_attention_gqa_ref(q, k, v, **kw)
                        torch.cuda.synchronize()
                        tol = ATOL if qd == torch.bfloat16 else F32_TOL
                        err = _close(torch, got, want, f"flash NQ={nq} NKV={nkv} "
                                     f"T={T} {qd}/{kd} window={window} q_offset={q_off}",
                                     tol)
                        max_err[qd] = max(max_err[qd], err)
                        cases += 1
    # A row's result does not depend on the length its batch was padded to.
    q = torch.randn((B, 64, 16, H), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, 64, 16, H), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, 64, 16, H), generator=gen, device=dev).to(torch.bfloat16)
    full = flash_attention.launch(q, k, v, causal=True, window=0, q_offset=0)
    cut = flash_attention.launch(q[:, :37].contiguous(), k[:, :37].contiguous(),
                                 v[:, :37].contiguous(), causal=True, window=0,
                                 q_offset=0)
    if not torch.equal(full[:, :37], cut):
        raise AssertionError("flash_attention: rows depend on the padded length")
    log(f"flash_attention: {cases} cases (B*NQ=64, H=128, T in {{37, 320}}, MHA and "
        "GQA, bf16 / f32 / bf16 q over f32 K/V, causal with and without a window, "
        f"q_offset 0/16) within atol=rtol={ATOL} (bf16, max |err| "
        f"{max_err[torch.bfloat16]:.3g}) and {F32_TOL} (f32, max |err| "
        f"{max_err[torch.float32]:.3g}); rows bitwise independent of padding")

    T = 320
    q = torch.randn((B, T, 16, H), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, T, 16, H), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, T, 16, H), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(causal=True, window=0, q_offset=0)
    ms = timer(lambda: flash_attention.launch(q, k, v, **kw))
    plain_ms = timer(lambda: ref.flash_attention_gqa_ref(q, k, v, **kw))
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    F = torch.nn.functional
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    nbytes = 4 * q.numel() * 2
    flops = 4 * B * 16 * H * (T * (T + 1) // 2)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "cases": cases,
            "max_abs_err": max(max_err.values()),
            "shape": f"B*NQ={B * 16} T={T} H={H} bf16 causal"}


# check_head_dims cases: (head dim, KV heads, query heads per KV head): 80
# and 256 under GQA, stablelm-12b's 160 (8 KV heads, G = 4) and
# nemotron-4-15b's G = 6 (8 KV heads, 48 query heads of 128).
HEAD_DIM_CASES = ((80, 4, 4), (256, 2, 8), (160, 8, 4), (128, 8, 6), (128, 8, 5),
                  (192, 8, 12))


def check_head_dims(torch, dev):
    """Each attention kernel against its plain version on each case of
    HEAD_DIM_CASES (bf16 and the int8 pool or cache): flash (T = 100),
    paged decode (contexts 300 / 70 / 0), contiguous decode and paged
    prefill (a 32-token chunk at 70), within atol = rtol = 2e-2."""
    from repro_torch.kernels import flash_attention, paged_attention, paged_prefill, ref
    from repro_torch.models.common import decode_attention as decode_plain

    gen = torch.Generator(device=dev).manual_seed(13)
    worst = 0.0
    for H, nkv, G in HEAD_DIM_CASES:
        nq = nkv * G
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = rnd(2, 100, nq, H), rnd(2, 100, nkv, H), rnd(2, 100, nkv, H)
        kw = dict(causal=True, window=0, q_offset=0)
        worst = max(worst, _close(torch, flash_attention.launch(q, k, v, **kw),
                                  ref.flash_attention_gqa_ref(q, k, v, **kw),
                                  f"flash H={H} G={G}"))
        bs, maxb, ctx = 16, 24, [300, 70, 0]
        B = len(ctx)
        table = torch.full((B, maxb), -1, dtype=torch.int32, device=dev)
        perm = (torch.randperm(B * maxb, generator=gen, device=dev) + 1).to(torch.int32)
        used = 0
        for b, c in enumerate(ctx):
            n = -(-c // bs)
            table[b, :n] = perm[used:used + n]
            used += n
        pos = torch.tensor([max(c - 1, 0) for c in ctx], dtype=torch.int32, device=dev)
        qd = rnd(B, 1, nq, H)
        for quant in (False, True):
            pk, pv, ks, vs = _pool(torch, dev, gen, B * maxb + 1, bs, nkv, H, quant)
            what = f"H={H} G={G} quant={quant}"
            got = paged_attention.launch(qd, pk, pv, table, pos, ks, vs)
            worst = max(worst, _close(torch, got, ref.paged_attention_ref(
                qd, pk, pv, table, pos, ks, vs), f"paged_attention {what}"))
            tbl = table.clamp(min=0).long()
            cc = [None if a is None else a[tbl].reshape(B, maxb * bs, *a.shape[2:])
                  for a in (pk, pv, ks, vs)]
            slots = torch.arange(maxb * bs, device=dev, dtype=torch.int32)[None]
            kpos = torch.where(slots < torch.tensor(ctx, device=dev)[:, None], slots, -1)
            kpos = kpos.to(torch.int32).contiguous()
            got = paged_attention.launch_contig(qd, cc[0], cc[1], kpos, pos, cc[2], cc[3])
            want = decode_plain(qd, cc[0], cc[1], kpos, pos, k_scale=cc[2], v_scale=cc[3])
            worst = max(worst, _close(torch, got[:2], want[:2], f"contig_attention {what}"))
            qc, kn, vn = rnd(1, 32, nq, H), rnd(1, 32, nkv, H), rnd(1, 32, nkv, H)
            blk = table[0, :-(-(70 + 32) // bs)].contiguous()
            planes = [None if t is None else t.clone() for t in (pk, pv, ks, vs)]
            got = paged_prefill.launch(qc, kn, vn, planes[0], planes[1], blk, 70, 32,
                                       planes[2], planes[3])
            want = ref.paged_prefill_ref(qc, kn, vn, pk, pv, blk, 70, 32, ks, vs)
            worst = max(worst, _close(torch, got[0], want[0], f"paged_prefill {what}"))
        torch.cuda.synchronize()
    log(f"head dims (H, NKV, G) {HEAD_DIM_CASES}: flash, paged and contiguous decode, "
        f"paged prefill, bf16 and int8, within atol=rtol={ATOL} of their plain versions "
        f"(max |err| {worst:.3g})")
    return worst


# check_one_order cases: (head dim, KV heads, query heads per KV head,
# prompt length, pool block sizes). The first is olmo-1b's head layout;
# the others span several splits (>= 600 keys) under GQA; the last two are
# stablelm-12b's (160, 8 KV heads, G = 4) and nemotron-4-15b's (128, 8 KV
# heads, G = 6).
ONE_ORDER_CASES = ((128, 16, 1, 200, (16, 64)), (80, 4, 4, 640, (16, 32)),
                   (256, 2, 8, 700, (32, 64)), (128, 4, 8, 610, (64,)),
                   (160, 8, 4, 620, (16, 32)), (128, 8, 6, 630, (16, 64)))


def check_one_order(torch, dev):
    """The attention kernels sum in one order (csrc/attend_tile.cuh): on
    each case of ONE_ORDER_CASES (bf16), chunked prefill (32-token chunks
    into pools of each block size), paged decode and contiguous decode of
    a token at position p are bitwise the whole-prompt flash kernel's row
    p. Every pool and cache starts filled with NaN, so the unwritten slots
    of a row's last block, the unallocated (-1) blocks past its table and
    the empty slots of the contiguous cache all hold NaN: a kernel that
    let one into its products would not be finite."""
    from repro_torch.kernels import flash_attention, paged_attention, paged_prefill

    gen = torch.Generator(device=dev).manual_seed(8)
    nan = float("nan")
    Lc = 32
    for H, nkv, G, T, sizes in ONE_ORDER_CASES:
        what = f"H={H} NKV={nkv} G={G} T={T}"
        q = torch.randn((1, T, nkv * G, H), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((1, T, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        whole = flash_attention.launch(q, k, v, causal=True, window=0, q_offset=0)
        ps = sorted({0, 31, 32, 63, 64, 100, T // 2, T - 2, T - 1})
        psd = torch.tensor(ps, dtype=torch.int32, device=dev)
        qd = q[0, psd.long()][:, None].contiguous()
        want = whole[0, psd.long()]
        if not bool(torch.isfinite(whole).all()):
            raise AssertionError(f"{what}: flash output not finite")
        for bs in sizes:
            nb = -(-T // bs)
            pk = torch.full((nb + 3, bs, nkv, H), nan, dtype=torch.bfloat16, device=dev)
            pv = torch.full_like(pk, nan)
            blocks = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
            parts = []
            for start in range(0, T, Lc):
                t = min(Lc, T - start)
                qc, kc, vc = (torch.nn.functional.pad(a[:, start:start + t],
                                                      (0, 0, 0, 0, 0, Lc - t))
                              for a in (q, k, v))
                cover = -(-(start + t) // bs)
                parts.append(paged_prefill.launch(qc, kc, vc, pk, pv, blocks[:cover],
                                                  start, t)[0][:, :t])
            chunked = torch.cat(parts, dim=1)
            # Tables two blocks wider than the prompt, unallocated (-1) there.
            table = torch.cat([blocks, torch.full((2,), -1, dtype=torch.int32,
                                                  device=dev)])
            dec = paged_attention.launch(qd, pk, pv, table[None].expand(len(ps), nb + 2)
                                         .contiguous(), psd)
            torch.cuda.synchronize()
            if not torch.equal(chunked, whole):
                err = (chunked.float() - whole.float()).abs().max().item()
                raise AssertionError(f"{what} bs={bs}: chunked prefill is not bitwise "
                                     f"whole-prompt flash (max |err| {err})")
            if not torch.equal(dec[:, 0], want):
                raise AssertionError(f"{what} bs={bs}: paged decode is not bitwise "
                                     "flash's rows")
        S = T + 40                     # 40 empty slots past the prompt
        kcache, vcache = (torch.cat([a.expand(len(ps), T, nkv, H),
                                     torch.full((len(ps), S - T, nkv, H), nan,
                                                dtype=a.dtype, device=dev)], dim=1)
                          .contiguous() for a in (k, v))
        slots = torch.arange(S, dtype=torch.int32, device=dev)
        kpos = torch.where(slots < T, slots, -1)[None].expand(len(ps), S).contiguous()
        contig = paged_attention.launch_contig(qd, kcache, vcache, kpos, psd)
        torch.cuda.synchronize()
        if not torch.equal(contig[:, 0], want):
            raise AssertionError(f"{what}: contiguous decode is not bitwise flash's rows")
    log("one summation order: chunked prefill, paged decode and contiguous decode "
        "bitwise equal to whole-prompt flash attention on "
        + "; ".join(f"H={H} NKV={n} G={g} T={t} bs {'/'.join(map(str, b))}"
                    for H, n, g, t, b in ONE_ORDER_CASES)
        + " (NaN in every unwritten, unallocated and empty slot)")


WKV_TOL = 1e-4     # float32, inputs of unit scale: other summation orders


def check_wkv6(torch, dev, timer):
    """The wkv6 kernel against ``ref.wkv6_chunked_ref`` (and, at T = 1,
    ``ref.wkv6_step``) on the card: float32 outputs and final states
    within atol = rtol = 1e-4, at the full rwkv6-3b prefill shape (B = 4,
    T = 320, H = 40, K = V = 64, chunk 64, bf16 r/k/v), a T that is not a
    multiple of the chunk, the reduced width (K = 16), decays of 1e-6
    everywhere, the JAX test shapes at chunks 16 and 32, and one decode
    step from a random carried state; a prompt and the same prompt padded
    by 40 tokens (k = 0, w = 1) give bitwise equal outputs and states.
    Times the prefill (B = 4, T = 320) and the decode step (T = 1, the
    state carried in and out)."""
    from repro_torch.kernels import ref, wkv6

    gen = torch.Generator(device=dev).manual_seed(9)

    def inputs(B, T, H, K, dtype=torch.bfloat16, decay=None):
        r, k, v = ((torch.randn((B, T, H, K), generator=gen, device=dev) * 0.5).to(dtype)
                   for _ in range(3))
        w = (torch.full((B, T, H, K), decay, device=dev) if decay is not None else
             torch.rand((B, T, H, K), generator=gen, device=dev) * 0.499 + 0.5)
        u = torch.randn((H, K), generator=gen, device=dev) * 0.5
        s0 = torch.randn((B, H, K, K), generator=gen, device=dev) * 0.3
        return r, k, v, w, u, s0

    worst = 0.0
    cases = [((4, 320, 40, 64), 64, None), ((4, 100, 40, 64), 64, None),
             ((2, 70, 4, 16), 64, None), ((2, 64, 4, 16), 16, 1e-6),
             ((1, 64, 2, 16), 16, None), ((1, 96, 1, 8), 16, None),
             ((1, 33, 3, 32), 32, None), ((1, 64, 2, 16), 32, None)]
    for (B, T, H, K), chunk, decay in cases:
        for dtype in ((torch.bfloat16, torch.float32) if K == 64 else (torch.float32,)):
            a = inputs(B, T, H, K, dtype, decay)
            got = wkv6.launch(*a, chunk=chunk)
            want = ref.wkv6_chunked_ref(*a, chunk)
            torch.cuda.synchronize()
            what = f"wkv6 B={B} T={T} H={H} K={K} chunk={chunk} {dtype} decay={decay}"
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{what}: not finite")
            worst = max(worst, _close(torch, got[0], want[0], what + " out", WKV_TOL),
                        _close(torch, got[1], want[1], what + " state", WKV_TOL))
    # One decode step from a carried state: the T = 1 kernel vs wkv6_step.
    r, k, v, w, u, s0 = inputs(4, 1, 40, 64)
    got = wkv6.launch(r, k, v, w, u, s0, chunk=1)
    want = ref.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    torch.cuda.synchronize()
    worst = max(worst, _close(torch, got[0][:, 0], want[0], "wkv6 T=1 out", WKV_TOL),
                _close(torch, got[1], want[1], "wkv6 T=1 state", WKV_TOL))
    # Padding: 100 real tokens, then 40 pad tokens (k = 0, w = 1).
    r, k, v, w, u, s0 = inputs(4, 140, 40, 64)
    k[:, 100:] = 0
    w[:, 100:] = 1
    exact = wkv6.launch(r[:, :100], k[:, :100], v[:, :100], w[:, :100], u, s0, chunk=64)
    padded = wkv6.launch(r, k, v, w, u, s0, chunk=64)
    torch.cuda.synchronize()
    if not (torch.equal(exact[0], padded[0][:, :100]) and torch.equal(exact[1], padded[1])):
        raise AssertionError("wkv6: a prompt padded by 40 tokens is not bitwise the prompt")
    log(f"wkv6: {len(cases)} shapes (full B=4 T=320 H=40 K=64 chunk 64, ragged T, K=16, "
        f"decay 1e-6, JAX test shapes) in bf16/f32, and a T=1 decode step, within "
        f"atol=rtol={WKV_TOL} (max |err| {worst:.3g}); padded by 40 tokens: bitwise")

    B, T, H, K, chunk = 4, 320, 40, 64, 64
    a = inputs(B, T, H, K)
    ms = timer(lambda: wkv6.launch(*a, chunk=chunk))
    plain_ms = timer(lambda: ref.wkv6_chunked_ref(*a, chunk))
    nbytes = 3 * B * T * H * K * 2 + B * T * H * K * 4 + H * K * 4 \
        + 2 * B * H * K * K * 4 + B * T * H * K * 4
    # The recurrence's own float32 work per (token, head), whatever form
    # computes it: o = r^T S (2KV) plus the u bonus ((r*u) . k: 3K, times
    # v: 2V), and S <- w * S + k v^T (3KV). The chunked form's extra work
    # (log decays, exps, the pairwise products) is not counted.
    V = K
    ops_ = B * T * H * (5 * K * V + 3 * K + 2 * V)
    b_ms, b_by = bound_ms(nbytes, ops_, FP32_FLOPS_PER_S)
    prefill = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by,
               "shape": f"B={B} T={T} H={H} K=V={K} chunk {chunk} bf16 r/k/v"}
    # The decode step: one token with the carried state (ops.wkv6_step).
    r, k, v, w, u, s0 = inputs(B, 1, H, K)
    ms = timer(lambda: wkv6.launch(r, k, v, w, u, s0, chunk=1))
    plain_ms = timer(lambda: ref.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0))
    nbytes = 3 * B * H * K * 2 + B * H * K * 4 + H * K * 4 + 2 * B * H * K * V * 4 \
        + B * H * V * 4
    b_ms, b_by = bound_ms(nbytes, B * H * (5 * K * V + 3 * K + 2 * V), FP32_FLOPS_PER_S)
    decode = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "bound_ms": b_ms, "bound_by": b_by,
              "shape": f"B={B} T=1 H={H} K=V={K} bf16 r/k/v, carried state"}
    return {**prefill, "max_abs_err": worst,
            "entries": {"prefill": prefill, "decode": decode}}


RWKV_KN = ((2560, 2560), (2560, 8960), (8960, 2560), (2560, 64), (64, 2560),
           (2560, 65536))


DENSE_M = (1, 4, 17, 64, 65, 128, 200, 640)   # rows bitwise those at M = 1280


def check_dense_matmul(torch, dev, timer):
    """The batch-invariant bf16 product at rwkv6-3b's weight shapes (the
    mixers' 2560 x 2560, channel-mix 2560 -> 8960 -> 2560, the decay
    LoRA's 2560 -> 64 -> 2560, the 2560 -> 65536 head): within atol = rtol
    = 2e-2 of ``x @ w`` in bf16 (another summation order, one bf16
    rounding), and each row bitwise the same at every M of DENSE_M as at
    M = 1280 (decode, solo prefills of bucketed prompts, a static batch of
    4 x 320), across every tiling (split decode blocks folded by a second
    launch; strips and wide tiles folding in the block). Times the decode
    products 2560 -> 8960 and 8960 -> 2560 (K split) at M = 4, and
    2560 -> 8960 at M = 1280."""
    from repro_torch.kernels import dense_matmul, ref

    gen = torch.Generator(device=dev).manual_seed(12)
    worst = 0.0
    for K, N in RWKV_KN:
        w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((1280, K), generator=gen, device=dev).to(torch.bfloat16)
        full = dense_matmul.launch(x, w)
        want = ref.dense_matmul_ref(x, w)
        torch.cuda.synchronize()
        worst = max(worst, _close(torch, full, want, f"dense_matmul {K}x{N} M=1280"))
        for m in DENSE_M:
            part = dense_matmul.launch(x[:m], w)
            torch.cuda.synchronize()
            if not torch.equal(part, full[:m]):
                raise AssertionError(
                    f"dense_matmul {K}x{N}: rows at M={m} (plan "
                    f"{dense_matmul.launch_plan(m, K, N)}) are not bitwise the same rows "
                    f"at M=1280 (plan {dense_matmul.launch_plan(1280, K, N)})")
    log(f"dense_matmul: {len(RWKV_KN)} rwkv6-3b shapes within atol=rtol={ATOL} of x @ w "
        f"(max |err| {worst:.3g}); rows bitwise equal at M in {DENSE_M} and 1280")

    def timed(M, K, N):
        w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        ms = timer(lambda: dense_matmul.launch(x, w))
        plain_ms = timer(lambda: ref.dense_matmul_ref(x, w))
        lib_ms = timer(lambda: torch.matmul(x, w))
        b_ms, b_by = bound_ms(2 * (M * K + K * N + M * N), 2 * M * K * N, BF16_FLOPS_PER_S)
        S, _, bm = dense_matmul.launch_plan(M, K, N)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by, "slices": S, "rows_per_block": bm,
                "shape": f"M={M} {K}->{N} bf16"}

    entries = {"decode": timed(4, 2560, 8960), "decode_split": timed(4, 8960, 2560),
               "prefill": timed(1280, 2560, 8960)}
    return {**entries["decode"], "max_abs_err": worst, "entries": entries}



# (name, K, N) of the leaves at widths no earlier gate ran: nemotron-4-15b's
# relu2 FFN (d_ff 24 576) and stablelm-12b's K projection (8 KV heads of
# 160) and FFN down projection (d_ff 13 824).
NEW_KN = (("nemotron w_up", 6144, 24576), ("nemotron w_down", 24576, 6144),
          ("stablelm wk", 5120, 1280), ("stablelm w_down", 13824, 5120))
NEW_M = (4, 32)    # a decode step of 4 slots, a 32-token prefill chunk


def check_new_widths(torch, dev, timer, kn=NEW_KN):
    """The matmul kernels at the widths of `kn` (NEW_KN; nemotron-4-340b's
    NEMOTRON_340B_KN, K up to 73 728), bitwise against their
    plain versions at M in NEW_M: ``quantize_rows`` (a6 and a8 codes of
    float32 and bfloat16 rows); the fused kernel under w4a8 on bf16 rows
    (the serving path's), in both forms ((acc, scales) and the
    dequantized bf16 product); the Table III leaf at w4a6r25 (one
    ``quantize_rows``, two ``bitplane_matmul`` dequant launches) against
    its plain version and the fused two-group route. Times the fused
    kernel's dequant form at the first leaf's decode shape (nemotron's
    w_up, M = 4, w4a8, bf16 rows -> bf16 y) beside its bound and
    ``torch.matmul`` on bf16 weights: returned as one timed entry."""
    from repro_torch.core.bitplane import pack_weights, unpack_weights
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.quantized_linear import pack_weight
    from repro_torch.kernels import fused_matmul, ops, pack_quant, ref

    gen = torch.Generator(device=dev).manual_seed(14)
    t3 = QuantConfig(w_bits=4, a_bits=6, mixed_ratio_8b=0.25)
    kw = dict(w_bits=4, a_bits=8, act_signed=True, w_plane_lo=0)
    cases = {"quantize_rows": 0, "fused": 0, "table3": 0}
    for what, K, N in kn:
        packed = pack_weights(torch.randint(-8, 8, (K, N), generator=gen, device=dev,
                                            dtype=torch.int32), 4, axis=0)
        scale = torch.rand((1, N), generator=gen, device=dev) * 0.01
        pw = pack_weight(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5, t3)
        p8, pl, s8, sl = pw.packed8, pw.packed, pw.scale[:, :pw.n8], pw.scale[:, pw.n8:]
        wl = unpack_weights(pl, 4)
        for M in NEW_M:
            x = torch.randn((M, K), generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                for bits in (6, 8):
                    got = pack_quant.launch(x.to(dtype), bits=bits, signed=True)
                    want = ref.quantize_rows_ref(x.to(dtype), bits, True)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise AssertionError(f"quantize_rows {what} M={M} K={K} {dtype} "
                                             f"a{bits}: not bitwise the plain version")
                    cases["quantize_rows"] += 1
            xb = x.to(torch.bfloat16)
            acc, s = fused_matmul.launch(xb, packed, **kw)
            acc_r, s_r = ref.fused_quantize_matmul_ref(xb.float(), packed, **kw)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            fused_matmul.launch_dequant(xb, packed, scale, out, **kw)
            want = ref.packed_matmul_ref(xb, packed, scale, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(acc, acc_r) and torch.equal(s, s_r) and torch.equal(out, want)):
                raise AssertionError(f"fused {what} M={M} {K}->{N} w4a8 plan "
                                     f"{fused_matmul.plan(M, K, N)}: not bitwise the plain "
                                     f"versions ({(acc != acc_r).sum().item()} acc mismatches)")
            cases["fused"] += 2
            got = ops.mixed_group_matmul(xb, p8, pl, s8, sl, w_bits=4, a_bits=6)
            plain = ref.mixed_group_matmul_ref(xb, p8, wl, s8, sl, 6).to(xb.dtype)
            fused = ops.packed_matmul(xb, pl, sl, w_bits=4, a_bits=6, packed8=p8, scale8=s8)
            torch.cuda.synchronize()
            if not (torch.equal(got, plain) and torch.equal(got, fused)):
                raise AssertionError(f"Table III leaf {what} M={M} {K}->{N} (n8={pw.n8}): "
                                     f"{(got != plain).sum().item()} elements differ from the "
                                     f"plain version, {(got != fused).sum().item()} from the "
                                     "fused two-group route")
            cases["table3"] += 1
        del packed, pw, p8, pl, wl
    log(f"new widths {[w for w, _, _ in kn]} at M in {NEW_M}: quantize_rows "
        f"{cases['quantize_rows']}, fused w4a8 {cases['fused']} (both forms) and Table III "
        f"leaf {cases['table3']} cases bitwise equal to their plain versions (and the leaf "
        "to the fused two-group route)")

    leaf, K, N = kn[0]
    codes = torch.randint(-8, 8, (K, N), generator=gen, device=dev, dtype=torch.int32)
    packed = pack_weights(codes, 4, axis=0)
    w_bf16 = (codes.float() * 0.01).to(torch.bfloat16)
    del codes
    scale = torch.rand((1, N), generator=gen, device=dev) * 0.01
    M = 4
    xb = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    b_ms, b_by = bound_ms(M * K * 2 + K * N // 2 + M * N * 2 + N * 4, 2 * M * K * N,
                          INT8_OPS_PER_S)
    entry = {"ms": timer(lambda: fused_matmul.launch_dequant(xb, packed, scale, out, **kw)),
             "plain_ms": timer(lambda: ref.packed_matmul_ref(xb, packed, scale, **kw)),
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "library": "torch.matmul, bf16 W", "bound_ms": b_ms, "bound_by": b_by,
             "plan": fused_matmul.plan(M, K, N)._asdict(),
             "shape": f"{leaf} M={M} {K}->{N} w4a8 bf16 rows -> bf16 y"}
    return {"cases": cases, "entry": entry}

# -- the serving path ---------------------------------------------------------

def mixed_requests(cfg, args):
    """8 requests with prompts of 64-320 tokens (greedy and temperature
    0.7 alternating), after a common --shared-prefix prompt if one is
    asked for, all queued at t=0; the same stream on every call. With
    --requests n < 8, its first n requests."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, getattr(args, "shared_prefix", 0))
    lens = (64, 320, 128, 256, 96, 192, 288, 160)
    return [Request(rid=i, prompt=np.concatenate(
                        [shared, rng.integers(0, cfg.vocab, n)]).astype(np.int64),
                    max_new_tokens=args.max_new,
                    temperature=0.0 if i % 2 == 0 else 0.7)
            for i, n in enumerate(lens)][:getattr(args, "requests", len(lens))]


SERVE_ARGS = ["--arch", "olmo-1b", "--requests", "8", "--max-new", "32",
              "--max-batch", "4", "--block-size", "16", "--prefill-budget", "32",
              "--device", "cuda"]


def serve_argv(name):
    """The serve CLI's arguments for run `name` of RUNS (a later --arch
    overrides olmo-1b), with --layers at the arch's DEPTH."""
    flags, policy, _ = RUNS[name]
    argv = SERVE_ARGS + (["--policy", policy] if policy else []) + flags
    arch = argv[max(i for i, a in enumerate(argv) if a == "--arch") + 1]
    return argv + (["--layers", str(DEPTH[arch])] if arch in DEPTH else [])


def check_outputs(name, engine, done):
    """Every request of run `name` emitted 32 tokens of the vocabulary,
    and a paged pool's allocator holds its invariants."""
    from repro_torch.serving import assert_pool_invariants

    vocab = engine.cfg.vocab
    for r in done:
        if r.error or len(r.out_tokens) != 32 or not all(0 <= t < vocab for t in r.out_tokens):
            raise AssertionError(f"{name}: request {r.rid}: bad output {r.error} "
                                 f"{r.out_tokens}")
    if engine._sched is not None:
        assert_pool_invariants(engine._sched)


def serve_run(torch, params, name):
    """Serve the stream above in run `name` of RUNS (a warmup pass,
    then the timed pass). Checks the outputs and the pool invariants, that
    the run launched every kernel of its path, and that the two passes
    emit identical greedy tokens. With the prefix cache on (every paged
    continuous run), the timed pass admits from the blocks the warmup
    pass left where the pool still holds them: warm against cold in runs
    (i) and (j), mostly cold in the runs without a shared prefix, whose
    LRU evicts before reuse. The report gains ``verify`` (the speculative
    verify calls over both passes: live rows, and the ``paged_prefill``
    launches counted inside those calls), ``requests_spec`` (the
    requests' ``spec_drafted``/``spec_accepted`` summed over both passes),
    ``requests`` (rid, tier, tokens, drafted, accepted of every request
    of both passes) and, in a run with --tiers, ``tier_steps``
    (``watch_tiers``). Returns (engine, report, launch counts, tokens by
    rid)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    flags, policy, needed = RUNS[name]
    args = serve.build_parser().parse_args(serve_argv(name))
    built = []                   # every Request of both passes

    def make_requests(cfg, args):
        reqs = mixed_requests(cfg, args)
        built.extend(reqs)
        return reqs

    verify = {"calls": 0, "rows": 0, "launches": 0}
    multi = transformer.prefill_chunk_logits_multi

    def counted_multi(params, cfg, cache, batch):
        before = ops.launch_counts()["paged_prefill"]
        out = multi(params, cfg, cache, batch)
        verify["launches"] += ops.launch_counts()["paged_prefill"] - before
        verify["rows"] += sum(int(s) >= 0 for s in batch["slots"])
        verify["calls"] += 1
        return out

    # model_zoo's entry looks the function up on the module at each call.
    transformer.prefill_chunk_logits_multi = counted_multi
    ops.reset_launch_counts()
    try:
        if args.tiers:
            with watch_tiers() as tier_steps:
                engine, done, report = serve.run(args, make_requests, params=params)
            report["tier_steps"] = tier_steps
        else:
            engine, done, report = serve.run(args, make_requests, params=params)
    finally:
        transformer.prefill_chunk_logits_multi = multi
    counts = launch_counts()
    report["verify"] = verify
    report["requests_spec"] = [sum(r.spec_drafted for r in built),
                               sum(r.spec_accepted for r in built)]
    report["requests"] = [(r.rid, r.tier, len(r.out_tokens or ()), r.spec_drafted,
                           r.spec_accepted) for r in built]
    check_outputs(name, engine, done)
    for k in needed:
        if counts[k] <= 0:
            raise AssertionError(f"{name}: {k} never launched while serving")
    tokens = {r.rid: r.out_tokens for r in done}
    warm = report["warmup_tokens"]
    for r in done:
        if r.temperature == 0 and warm[r.rid] != r.out_tokens:
            raise AssertionError(f"{name}: the repeated pass changed greedy request "
                                 f"{r.rid}: {warm[r.rid]} vs {r.out_tokens}")
    same = sum(warm[rid] == t for rid, t in tokens.items())
    st = report["stats"] or {}
    prefix = (f"; prefix cache: hit rate {st['prefix_hit_rate']:.4f} "
              f"({st['prefix_hit_blocks']} block hits, {st['cow_copies']} CoW copies, "
              f"{st['prefix_evictions']} evictions)" if st.get("prefix_cache") else "")
    # The default pool never runs short and nothing is injected: no
    # preemption, re-dispatched decode call or non-finite logits row.
    faults = {k: st[k] for k in ("preemptions", "kernel_fallbacks", "nan_logit_events")
              if k in st}
    log(f"serve {engine.cfg.name} [{name}] policy {policy}: {report['tok_per_s']:.1f} tok/s "
        f"steady state; repeated pass: greedy identical, {same}/{len(done)} "
        f"requests identical{prefix}; {faults or 'static'}; launches {counts}")
    if any(faults.values()):
        raise AssertionError(f"{name}: {faults} on a pool that never runs short")
    return engine, report, counts, tokens


@contextlib.contextmanager
def watch_tiers():
    """Within the block, every ``ContinuousScheduler.step`` that decodes in
    more than one tier group (a mixed step) is followed by a read of the
    device's pos/length rows, each live decoding row compared with the
    host's ``_pos_host``; and every speculation round's verify calls are
    counted against the tier groups the round has eligible slots in
    (greedy, decoding, 1+ draft owed, a tier above the draft's bits),
    worked out here before the round runs. Yields a dict: ``mixed_steps``,
    ``pos_mismatches`` (step, row, device pos, length, host pos), ``rounds``,
    ``multi_group_rounds`` (rounds with slots in two or more tier groups)
    and ``round_mismatches`` (round, groups, verify calls)."""
    from repro_torch.serving.scheduler import ContinuousScheduler as S

    step, spec = S.step, S._spec_phase
    out = {"mixed_steps": 0, "pos_mismatches": [], "rounds": 0, "multi_group_rounds": 0,
           "round_mismatches": []}

    def decode_calls(sched):
        return sum(tc["decode_calls"] for tc in sched.tier_counters.values())

    def watched_step(sched):
        calls = decode_calls(sched)
        finished = step(sched)
        if decode_calls(sched) - calls > 1:
            out["mixed_steps"] += 1
            pos = sched.cache.pos.cpu().tolist()
            length = sched.cache.kv.length.cpu().tolist()
            for b, r in enumerate(sched._slots):
                host = int(sched._pos_host[b])
                if (r is not None and b not in sched._chunk_plans
                        and (pos[b] != host or length[b] != host)):
                    out["pos_mismatches"].append((sched.steps_run, b, pos[b], length[b], host))
        return finished

    def watched_spec(sched):
        groups = set()
        for b, r in enumerate(sched._slots):
            if r is None or b in sched._chunk_plans or r.temperature > 0:
                continue
            tier = sched._slot_tier[b]
            if tier is not None and sched._tier_cfgs[tier].w_bits <= sched._draft_bits:
                continue
            if r.max_new_tokens - len(r.out_tokens) - 1 >= 1:
                groups.add(tier)
        calls = sched.spec_verify_calls
        finished = spec(sched)
        if groups:
            out["rounds"] += 1
            out["multi_group_rounds"] += len(groups) > 1
            made = sched.spec_verify_calls - calls
            if made != len(groups):
                out["round_mismatches"].append((out["rounds"], sorted(groups), made))
        return finished

    S.step, S._spec_phase = watched_step, watched_spec
    try:
        yield out
    finally:
        S.step, S._spec_phase = step, spec


TIER_RUNS = ("m-tiers-prefix", "n-tiers-spec-table3-int8")


def compare_tiers(torch, runs):
    """The tier gates on runs (m) and (n).

    (a) For each tier, the stream's requests of that tier served by an
    engine configured with that tier alone, on the run's weights, pool,
    flags and max_batch: every request's tokens (greedy and sampled) in
    the mixed run's warmup and timed pass identical to its solo-at-tier
    tokens, 8/8. (b) After every mixed step (more than one decode call),
    the device pos/length of each live decoding row equal ``_pos_host``,
    and mixed steps happened. (c) Run (m) hit prefix blocks. (d) Run (n):
    w2a8 requests drafted nothing, w8a8 and w4a8 requests drafted, every
    round made one verify call per tier group with eligible slots, and
    the ``paged_prefill`` launches inside the verify calls are one a layer
    a verified row; the stream's greedy requests at w8a8 and w4a8 (rids 0
    and 4) never share a round there, so its three greedy requests (rids
    0, 2, 4) are served once more together by a scheduler on (n)'s
    weights and flags: rounds with two speculating groups must occur,
    each with one verify call per group, and each request's tokens equal
    its solo-at-tier tokens. (e) ``tier_counters`` agree with the requests of both
    passes: requests, tokens, drafted and accepted per tier, decode calls
    > 0, no request at the storage tier. Everything prints before a gate
    raises."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    out, bad = {}, []
    for name in TIER_RUNS:
        engine, report, _, tokens = runs[name]
        args = serve.build_parser().parse_args(serve_argv(name))
        stream = serve.assign_lifecycle(mixed_requests(engine.cfg, args), args)
        solo, solo_s = {}, {}
        for tier in TIERS.split(","):
            eng = ServingEngine(
                engine.cfg, engine.params, max_batch=engine.max_batch,
                bucket=engine.bucket, block_size=engine.block_size,
                pool_blocks=engine.pool_blocks, prefix_cache=engine.prefix_cache,
                chunked_prefill=engine.chunked_prefill,
                prefill_budget=engine.prefill_budget, speculate=engine.speculate,
                draft_policy=engine.draft_policy, tiers=tier, device=engine.device)
            t0 = time.perf_counter()
            done = eng.generate([r for r in stream if r.tier == tier])
            torch.cuda.synchronize()
            solo_s[tier] = time.perf_counter() - t0
            check_outputs(f"{name} at {tier} alone", eng, done)
            solo.update({r.rid: r.out_tokens for r in done})
        rids = sorted(solo)
        shares = {"warmup": _greedy_share(report["warmup_tokens"], solo, rids),
                  "timed": _greedy_share(tokens, solo, rids)}
        st = report["stats"]
        watch = report["tier_steps"]
        reqs = report["requests"]
        per_tier = {}
        for tier in TIERS.split(","):
            mine = [q for q in reqs if q[1] == tier]
            per_tier[tier] = {"requests": len(mine), "tokens": sum(q[2] for q in mine),
                              "spec_draft_tokens": sum(q[3] for q in mine),
                              "spec_accepted_tokens": sum(q[4] for q in mine)}
        verify = report["verify"]
        out[name] = {"solo_at_tier": shares, "mixed_steps": watch["mixed_steps"],
                     "pos_mismatches": watch["pos_mismatches"][:8],
                     "spec_rounds_watched": watch["rounds"],
                     "round_mismatches": watch["round_mismatches"][:8],
                     "tiers": st["tiers"], "tok_per_s": report["tok_per_s"],
                     "solo_at_tier_s": solo_s, "verify_launches": verify,
                     **{k: st[k] for k in ("prefix_hit_rate", "prefix_hit_tokens",
                                           "spec_draft_tokens", "spec_accepted_tokens",
                                           "spec_verify_calls", "spec_verify_rows")}}
        log(f"tiers [{name}]: tokens identical to the solo-at-tier engines: warmup pass "
            f"{shares['warmup']}, timed pass {shares['timed']} (gated at all); "
            f"{watch['mixed_steps']} mixed steps, device pos/length != host in "
            f"{len(watch['pos_mismatches'])} rows; {watch['rounds']} speculation rounds, "
            f"{len(watch['round_mismatches'])} with verify calls != tier groups; prefix "
            f"hit tokens {st['prefix_hit_tokens']}; per tier "
            + "; ".join(f"{t}: {tc['requests']} req, {tc['tokens']} tok, "
                        f"{tc['decode_calls']} decode calls, {tc['spec_accepted_tokens']}/"
                        f"{tc['spec_draft_tokens']} drafts accepted"
                        for t, tc in st["tiers"].items() if tc["requests"])
            + f"; {report['tok_per_s']:.1f} tok/s")
        full = f"{len(rids)}/{len(rids)}"
        bad += [f"{name} solo-at-tier {p} {v}" for p, v in shares.items() if v != full]
        if len(rids) != 8:
            bad.append(f"{name}: {len(rids)} requests served at their tiers")
        if not watch["mixed_steps"] or watch["pos_mismatches"]:
            bad.append(f"{name}: {watch['mixed_steps']} mixed steps, pos mismatches "
                       f"{watch['pos_mismatches'][:4]}")
        if st["tiers"]["base"]["requests"]:
            bad.append(f"{name}: {st['tiers']['base']['requests']} requests at the storage tier")
        for tier, want in per_tier.items():
            got = {k: st["tiers"][tier][k] for k in want}
            if got != want or not st["tiers"][tier]["decode_calls"] > 0:
                bad.append(f"{name}: tier_counters[{tier}] {st['tiers'][tier]} vs the "
                           f"requests' {want}")
        if name == "m-tiers-prefix" and not st["prefix_hit_tokens"] > 0:
            bad.append(f"{name}: no prefix hit")
        if name == "n-tiers-spec-table3-int8":
            two = two_group_rounds(engine, args, solo)
            out[name]["two_group_check"] = two
            log(f"tiers [{name}]: greedy rids 0, 2, 4 together: {two['rounds']} rounds, "
                f"{two['multi_group_rounds']} with two speculating groups, "
                f"{len(two['round_mismatches'])} with verify calls != groups; tokens "
                f"identical to solo-at-tier {two['solo_at_tier']}")
            if not (two["multi_group_rounds"] > 0 and not two["round_mismatches"]
                    and two["solo_at_tier"] == "3/3" and not two["pos_mismatches"]):
                bad.append(f"{name}: two-group check {two}")
            if per_tier["w2a8"]["spec_draft_tokens"] or not (
                    per_tier["w8a8"]["spec_draft_tokens"]
                    and per_tier["w4a8"]["spec_draft_tokens"]):
                bad.append(f"{name}: drafted per tier {per_tier}")
            if not watch["rounds"] or watch["round_mismatches"]:
                bad.append(f"{name}: {watch['rounds']} rounds, verify calls != groups in "
                           f"{watch['round_mismatches'][:4]}")
            if not (verify["rows"] == st["spec_verify_rows"] and verify["calls"] ==
                    st["spec_verify_calls"] and verify["launches"] ==
                    verify["rows"] * engine.cfg.num_layers > 0):
                bad.append(f"{name}: verify launches {verify} against "
                           f"{st['spec_verify_rows']} rows in {st['spec_verify_calls']} calls")
    if bad:
        raise AssertionError(f"tiers: {bad}")
    return out


def two_group_rounds(engine, args, solo):
    """The stream's greedy requests (rids 0, 2, 4: w8a8, w2a8, w4a8)
    submitted together to a scheduler on `engine`'s weights and flags,
    under ``watch_tiers``: its counts, and how many requests emitted
    their `solo` (solo-at-tier) tokens."""
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler, assert_pool_invariants

    sched = ContinuousScheduler(
        engine.cfg, engine.params, max_batch=engine.max_batch, max_ctx=engine._sched.max_ctx,
        bucket=engine.bucket, block_size=engine.block_size, pool_blocks=engine.pool_blocks,
        prefix_cache=engine.prefix_cache, chunked_prefill=engine.chunked_prefill,
        prefill_budget=engine.prefill_budget, speculate=engine.speculate,
        draft_policy=engine.draft_policy, tiers=engine.tiers, device=engine.device)
    reqs = [r for r in serve.assign_lifecycle(mixed_requests(engine.cfg, args), args)
            if r.rid in (0, 2, 4)]
    with watch_tiers() as watch:
        done = sched.run(reqs)
    assert_pool_invariants(sched)
    same = sum(r.out_tokens == solo[r.rid] for r in done)
    return {**watch, "solo_at_tier": f"{same}/{len(reqs)}"}


def check_lifecycle(torch, engine, raw_params):
    """The request lifecycle on full-width olmo-1b (DEPTH's 4 layers) on
    the int8 pool (`engine`: run chunked-int8's, its packed weights and
    config; its `raw_params` unpacked), on the chip_smoke stream in one 4-slot scheduler,
    against the same stream unperturbed in another: rid 0 cancels itself
    from its ``on_token`` after 5 tokens, rid 7 is cancelled while queued,
    rid 2 has a ``deadline_steps`` 10 steps past the step of its first
    token in the unperturbed run (so it expires mid-decode), rid 4's
    ``on_token`` raises at its third token. Gated: each of the four comes
    back with its error and a prefix of its unperturbed tokens (rid 0
    exactly 5, rid 2 between 1 and 31, rid 4 exactly 3, rid 7 none);
    every other request's tokens (greedy and sampled) equal to the
    unperturbed run's; cancellations 2, deadline misses 1, callback
    errors 1; the pool invariants after every step, and after the drain
    every block free or retained and the whole pool available. Then the
    serve CLI with --tiers and --deadline-ms 1 (every request misses):
    its per-tier and lifecycle lines print, every request comes back
    with error "deadline", and the pool invariants hold."""
    import io

    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler, assert_pool_invariants

    args = serve.build_parser().parse_args(serve_argv("chunked-int8"))
    cfg, params = engine.cfg, engine.params

    def sched():
        return ContinuousScheduler(cfg, params, max_batch=4, max_ctx=352, bucket=32,
                                   block_size=16, prefill_budget=32, device=engine.device)

    ref = sched()
    first_step = {}
    reqs = mixed_requests(cfg, args)
    reqs[2].on_token = lambda req, tok: first_step.setdefault(req.rid, ref._step_calls)
    ref_toks = {r.rid: r.out_tokens for r in ref.run(reqs)}

    s = sched()

    def cancel_at_5(req, tok):
        if len(req.out_tokens) >= 5:
            s.cancel(req.rid)

    def boom(req, tok):
        if len(req.out_tokens) >= 3:
            raise RuntimeError("sink closed")

    reqs = mixed_requests(cfg, args)
    reqs[0].on_token = cancel_at_5
    reqs[2].deadline_steps = first_step[2] + 10
    reqs[4].on_token = boom
    for r in reqs:
        s.submit(r)
    queued = s.cancel(7)
    done = []
    while s.num_active or s.num_waiting:
        done.extend(s.step())
        assert_pool_invariants(s)
    got = {r.rid: r for r in done}
    st = s.pool_stats()
    drained = (s._live_blocks == 0 and s._avail == s.pool_blocks
               and (s._block_tab == -1).all())
    errors = {rid: got[rid].error for rid in (0, 2, 4, 7)}
    lens = {rid: len(got[rid].out_tokens) for rid in (0, 2, 4, 7)}
    prefix = all(got[rid].out_tokens == ref_toks[rid][:lens[rid]] for rid in lens)
    others = sum(got[rid].out_tokens == ref_toks[rid] and got[rid].error is None
                 for rid in (1, 3, 5, 6))
    counts = (st["cancellations"], st["deadline_misses"], st["callback_errors"])
    log(f"lifecycle: errors {errors}, tokens {lens} (prefixes of the unperturbed "
        f"stream: {prefix}); other requests identical {others}/4; cancellations / "
        f"deadline misses / callback errors {counts}; queue wait steps "
        f"{st['queue_wait_steps']}; drained clean {drained}")
    bad = []
    if not (queued and errors == {0: "cancelled", 2: "deadline",
                                  4: "on_token callback raised: RuntimeError('sink closed')",
                                  7: "cancelled"}):
        bad.append(f"errors {errors} (rid 7 queued at cancel: {queued})")
    if not (prefix and lens[0] == 5 and 0 < lens[2] < 32 and lens[4] == 3 and lens[7] == 0):
        bad.append(f"tokens {lens}, prefixes {prefix}")
    if others != 4 or counts != (2, 1, 1) or not drained:
        bad.append(f"others {others}/4, counters {counts}, drained {drained}")

    cli = serve.build_parser().parse_args(serve_argv("m-tiers-prefix")
                                          + ["--deadline-ms", "1"])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli_engine, cli_done, report = serve.run(cli, mixed_requests, params=raw_params)
    printed = text.getvalue()
    log(printed.rstrip())
    assert_pool_invariants(cli_engine._sched)
    misses = report["stats"]["deadline_misses"]
    if not ("precision tiers:" in printed and "  lifecycle: " in printed
            and all(r.error == "deadline" for r in cli_done) and misses == 16):
        bad.append(f"serve --deadline-ms 1: {misses} misses, errors "
                   f"{[r.error for r in cli_done]}")
    if bad:
        raise AssertionError(f"lifecycle: {bad}")
    return {"errors": errors, "tokens": lens, "others_identical": others,
            "counters": counts, "queue_wait_steps": st["queue_wait_steps"],
            "cli_deadline_misses": misses}


# Preemption under pool pressure: name -> (the matching existing run, whose
# tokens are the reference and whose weights, pool and admission mode it
# shares; victim policy; pool of the stream phase; pool of the warm pair).
# The stream's rows need 6, 22, 10, 18, 8, 14, 20 and 12 blocks of 16
# (plus 13 shared ones under the 200-token prefix). Under a pool of 44 the
# stream preempts 3-4 times, but every victim requeues behind the rest of
# the queue, and the admissions before its turn evict the blocks it
# registered (the LRU evicts a chain's first block first), so its resume
# is cold. The pair (rid 1 decoding alone, then rid 0) is sized so that
# rid 0's admission preempts rid 1 and rid 1 resumes from its registered
# blocks: 27 blocks leave rid 0 its prompt and decode blocks in the free
# list (one fewer and rid 0's last decode block evicts rid 1's first).
PREEMPT_CONFIGS = {
    "P1": ("chunked-int8", "most-blocks", 44, 27),
    "P2": ("c-solo-paged", "most-blocks", 44, 27),
    "P3": ("j-prefix-solo-int8", "latest-deadline", 44, 40),
}
# The runs check_preemption and check_chaos compare with.
PREEMPT_RUNS = ("chunked-int8", "c-solo-paged", "j-prefix-solo-int8", "k-spec-int8")
# The chaos run: run (k)'s flags, P1's pool, and a seed whose streams fire
# every seam early, and the two seams that fail a request only once in
# the run's visits: the alloc seam fires at its visits 0, 3 and 8
# (0-based), the kernel seam at 10, 27 and 54, the nan seam at 15 (next
# at 329) and the callback seam at 21 (none other in its first 400).
CHAOS_SEED = 1848
CHAOS_RATES = dict(p_alloc=0.25, p_kernel=0.02, p_nan=0.01, p_callback=0.005)
CHAOS_MAX_FAULTS = 16
CHAOS_POOL = 44


def _sched_like(engine, args, **kw):
    """A scheduler with run `args`'s engine's weights, pool dtype, slots,
    block size, admission mode, speculation and context bound."""
    from repro_torch.serving import ContinuousScheduler

    return ContinuousScheduler(
        engine.cfg, engine.params, max_batch=engine.max_batch,
        max_ctx=engine._ctx_needed(mixed_requests(engine.cfg, args)),
        bucket=engine.bucket, block_size=engine.block_size,
        prefill_budget=engine.prefill_budget, chunked_prefill=engine.chunked_prefill,
        speculate=engine.speculate, draft_policy=engine.draft_policy,
        device=engine.device, **kw)


def watch_resumes(sched):
    """Record, on `sched`, each resumed admission's (rid, resident prefix
    tokens) and the first resume's first-token logits with its step."""
    resumes = {"claims": [], "first": None}
    claim, first = sched._claim_row, sched._first_token

    def claim_row(req, slot, match):
        if req.out_tokens:
            resumes["claims"].append((req.rid, int(match[1])))
        return claim(req, slot, match)

    def first_token(req, slot, logits):
        if req.out_tokens and resumes["first"] is None:
            resumes["first"] = {"rid": req.rid, "step": len(req.out_tokens),
                                "logits": logits[0, -1].float().clone()}
        return first(req, slot, logits)

    sched._claim_row, sched._first_token = claim_row, first_token
    return resumes


def resume_gap(torch, engine, args, first):
    """Largest |gap| between a resume's first-token logits and the decode
    logits an uninterrupted scheduler (the default pool, the request
    alone) samples the same position from, and whether they are bitwise
    equal."""
    from repro_torch.serving import sampling

    solo = _sched_like(engine, args)
    req = mixed_requests(engine.cfg, args)[first["rid"]]
    rows, inner = {}, sampling.sample_tokens

    def sample(logits, temps, top_ks, keys, steps):
        for b, r in enumerate(solo._slots):
            if (logits.shape[0] == solo.max_batch and r is not None
                    and r.rid == req.rid and b not in solo._chunk_plans):
                rows[int(steps[b])] = logits[b].float().clone()
        return inner(logits, temps, top_ks, keys, steps)

    sampling.sample_tokens = sample
    try:
        solo.run([req])
    finally:
        sampling.sample_tokens = inner
    want = rows[first["step"]]
    gap = float((first["logits"] - want).abs().max())
    return gap, bool(torch.equal(first["logits"], want))


def _drain_checked(sched, done=None):
    """Step `sched` to empty, the pool invariants held after every step."""
    from repro_torch.serving import assert_pool_invariants

    done = [] if done is None else done
    while sched.num_active or sched.num_waiting:
        done.extend(sched.step())
        assert_pool_invariants(sched)
    return done


def check_preemption(torch, runs):
    """Preemption with warm resume on full-width olmo-1b (DEPTH's 4
    layers), one configuration per row of PREEMPT_CONFIGS: P1 chunked
    prefill on the int8 pool, P2 whole-prompt admission on the bf16 pool
    with the Table III policy, P3 whole-prompt admission on the int8 pool behind the 200-token shared
    prefix (latest-deadline victims). Each serves the chip_smoke stream in
    a fresh scheduler on a pool small enough that it preempts, then the
    warm pair. Gated in each: every request's tokens (greedy and sampled)
    equal to the matching run's, which had no pressure; the stream
    preempts at least twice and the pair once; the pair's victim resumes
    from its registered blocks (prefix hits > 0); the pool invariants
    after every step and the pool drained clean. Printed: for the first
    resume of the stream and of the pair, the largest gap between its
    first-token logits and the uninterrupted decode logits at the same
    position. Everything prints before a gate raises."""
    from repro_torch.launch import serve

    out, bad = {}, []
    for cname, (ref_name, policy, pool, pair_pool) in PREEMPT_CONFIGS.items():
        engine, _, _, ref = runs[ref_name]
        args = serve.build_parser().parse_args(serve_argv(ref_name))
        res = {"run": ref_name, "victim_policy": policy, "pool_blocks": pool,
               "pair_pool_blocks": pair_pool}
        for phase in ("stream", "pair"):
            t0 = time.perf_counter()
            s = _sched_like(engine, args, pool_blocks=pool if phase == "stream" else pair_pool,
                            victim_policy=policy)
            resumes = watch_resumes(s)
            reqs = mixed_requests(engine.cfg, args)
            done = []
            if phase == "pair":
                reqs = [reqs[1], reqs[0]]
                s.submit(reqs[0])
                while len(reqs[0].out_tokens or ()) < 4:
                    done.extend(s.step())
                s.submit(reqs[1])
            else:
                for r in reqs:
                    s.submit(r)
            _drain_checked(s, done)
            torch.cuda.synchronize()
            st = s.pool_stats()
            same = sum(r.error is None and r.out_tokens == ref[r.rid] for r in reqs)
            drained = (s._live_blocks == 0 and s._avail == s.pool_blocks
                       and (s._block_tab == -1).all())
            gap = (resume_gap(torch, engine, args, resumes["first"])
                   if resumes["first"] else None)
            res[phase] = {
                "seconds": time.perf_counter() - t0,
                "identical": f"{same}/{len(reqs)}",
                "preemptions": st["preemptions"],
                "per_request": {r.rid: r.preemptions for r in reqs},
                "resumes": resumes["claims"], "prefix_hit_tokens": st["prefix_hit_tokens"],
                "pool_pressure_events": st["pool_pressure_events"],
                "head_bypasses": st["head_bypasses"], "drained": bool(drained),
                "first_resume": None if gap is None else {
                    "rid": resumes["first"]["rid"], "step": resumes["first"]["step"],
                    "max_abs_gap": gap[0], "bitwise": gap[1]}}
            log(f"preemption [{cname} {ref_name}, {policy}, {phase}, pool {s.pool_blocks}]: "
                f"tokens identical to the unpressured run {same}/{len(reqs)}, "
                f"{st['preemptions']} preemptions {res[phase]['per_request']}, resumes "
                f"(rid, resident tokens) {resumes['claims']}, prefix hit tokens "
                f"{st['prefix_hit_tokens']}, {st['pool_pressure_events']} pressure events, "
                f"{st['head_bypasses']} bypasses, drained clean {bool(drained)}; first "
                f"resume's first-token logits vs uninterrupted decode: "
                f"{res[phase]['first_resume']}")
            if same != len(reqs) or not drained:
                bad.append(f"{cname} {phase}: identical {same}/{len(reqs)}, drained {drained}")
        if res["stream"]["preemptions"] < 2 or not any(res["stream"]["per_request"].values()):
            bad.append(f"{cname}: the stream preempted {res['stream']['preemptions']} times")
        pair = res["pair"]
        if pair["preemptions"] != 1 or not any(n > 0 for _, n in pair["resumes"]):
            bad.append(f"{cname}: the pair preempted {pair['preemptions']} times, resumes "
                       f"{pair['resumes']} (a warm resume has resident tokens > 0)")
        out[cname] = res
    if bad:
        raise AssertionError(f"preemption: {bad}")
    return out


def check_chaos(torch, runs, raw_params):
    """Seeded faults at all four seams on full-width olmo-1b (DEPTH's 4
    layers) with run (k)'s flags (int8 pool, chunked prefill, --speculate
    4, w4a8 draft) on P1's pool, every request with an ``on_token`` so the callback seam
    draws. Printed: the seed, the rates and every fault fired (seam,
    visit, step). Gated: each seam fired at least once; every request no
    fault failed emits run (k)'s tokens, and each failed one has error
    "nan-logits" or a callback error and emits a prefix of them;
    nan_logit_events, kernel_fallbacks and callback_errors equal the
    faults fired at their seams, kernel_fallbacks >= 1, and the pressure
    events at least the alloc faults; the pool invariants after every
    step and the pool drained clean. Then the serve CLI with
    --pool-blocks, --chaos-seed and --chaos-rate on the same stream:
    its lifecycle and chaos lines print and it ends normally."""
    import io

    from repro_torch.launch import serve
    from repro_torch.serving import FaultInjector, assert_pool_invariants

    name = "k-spec-int8"
    engine, _, _, ref = runs[name]
    args = serve.build_parser().parse_args(serve_argv(name))
    chaos = FaultInjector(CHAOS_SEED, max_faults=CHAOS_MAX_FAULTS, **CHAOS_RATES)
    schedule, fire = [], chaos.fire
    s = _sched_like(engine, args, pool_blocks=CHAOS_POOL, chaos=chaos)

    def logged_fire(kind):
        hit = fire(kind)
        if hit:
            schedule.append((kind, chaos.draws[kind] - 1, s._step_calls))
        return hit

    chaos.fire = logged_fire
    reqs = mixed_requests(engine.cfg, args)
    for r in reqs:
        r.on_token = lambda req, tok: None
        s.submit(r)
    t0 = time.perf_counter()
    _drain_checked(s)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = s.pool_stats()
    fired = st["chaos"]["fired"]
    failed = {r.rid: r.error for r in reqs if r.error}
    survivors = sum(r.out_tokens == ref[r.rid] for r in reqs if not r.error)
    prefixes = all(r.out_tokens == ref[r.rid][:len(r.out_tokens)] for r in reqs)
    drained = (s._live_blocks == 0 and s._avail == s.pool_blocks
               and (s._block_tab == -1).all())
    counters = {k: st[k] for k in ("kernel_fallbacks", "nan_logit_events", "callback_errors",
                                   "pool_pressure_events", "preemptions", "head_bypasses")}
    log(f"chaos [{name}, pool {CHAOS_POOL}]: seed {CHAOS_SEED}, rates {CHAOS_RATES}, "
        f"max_faults {CHAOS_MAX_FAULTS}; fired {fired} of draws {st['chaos']['draws']}; "
        f"schedule (seam, visit, step) {schedule}; failed {failed}; survivors identical "
        f"to run (k) {survivors}/{len(reqs) - len(failed)}; failed requests emit a prefix "
        f"{prefixes}; counters {counters}; drained clean {bool(drained)}; {seconds:.1f}s")
    bad = []
    if not all(fired[k] >= 1 for k in fired):
        bad.append(f"a seam never fired: {fired}")
    if survivors != len(reqs) - len(failed) or not prefixes or not drained:
        bad.append(f"survivors {survivors}, prefixes {prefixes}, drained {drained}")
    if not all(e == "nan-logits" or e.startswith("on_token callback raised")
               for e in failed.values()):
        bad.append(f"errors {failed}")
    if not (counters["nan_logit_events"] == fired["nan"]
            and counters["kernel_fallbacks"] == fired["kernel"] >= 1
            and counters["callback_errors"] == fired["callback"]
            and counters["pool_pressure_events"] >= fired["alloc"]):
        bad.append(f"counters {counters} vs fired {fired}")

    rate = CHAOS_RATES["p_kernel"]
    cli = serve.build_parser().parse_args(serve_argv(name) + [
        "--pool-blocks", str(CHAOS_POOL), "--chaos-seed", str(CHAOS_SEED),
        "--chaos-rate", str(rate), "--chaos-max-faults", str(CHAOS_MAX_FAULTS)])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli_engine, cli_done, report = serve.run(cli, mixed_requests, params=raw_params)
    printed = text.getvalue()
    log(printed.rstrip())
    assert_pool_invariants(cli_engine._sched)
    if not ("  lifecycle: " in printed and "  chaos: seed=" in printed
            and len(cli_done) == len(reqs)):
        bad.append("serve --chaos-seed: no lifecycle or chaos line")
    if bad:
        raise AssertionError(f"chaos: {bad}")
    return {"seed": CHAOS_SEED, "rates": CHAOS_RATES, "max_faults": CHAOS_MAX_FAULTS,
            "pool_blocks": CHAOS_POOL, "fired": fired, "draws": st["chaos"]["draws"],
            "schedule": schedule, "failed": failed, "counters": counters,
            "survivors_identical": survivors, "seconds": seconds,
            "cli_chaos": report["stats"]["chaos"],
            "cli_lifecycle": {k: report["stats"][k] for k in (
                "preemptions", "pool_pressure_events", "kernel_fallbacks",
                "nan_logit_events", "callback_errors")}}


# The host-RAM tier's phases: 512 MiB of host memory (256 bf16 or 496
# int8 olmo-1b blocks: 2 097 152 and 1 081 344 bytes); H1 and H2 serve the
# stream twice through one scheduler on a 44-block pool with run (i)'s and
# run (j)'s flags; H3 re-serves P1-P3 under block-to-host, and P1 once
# more with a budget of 8 blocks' bytes; H4 and the CLI persist run (j)'s
# int8 index (about 1.08 MB a block, 1.44 MB as base64 JSON).
HOST_BYTES = 512 << 20
HOST_POOL = 44
HOST_RUNS = {"H1": "i-prefix-chunked", "H2": "j-prefix-solo-int8"}
HOST_BUDGET_BLOCKS = 8
# The runs check_host_tier compares with.
HOST_REF_RUNS = ("i-prefix-chunked", "j-prefix-solo-int8", "chunked-int8", "c-solo-paged")
HOST_DELTAS = ("swap_ins", "swap_outs", "host_hit_blocks", "host_hit_tokens",
               "host_evictions", "preemptions", "prefix_hit_tokens",
               "prefill_tokens_computed", "pool_pressure_events")


def watch_host(sched):
    """Count, on `sched`, the spills and swap-ins and the host seconds they
    take (the copies are queued without a wait, so this is what a step
    pays for them on the host; a swap-in's time includes any spill its
    allocation causes), and the largest ``host_bytes`` seen."""
    w = {"spills": 0, "spill_s": 0.0, "swap_in_blocks": 0, "swap_in_s": 0.0,
         "peak_host_bytes": 0}
    spill, swap = sched._spill_block, sched._swap_in_hits

    def timed_spill(blk):
        t0 = time.perf_counter()
        spill(blk)
        w["spill_s"] += time.perf_counter() - t0
        w["spills"] += 1
        w["peak_host_bytes"] = max(w["peak_host_bytes"], sched.host_bytes)

    def timed_swap(slot, host_hits, n_full):
        t0 = time.perf_counter()
        swap(slot, host_hits, n_full)
        w["swap_in_s"] += time.perf_counter() - t0
        w["swap_in_blocks"] += len(host_hits)

    sched._spill_block, sched._swap_in_hits = timed_spill, timed_swap
    return w


def host_rounds(torch, engine, args, ref, rounds, **kw):
    """Serve the stream `rounds` times through one scheduler like run
    `args`'s engine (with `kw`), the pool invariants after every step.
    Returns (scheduler, per-round records, resumes, host watch); each
    record has the round's tokens identical to `ref`, its seconds, the
    HOST_DELTAS counters it added and the host store after it."""
    s = _sched_like(engine, args, **kw)
    resumes, watch = watch_resumes(s), watch_host(s)
    prev, out = {k: 0 for k in HOST_DELTAS}, []
    for _ in range(rounds):
        t0 = time.perf_counter()
        reqs = mixed_requests(engine.cfg, args)
        for r in reqs:
            s.submit(r)
        _drain_checked(s)
        torch.cuda.synchronize()
        st = s.pool_stats()
        same = sum(r.error is None and r.out_tokens == ref[r.rid] for r in reqs)
        out.append({"seconds": time.perf_counter() - t0, "identical": same,
                    "of": len(reqs), **{k: st[k] - prev[k] for k in HOST_DELTAS},
                    "host_blocks": st["host_blocks"], "host_bytes": st["host_bytes"]})
        prev = st
    out[-1]["drained"] = _drained(s)
    return s, out, resumes, watch


@contextlib.contextmanager
def invariants_every_step():
    """Within the block, every ``ContinuousScheduler.step`` (an engine's
    or the CLI's included) is followed by ``assert_pool_invariants``."""
    from repro_torch.serving import ContinuousScheduler, assert_pool_invariants

    step = ContinuousScheduler.step

    def checked(self):
        out = step(self)
        assert_pool_invariants(self)
        return out

    ContinuousScheduler.step = checked
    try:
        yield
    finally:
        ContinuousScheduler.step = step


def _drained(s) -> bool:
    return bool(s._live_blocks == 0 and s._avail == s.pool_blocks
                and (s._block_tab == -1).all())


def check_host_tier(torch, runs, raw_params):
    """The host-RAM block tier on full-width olmo-1b (DEPTH's 4 layers);
    every phase serves the chip_smoke stream with the pool invariants
    (host half included: digests on one side only, host bytes conserved and within the budget)
    after every step and a clean drain.

    H1/H2: run (i)'s and run (j)'s flags on a 44-block pool with 512 MiB of
    host, the stream served twice through one scheduler: both rounds'
    tokens (greedy and sampled) equal the run's, 8/8, and round 2 swaps
    blocks in from host (swap_ins > 0, host_hit_tokens > 0).
    H3: P1-P3 (PREEMPT_CONFIGS) with victim_policy="block-to-host" and
    512 MiB: tokens equal the unpressured run's, at least two preemptions
    each, every resume warm (resident tokens > 0) and swap_outs > 0; then
    P1 with a budget of 8 blocks' bytes: tokens equal, host_evictions > 0
    and host_bytes within the budget at every step.
    H4: engine A serves run (j)'s stream with the tier on and saves its
    index; a fresh engine B loads it before its first generate and
    serves the stream: B's tokens and A's equal run (j)'s, B hits host
    blocks and computes fewer prefill tokens than A. The int8 index then
    loads 0 digests, with a warning, into a bf16-pool scheduler.
    The CLI: serve with run (j)'s flags, --host-pool-bytes and --index
    twice: the first saves N > 0 digests, the second loads them, prints
    its host-tier line with block hits > 0, and both emit run (j)'s
    tokens. Everything prints before a gate raises."""
    import io
    import tempfile
    import warnings

    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    out, bad = {}, []
    for phase, name in HOST_RUNS.items():
        engine, _, _, ref = runs[name]
        args = serve.build_parser().parse_args(serve_argv(name))
        s, rounds, resumes, watch = host_rounds(
            torch, engine, args, ref, 2, pool_blocks=HOST_POOL, host_pool_bytes=HOST_BYTES)
        out[phase] = {"run": name, "pool_blocks": HOST_POOL, "host_pool_bytes": HOST_BYTES,
                      "block_bytes": s._host_block_nbytes(), "rounds": rounds,
                      "resumes": resumes["claims"], "host": watch}
        log(f"host tier [{phase} {name}, pool {HOST_POOL}, host {HOST_BYTES} B, block "
            f"{s._host_block_nbytes()} B]: rounds {rounds}; resumes (rid, resident) "
            f"{resumes['claims']}; host-side {watch}")
        if any(r["identical"] != r["of"] for r in rounds) or not rounds[-1]["drained"]:
            bad.append(f"{phase}: identical {[r['identical'] for r in rounds]}, drained "
                       f"{rounds[-1]['drained']}")
        if not (rounds[1]["swap_ins"] > 0 and rounds[1]["host_hit_tokens"] > 0):
            bad.append(f"{phase}: round 2 swapped in {rounds[1]['swap_ins']} blocks, "
                       f"{rounds[1]['host_hit_tokens']} host hit tokens")

    h3 = {}
    cases = [(c, ref, pool, HOST_BYTES) for c, (ref, _, pool, _) in PREEMPT_CONFIGS.items()]
    cases.append(("P1-budget", PREEMPT_CONFIGS["P1"][0], PREEMPT_CONFIGS["P1"][2], None))
    for cname, ref_name, pool, host in cases:
        engine, _, _, ref = runs[ref_name]
        args = serve.build_parser().parse_args(serve_argv(ref_name))
        if host is None:            # the budget case: 8 of P1's blocks
            host = HOST_BUDGET_BLOCKS * h3["P1"]["block_bytes"]
        s, (rec,), resumes, watch = host_rounds(
            torch, engine, args, ref, 1, pool_blocks=pool, host_pool_bytes=host,
            victim_policy="block-to-host")
        h3[cname] = {"run": ref_name, "pool_blocks": pool, "host_pool_bytes": host,
                     "block_bytes": s._host_block_nbytes(), **rec, "resumes": resumes["claims"], "host": watch}
        log(f"host tier [H3 {cname} {ref_name}, block-to-host, pool {pool}, host {host} B]: "
            f"{rec}; resumes (rid, resident) {resumes['claims']}; host-side {watch}")
        if rec["identical"] != rec["of"] or not rec["drained"]:
            bad.append(f"H3 {cname}: identical {rec['identical']}/{rec['of']}, drained "
                       f"{rec['drained']}")
        if cname == "P1-budget":
            if not (rec["host_evictions"] > 0 and watch["peak_host_bytes"] <= host):
                bad.append(f"H3 {cname}: {rec['host_evictions']} host evictions, peak "
                           f"host bytes {watch['peak_host_bytes']} of {host}")
        elif (rec["preemptions"] < 2 or rec["swap_outs"] <= 0 or not resumes["claims"]
              or not all(n > 0 for _, n in resumes["claims"])):
            bad.append(f"H3 {cname}: {rec['preemptions']} preemptions, {rec['swap_outs']} "
                       f"swap-outs, resumes {resumes['claims']} (each must be warm)")
    out["H3"] = h3

    name = "j-prefix-solo-int8"
    eng_j, _, _, ref = runs[name]
    args = serve.build_parser().parse_args(serve_argv(name))

    def fresh():
        return ServingEngine(eng_j.cfg, eng_j.params, max_batch=eng_j.max_batch,
                             bucket=eng_j.bucket, block_size=eng_j.block_size,
                             prefill_budget=eng_j.prefill_budget,
                             chunked_prefill=eng_j.chunked_prefill,
                             host_pool_bytes=HOST_BYTES, device=eng_j.device)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.json")
        t0 = time.perf_counter()
        a = fresh()
        with invariants_every_step():
            done_a = a.generate(mixed_requests(eng_j.cfg, args))
        t1 = time.perf_counter()
        n_saved = a.save_index(path)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
        b = fresh()
        n_loaded = b.load_index(path)
        t3 = time.perf_counter()
        with invariants_every_step():
            done_b = b.generate(mixed_requests(eng_j.cfg, args))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        sa, sb = a.pool_stats(), b.pool_stats()
        same = [sum(r.out_tokens == ref[r.rid] for r in d) for d in (done_a, done_b)]
        eng_i = runs["i-prefix-chunked"][0]
        other = _sched_like(eng_i, serve.build_parser().parse_args(
            serve_argv("i-prefix-chunked")), host_pool_bytes=HOST_BYTES)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            n_bf16 = other.load_index(path)
        geo_warned = any("geometry" in str(w.message) for w in caught)
        del other
        h4 = {"digests_saved": n_saved, "digests_loaded": n_loaded, "index_bytes": size,
              "identical_a": same[0], "identical_b": same[1],
              "seconds": {"serve_a": t1 - t0, "save": t2 - t1, "load": t3 - t2,
                          "serve_b": t4 - t3},
              "a": {k: sa[k] for k in HOST_DELTAS}, "b": {k: sb[k] for k in HOST_DELTAS},
              "bf16_pool_loaded": n_bf16, "bf16_pool_warned": geo_warned,
              "drained": _drained(a._sched) and _drained(b._sched)}
        log(f"host tier [H4 restart, {name}]: {h4}")
        if not (same == [8, 8] and n_saved > 0 and n_loaded == n_saved and h4["drained"]
                and sb["host_hit_tokens"] > 0
                and sb["prefill_tokens_computed"] < sa["prefill_tokens_computed"]):
            bad.append(f"H4: identical {same}, saved {n_saved}, loaded {n_loaded}, host hit "
                       f"tokens {sb['host_hit_tokens']}, prefill tokens "
                       f"{sb['prefill_tokens_computed']} vs {sa['prefill_tokens_computed']}")
        if n_bf16 != 0 or not geo_warned:
            bad.append(f"H4: the int8 index loaded {n_bf16} digests into a bf16 pool "
                       f"(warned: {geo_warned})")
        out["H4"] = h4

        cli = []
        path = os.path.join(tmp, "cli_index.json")
        argv = serve_argv(name) + ["--host-pool-bytes", str(HOST_BYTES), "--index", path]
        for i in range(2):
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text), invariants_every_step():
                cli_engine, cli_done, report = serve.run(
                    serve.build_parser().parse_args(argv), mixed_requests, params=raw_params)
            printed = text.getvalue()
            log(printed.rstrip())
            st = report["stats"]
            saved = re.search(r"saved (\d+) prefix digests", printed)
            loaded = re.search(r"loaded (\d+) prefix digests", printed)
            cli.append({"seconds": time.perf_counter() - t0,
                        "identical": sum(r.out_tokens == ref[r.rid] for r in cli_done),
                        "saved": int(saved.group(1)) if saved else None,
                        "loaded": int(loaded.group(1)) if loaded else None,
                        "host_tier_line": "  host tier: " in printed,
                        "drained": _drained(cli_engine._sched),
                        **{k: st[k] for k in HOST_DELTAS}})
            del cli_engine
        log(f"host tier [CLI --index, {name}]: {cli}")
        if not (cli[0]["saved"] and cli[0]["loaded"] is None and cli[1]["loaded"]
                and cli[1]["host_tier_line"] and cli[1]["host_hit_blocks"] > 0
                and all(c["identical"] == 8 and c["drained"] for c in cli)):
            bad.append(f"CLI --index: {cli}")
        out["cli"] = cli
    if bad:
        raise AssertionError(f"host tier: {bad}")
    return out


def compare_prefix(torch, runs):
    """The prefix cache's gates on runs (i) and (j).

    (i) Each run's stream served once more by the run's engine with the
    cache off (--no-prefix-cache): every
    greedy request's tokens, in the warm run's warmup pass (live sharing,
    chunk plans from the first uncached block) and its timed pass (every
    prompt resident), identical to the cold run's. (ii) First-token
    logits of a partial hit and of a whole-prompt hit bitwise equal (max
    |err| 0) to the cold admission of the same prompt in the same mode,
    chunked and whole-prompt, on run (i)'s bf16 pool and run (j)'s int8
    pool (``admission_logits``). (iii) Run (i) hit blocks and copied a
    block on write. Everything prints before a gate raises."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    out, bad = {}, []
    for name in ("i-prefix-chunked", "j-prefix-solo-int8"):
        engine, report, _, tokens = runs[name]
        # The run's engine with the cache off, serving the stream once.
        cold_engine = ServingEngine(
            engine.cfg, engine.params, max_batch=engine.max_batch, bucket=engine.bucket,
            block_size=engine.block_size, pool_blocks=engine.pool_blocks,
            prefix_cache=False, chunked_prefill=engine.chunked_prefill,
            prefill_budget=engine.prefill_budget, device=engine.device)
        args = serve.build_parser().parse_args(serve_argv(name))
        t0 = time.perf_counter()
        cold_done = cold_engine.generate(mixed_requests(engine.cfg, args))
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        check_outputs(f"{name} without the prefix cache", cold_engine, cold_done)
        cold = {r.rid: r.out_tokens for r in cold_done}
        greedy = [r.rid for r in cold_done if r.temperature == 0]
        shares = {"warmup": _greedy_share(report["warmup_tokens"], cold, greedy),
                  "timed": _greedy_share(tokens, cold, greedy)}
        logits = admission_logits(torch, engine)
        st = report["stats"]
        cold_tps = sum(len(r.out_tokens) for r in cold_done) / cold_s
        out[name] = {"greedy_vs_cold": shares, "logits_max_err": logits,
                     "cold_tok_per_s": cold_tps,
                     **{k: st[k] for k in ("prefix_hit_rate", "prefix_hit_blocks",
                                           "cow_copies", "prefix_evictions")}}
        log(f"prefix cache [{name}]: greedy requests identical to --no-prefix-cache: "
            f"warmup pass {shares['warmup']}, timed pass {shares['timed']} (gated at "
            f"all); first-token logits warm vs cold max |err| {logits} (gated at 0); "
            f"one pass without the cache {cold_tps:.1f} tok/s")
        full = f"{len(greedy)}/{len(greedy)}"
        bad += [f"{name} greedy {k} {v}" for k, v in shares.items() if v != full]
        bad += [f"{name} logits {k} {v}" for k, v in logits.items() if v != 0.0]
    st = runs["i-prefix-chunked"][1]["stats"]
    if not (st["prefix_hit_blocks"] > 0 and st["cow_copies"] > 0):
        bad.append(f"i-prefix-chunked: {st['prefix_hit_blocks']} block hits, "
                   f"{st['cow_copies']} CoW copies")
    if bad:
        raise AssertionError(f"prefix cache: {bad}")
    return out


SPEC_RUNS = ("k-spec-int8", "l-spec-table3-prefix")


def compare_speculation(torch, runs):
    """Speculation's gates on runs (k) and (l).

    (a) Each run's stream served once more by an engine on the run's
    weights and flags without --speculate: every greedy request's tokens
    in the speculating run's warmup pass and timed pass identical to it.
    (b) ``verify_vs_decode`` on run (k)'s int8 pool and run (l)'s bf16
    pool, at every verify width Lc = k + 1 for k in ``VERIFY_KS`` (the
    runs' own --speculate among them). (c) The counters: more drafts than
    accepted tokens in both runs, some accepted in run (k), verify rows >=
    verify calls > 0, the requests' ``spec_drafted``/``spec_accepted``
    summing to the scheduler's totals over both passes, and the
    ``paged_prefill`` launches counted inside the verify calls equal to
    one a layer for each verified row. (The pool invariants, (d), hold
    after every paged run, ``check_outputs``.) Everything prints before a
    gate raises."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    out, bad = {}, []
    for name in SPEC_RUNS:
        engine, report, _, tokens = runs[name]
        plain = ServingEngine(
            engine.cfg, engine.params, max_batch=engine.max_batch, bucket=engine.bucket,
            block_size=engine.block_size, pool_blocks=engine.pool_blocks,
            prefix_cache=engine.prefix_cache, chunked_prefill=engine.chunked_prefill,
            prefill_budget=engine.prefill_budget, device=engine.device)
        args = serve.build_parser().parse_args(serve_argv(name))
        t0 = time.perf_counter()
        plain_done = plain.generate(mixed_requests(engine.cfg, args))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check_outputs(f"{name} without --speculate", plain, plain_done)
        ref_toks = {r.rid: r.out_tokens for r in plain_done}
        greedy = [r.rid for r in plain_done if r.temperature == 0]
        shares = {"warmup": _greedy_share(report["warmup_tokens"], ref_toks, greedy),
                  "timed": _greedy_share(tokens, ref_toks, greedy)}
        st = report["stats"]
        per_req = report["requests_spec"]
        verify = report["verify"]
        k = int(args.speculate)
        assert k in VERIFY_KS, (k, VERIFY_KS)
        err = verify_vs_decode(torch, engine, args.draft_policy, VERIFY_KS)
        worst = max(e["logits_max_err"] for e in err.values())
        keys = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
                "spec_acceptance_rate", "spec_verify_calls", "spec_verify_rows",
                "prefix_hit_rate", "cow_copies", "prefix_evictions")
        out[name] = {"greedy_vs_no_speculation": shares, "verify_vs_decode": err,
                     "no_speculation_tok_per_s":
                         sum(len(r.out_tokens) for r in plain_done) / plain_s,
                     "tok_per_s": report["tok_per_s"], "speculate": k,
                     "per_request_drafted_accepted": per_req,
                     "verify_launches": verify,
                     **{key: st[key] for key in keys}}
        log(f"speculation [{name}] k={k} draft {args.draft_policy}: greedy requests "
            f"identical to the stream without --speculate: warmup pass {shares['warmup']}, "
            f"timed pass {shares['timed']} (gated at all); {st['spec_accepted_tokens']}/"
            f"{st['spec_draft_tokens']} drafts accepted over {st['spec_rounds']} rounds, "
            f"{st['spec_verify_rows']} rows in {st['spec_verify_calls']} verify calls; "
            f"requests' sums {per_req}; prefix hit rate {st['prefix_hit_rate']:.4f}, "
            f"{st['cow_copies']} CoW copies, {st['prefix_evictions']} evictions; "
            f"{verify['launches']} paged_prefill launches in {verify['rows']} verified "
            f"rows x {engine.cfg.num_layers} layers; verify vs decode at Lc "
            f"{[kk + 1 for kk in VERIFY_KS]}: logits max |err| {worst}, pool bitwise "
            f"{all(e['pool_bitwise'] for e in err.values())}, dead rows kept "
            f"{all(e['dead_rows_kept'] for e in err.values())}; "
            f"{report['tok_per_s']:.1f} tok/s against "
            f"{out[name]['no_speculation_tok_per_s']:.1f} without --speculate (one pass)")
        full = f"{len(greedy)}/{len(greedy)}"
        bad += [f"{name} greedy {p} {v}" for p, v in shares.items() if v != full]
        if not st["spec_draft_tokens"] > st["spec_accepted_tokens"]:
            bad.append(f"{name}: every draft accepted ({st['spec_accepted_tokens']})")
        if not st["spec_verify_rows"] >= st["spec_verify_calls"] > 0:
            bad.append(f"{name}: {st['spec_verify_rows']} rows in "
                       f"{st['spec_verify_calls']} verify calls")
        if per_req != [st["spec_draft_tokens"], st["spec_accepted_tokens"]]:
            bad.append(f"{name}: requests' drafted/accepted {per_req} != the scheduler's "
                       f"{st['spec_draft_tokens']}/{st['spec_accepted_tokens']}")
        if not (verify["rows"] == st["spec_verify_rows"] and verify["calls"] ==
                st["spec_verify_calls"] and verify["launches"] ==
                verify["rows"] * engine.cfg.num_layers > 0):
            bad.append(f"{name}: verify launches {verify} against "
                       f"{st['spec_verify_rows']} rows x {engine.cfg.num_layers} layers "
                       f"in {st['spec_verify_calls']} calls")
        for kk, e in err.items():
            if e["logits_max_err"] != 0.0 or not e["pool_bitwise"] or not e["dead_rows_kept"]:
                bad.append(f"{name}: verify vs decode at k={kk} {e}")
    if not runs["k-spec-int8"][1]["stats"]["spec_accepted_tokens"] > 0:
        bad.append("k-spec-int8: no draft accepted")
    if bad:
        raise AssertionError(f"speculation: {bad}")
    return out


# Draft lengths at which verify_vs_decode holds the verify chunk (Lc = k + 1
# rows through the LM head) against decode (B = 4 rows): Lc 2-9.
VERIFY_KS = tuple(range(1, 9))


def verify_vs_decode(torch, engine, draft, ks):
    """The verify chunk against the decode steps it replaces, on
    `engine`'s weights and pool type, for each draft length k of `ks`. One
    greedy prompt (203 tokens) is prefilled into slot 0 of a 4-slot pool
    whose other rows sit at other positions behind all -1 tables; then,
    for each k: k + 1 full-policy decode steps (tokens t0..tk at
    positions n..n+k, logits and written pool bytes kept); positions
    restored by ``set_decode_positions``; draft-policy K/V written over
    the same positions (the same tokens through the plane-truncated view);
    positions restored; then ``prefill_chunk_logits_multi`` over [t0..tk]
    with one live row and three dead ones; positions restored for the
    next k. Returns, by k, the verify logits' max |err| against the decode
    logits (gated at 0), whether the verified pool bytes (codes and scale
    planes on int8) equal the decode-written ones bitwise, whether the
    draft's bytes differed from them, and whether the dead rows'
    pos/length and every block but row 0's (and the trash block) kept
    their values."""
    import numpy as np

    from repro_torch.models.kv_cache import set_decode_positions
    from repro_torch.serving.speculative import derive_draft_params

    cfg, params, model, dev = engine.cfg, engine.params, engine.model, engine.device
    B, bs, budget = 4, 16, 32
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab, 203).astype(np.int64)
    n = len(prompt)
    nrow = -(-(n + max(ks) + 1) // bs)
    cache = model.init_paged_cache(B, 2 * nrow + 1, bs, nrow, device=dev)
    blocks = torch.arange(1, nrow + 1, dtype=torch.int32)
    for start in range(0, n, budget):
        t = min(budget, n - start)
        toks = np.zeros((1, budget), np.int64)
        toks[0, :t] = prompt[start:start + t]
        cache, lg = model.prefill_chunk(params, cache, {
            "tokens": torch.from_numpy(toks).to(dev), "lengths": [t], "start": start,
            "slot": 0, "blocks": blocks[:-(-(start + t) // bs)]})
    t0 = int(lg[0, -1].argmax())
    table = np.full((B, nrow), -1, np.int32)
    table[0] = blocks.numpy()
    cache.kv.block_table.copy_(torch.from_numpy(table))
    pos0 = np.asarray([n, 17, 40, 77], np.int64)
    kv = cache.kv
    planes = [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if kv.quantized else [])
    others = torch.ones(planes[0].shape[1], dtype=torch.bool, device=dev)
    others[0] = False
    others[blocks.long().to(dev)] = False
    dparams, _ = derive_draft_params(params, draft)
    cur = np.zeros((B, 1), np.int64)
    out = {}
    for k in ks:
        set_decode_positions(cache, pos0, pos0)
        where = [n + i for i in range(k + 1)]
        blk = blocks[[p // bs for p in where]].long().to(dev)
        off = torch.tensor([p % bs for p in where], device=dev)

        def written():
            return [a[:, blk, off].clone() for a in planes]

        seq = [t0]
        dec = []
        for i in range(k + 1):
            cur[0, 0] = seq[i]
            cache, lg = model.decode_step(params, cache, torch.from_numpy(cur).to(dev))
            dec.append(lg[0, -1].clone())
            seq.append(int(lg[0, -1].argmax()))
        decoded = written()
        set_decode_positions(cache, pos0, pos0)
        for i in range(k + 1):
            cur[0, 0] = seq[i]
            cache, _ = model.decode_step(dparams, cache, torch.from_numpy(cur).to(dev))
        drafted = written()
        set_decode_positions(cache, pos0, pos0)
        before = [a[:, others].clone() for a in planes]
        tokens = np.zeros((B, k + 1), np.int64)
        tokens[0] = seq[:k + 1]
        btab = np.full((B, nrow), -1, np.int32)
        btab[0] = blocks.numpy()
        cache, vlog = model.prefill_chunk_logits_multi(params, cache, {
            "tokens": torch.from_numpy(tokens).to(dev), "lengths": [k + 1, 0, 0, 0],
            "starts": [n, 0, 0, 0], "slots": [0, -1, -1, -1],
            "blocks": torch.from_numpy(btab)})
        torch.cuda.synchronize()
        out[k] = {
            "logits_max_err": max((vlog[0, i] - dec[i]).abs().max().item()
                                  for i in range(k + 1)),
            "argmax_equal": int((vlog[0].argmax(-1).cpu() == torch.tensor(seq[1:])).sum()),
            "pool_bitwise": all(torch.equal(a, b) for a, b in zip(written(), decoded)),
            "draft_bytes_differed": any(not torch.equal(a, b)
                                        for a, b in zip(drafted, decoded)),
            "dead_rows_kept": (cache.pos.tolist() == kv.length.tolist()
                               == [n + k + 1, 17, 40, 77]
                               and all(torch.equal(a[:, others], b)
                                       for a, b in zip(planes, before)))}
    return out


def admission_logits(torch, engine):
    """First-token logits of prompt A (200 shared + 44 own tokens: 15
    whole blocks and a partial one) and B (the same 200 + 52 others) on
    `engine`'s weights and pool type, in chunked and whole-prompt
    admission: a scheduler with the prefix cache serves A cold, then B (a
    partial hit: 12 blocks resident, the suffix prefilled), then A again
    (a whole-prompt hit, its partial block copied on write at the first
    decode); one without the cache serves A and B cold. Returns max |err|
    warm vs cold per mode and hit kind."""
    import numpy as np

    from repro_torch.serving import ContinuousScheduler, Request, assert_pool_invariants

    cfg = engine.cfg
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab, SHARED_PREFIX)
    a = np.concatenate([shared, rng.integers(0, cfg.vocab, 44)]).astype(np.int64)
    b = np.concatenate([shared, rng.integers(0, cfg.vocab, 52)]).astype(np.int64)
    errs = {}
    for chunked in (True, False):
        seen = {}
        for cache_on in (False, True):
            sched = ContinuousScheduler(cfg, engine.params, max_batch=2, max_ctx=320,
                                        block_size=16, prefill_budget=32, bucket=32,
                                        prefix_cache=cache_on, chunked_prefill=chunked,
                                        device=engine.device)
            first = sched._first_token

            def grab(req, slot, logits, first=first, cache_on=cache_on):
                seen[(cache_on, req.rid)] = logits[0, -1].float().clone()
                return first(req, slot, logits)

            sched._first_token = grab
            for rid, p in enumerate((a, b, a) if cache_on else (a, b)):
                sched.run([Request(rid=rid, prompt=p, max_new_tokens=3)])
            assert_pool_invariants(sched)
        st = sched.pool_stats()
        if st["prefix_hit_tokens"] != 192 + len(a) or st["cow_copies"] < 1:
            raise AssertionError(f"admission_logits (chunked={chunked}): "
                                 f"{st['prefix_hit_tokens']} hit tokens, "
                                 f"{st['cow_copies']} CoW copies")
        mode = "chunked" if chunked else "whole"
        errs[f"{mode}_partial_hit"] = (seen[(True, 1)] - seen[(False, 1)]).abs().max().item()
        errs[f"{mode}_full_hit"] = (seen[(True, 2)] - seen[(False, 0)]).abs().max().item()
    return errs


def _greedy_share(a, b, rids):
    return f"{sum(a[r] == b[r] for r in rids)}/{len(rids)}"


def first_token_logits(torch, model, params, prompts):
    """First-token logits (float32) of each prompt through three prefill
    paths on the card: solo whole-prompt prefill, chunked prefill (32-token
    chunks into a paged bf16/f32 pool of 16-token blocks) and static
    batches of 4 right-padded prompts. Returns (solo, chunked, batch)."""
    import numpy as np

    bucket, bs, budget = 32, 16, 32
    dev = params["embed"].device

    def prefill(batch):
        L = max(-(-len(p) // bucket) * bucket for p in batch)
        toks = np.zeros((len(batch), L), np.int64)
        for i, p in enumerate(batch):
            toks[i, :len(p)] = p
        _, lg = model.prefill(params, {
            "tokens": torch.from_numpy(toks).to(dev),
            "lengths": torch.tensor([len(p) for p in batch], dtype=torch.int32)})
        return lg[:, -1].float()

    def chunked(p):
        nb = -(-len(p) // bs)
        cache = model.init_paged_cache(1, nb + 1, bs, nb, device=dev)
        blocks = torch.arange(1, nb + 1, dtype=torch.int32)
        for start in range(0, len(p), budget):
            t = min(budget, len(p) - start)
            toks = np.zeros((1, budget), np.int64)
            toks[0, :t] = p[start:start + t]
            cache, lg = model.prefill_chunk(params, cache, {
                "tokens": torch.from_numpy(toks).to(dev), "lengths": [t],
                "start": start, "slot": 0,
                "blocks": blocks[:-(-(start + t) // bs)]})
        return lg[0, -1].float()

    solo = torch.stack([prefill([p])[0] for p in prompts])
    chunk = torch.stack([chunked(p) for p in prompts])
    batch = torch.cat([prefill(prompts[i:i + 4]) for i in range(0, len(prompts), 4)])
    return solo, chunk, batch


def compare_paths(torch, engine, runs):
    """Whole-prompt vs chunked prefill and the static batch of 4 vs solo
    prefill, on engine (c)'s packed weights (Table III policy, bf16 pool),
    by the first-token logits of the 8 prompts, and the greedy tokens of
    the serve runs of those paths.

    The attention kernels share one tile routine (csrc/attend_tile.cuh),
    so with the kernels on the bf16 pool the paths compute the same bits.
    Gated: chunked vs whole-prompt first-token logits bitwise equal (max
    |err| 0); greedy tokens identical for every greedy request between
    whole-prompt (c) and chunked-bf16, and between static (a) and
    continuous (c); within atol = rtol = 2e-2, every path against solo
    whole-prompt prefill with the attention kernels swapped for their
    plain versions, and the static batch against solo with the kernels.
    Printed, not gated: the int8 pool's chunked vs whole-prompt difference
    (whole-prompt flash reads dequantized float32 K/V, the chunk kernel
    scores codes and then scales them: another function at float32
    rounding), each path's kernels vs its plain attention, and the static
    solo vs batch greedy share. Every comparison prints before any gate
    raises."""
    import types

    from repro_torch.serving import Request

    reqs = mixed_requests(engine.cfg, types.SimpleNamespace(max_new=32))
    prompts = [r.prompt for r in reqs]
    solo, chunk, batch = first_token_logits(torch, engine.model, engine.params, prompts)
    with plain_attention():
        plain = first_token_logits(torch, engine.model, engine.params, prompts)
    err_plain = max(_close(torch, plain[1], plain[0],
                           "first-token logits, plain attention: chunked vs whole-prompt"),
                    _close(torch, plain[2], plain[0],
                           "first-token logits, plain attention: static batch vs solo"))
    err_batch = _close(torch, batch, solo, "first-token logits, static batch vs solo")
    err_chunk = (chunk - solo).abs().max().item()
    argmax_same = int((chunk.argmax(-1) == solo.argmax(-1)).sum())
    vs_plain = [(k - p).abs().max().item() for k, p in zip((solo, chunk), plain[:2])]
    eng8 = runs["chunked-int8"][0]
    solo8, chunk8, _ = first_token_logits(torch, eng8.model, eng8.params, prompts[:4])
    err_int8 = (chunk8 - solo8).abs().max().item()
    greedy = [r.rid for r in reqs if r.temperature == 0]
    # Static solo: each greedy request alone through engine (a)'s static path.
    eng_a = runs["a-static"][0]
    static_solo = {r.rid: r.out_tokens for r in eng_a.generate_static(
        [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=32) for r in reqs
         if r.temperature == 0])}
    toks = {name: run[3] for name, run in runs.items()}
    shares = {
        "whole_vs_chunked": _greedy_share(toks["c-solo-paged"], toks["chunked-bf16"], greedy),
        "static_vs_continuous": _greedy_share(toks["a-static"], toks["c-solo-paged"], greedy),
        "static_solo_vs_batch": _greedy_share(static_solo, toks["a-static"], greedy),
    }
    log(f"first-token logits: kernels, chunked vs whole-prompt (bf16 pool) max |err| "
        f"{err_chunk:.3g} (gated at 0; argmax equal for {argmax_same}/{len(reqs)}); "
        f"kernels, static batch of 4 vs solo {err_batch:.3g}; plain attention, every "
        f"path vs solo {err_plain:.3g} (both within atol=rtol={ATOL}); int8 pool, "
        f"chunked vs whole-prompt {err_int8:.3g} (not gated); kernels vs plain "
        f"attention: whole-prompt {vs_plain[0]:.3g}, chunked {vs_plain[1]:.3g}")
    log(f"greedy requests with identical tokens: whole-prompt (c) vs chunked "
        f"{shares['whole_vs_chunked']}, static (a) vs continuous (c) "
        f"{shares['static_vs_continuous']} (both gated at all), static solo vs batch "
        f"of 4 {shares['static_solo_vs_batch']}")
    full = f"{len(greedy)}/{len(greedy)}"
    bad = [k for k in ("whole_vs_chunked", "static_vs_continuous") if shares[k] != full]
    if err_chunk != 0.0 or bad:
        raise AssertionError(f"paths part: chunked vs whole-prompt logits max |err| "
                             f"{err_chunk}; greedy shares below {full}: {bad}")
    return {"logits_err_plain_paths": err_plain, "logits_err_batch_vs_solo": err_batch,
            "logits_err_chunked_vs_whole": err_chunk, "argmax_chunked_eq_whole": argmax_same,
            "logits_err_chunked_vs_whole_int8": err_int8,
            "logits_err_kernels_vs_plain": vs_plain, "greedy_shares": shares}


def batch_and_solo_logits(torch, eng, prompts):
    """First-token logits of `prompts` prefilled alone and in static
    batches of 4 (right-padded to 32-token buckets), through engine
    `eng`'s model and weights: (solo, batch), float32."""
    import numpy as np

    def prefill(batch):
        L = max(-(-len(p) // 32) * 32 for p in batch)
        toks = np.zeros((len(batch), L), np.int64)
        for i, p in enumerate(batch):
            toks[i, :len(p)] = p
        _, lg = eng.model.prefill(eng.params, {
            "tokens": torch.from_numpy(toks).cuda(),
            "lengths": torch.tensor([len(p) for p in batch], dtype=torch.int32)})
        return lg[:, -1].float()

    solo = torch.stack([prefill([p])[0] for p in prompts])
    batch = torch.cat([prefill(prompts[i:i + 4]) for i in range(0, len(prompts), 4)])
    return solo, batch


def compare_rwkv6(torch, runs):
    """rwkv6-3b on engine (e)'s weights: first-token logits of the static
    batch of 4 vs solo prefill, and the greedy tokens of static (e) vs
    continuous (f). Every dense product runs the batch-invariant
    dense_matmul kernel and wkv6 is row- and padding-independent, so a
    row computes the same bits in a batch and alone. Gated: the logits
    bitwise equal (max |err| 0) and every greedy request's tokens the
    same in (e) and (f). Both print before the gate raises."""
    import types

    eng = runs["e-rwkv6-static"][0]
    reqs = mixed_requests(eng.cfg, types.SimpleNamespace(max_new=32))
    prompts = [r.prompt for r in reqs]
    solo, batch = batch_and_solo_logits(torch, eng, prompts)
    err = (batch - solo).abs().max().item()
    argmax_same = int((batch.argmax(-1) == solo.argmax(-1)).sum())
    greedy = [r.rid for r in reqs if r.temperature == 0]
    share = _greedy_share(runs["e-rwkv6-static"][3], runs["f-rwkv6-continuous"][3], greedy)
    log(f"rwkv6-3b first-token logits, static batch of 4 vs solo: max |err| {err:.3g} "
        f"(gated at 0; argmax equal {argmax_same}/{len(prompts)}); greedy requests with "
        f"identical tokens, static (e) vs continuous (f): {share} (gated at all)")
    if err != 0.0 or share != f"{len(greedy)}/{len(greedy)}":
        raise AssertionError(f"rwkv6-3b: static batch vs solo logits max |err| {err}, "
                             f"greedy (e) vs (f) {share}")
    return {"logits_err_batch_vs_solo": err, "argmax_batch_eq_solo": argmax_same,
            "greedy_share_e_vs_f": share}


def compare_unpacked(torch, runs):
    """olmo-1b served unpacked (runs (g) static and (h) continuous, no
    policy): first-token logits of the 8 prompts through solo
    whole-prompt prefill, chunked prefill on the bf16 pool and static
    batches of 4, on engine (g)'s weights, and the greedy tokens of (g)
    vs (h). Gated: static batch vs solo and chunked vs whole-prompt
    logits bitwise equal (max |err| 0), and every greedy request's
    tokens the same in (g) and (h). Everything prints before the gate
    raises."""
    import types

    eng = runs["g-olmo-unpacked-static"][0]
    reqs = mixed_requests(eng.cfg, types.SimpleNamespace(max_new=32))
    solo, chunk, batch = first_token_logits(torch, eng.model, eng.params,
                                            [r.prompt for r in reqs])
    err_batch = (batch - solo).abs().max().item()
    err_chunk = (chunk - solo).abs().max().item()
    greedy = [r.rid for r in reqs if r.temperature == 0]
    share = _greedy_share(runs["g-olmo-unpacked-static"][3],
                          runs["h-olmo-unpacked-continuous"][3], greedy)
    log(f"olmo-1b unpacked, first-token logits: static batch of 4 vs solo max |err| "
        f"{err_batch:.3g}, chunked vs whole-prompt {err_chunk:.3g} (both gated at 0); "
        f"greedy requests with identical tokens, static (g) vs continuous (h): {share} "
        "(gated at all)")
    if err_batch != 0.0 or err_chunk != 0.0 or share != f"{len(greedy)}/{len(greedy)}":
        raise AssertionError(f"olmo-1b unpacked: batch vs solo {err_batch}, chunked vs "
                             f"whole-prompt {err_chunk}, greedy (g) vs (h) {share}")
    return {"logits_err_batch_vs_solo": err_batch,
            "logits_err_chunked_vs_whole": err_chunk, "greedy_share_g_vs_h": share}


class plain_attention:
    """Within the block, the model's attention kernels (flash_attention,
    paged_prefill) run their plain PyTorch versions on the card."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention, paged_prefill, ref

        self.saved = [(m, m.launch) for m in (flash_attention, paged_prefill)]
        flash_attention.launch = lambda q, k, v, **kw: ref.flash_attention_gqa_ref(q, k, v, **kw)
        paged_prefill.launch = lambda *a, **kw: ref.paged_prefill_ref(*a, **kw)

    def __exit__(self, *exc):
        for m, fn in self.saved:
            m.launch = fn


class library_linear:
    """Within the block, a model's dense (unpacked) linears run the
    library's ``x @ w`` on the card instead of ``ops.dense_matmul``."""

    def __enter__(self):
        from repro_torch.core.quantized_linear import PackedWeight
        from repro_torch.models import common

        self.saved = saved = common.linear

        def linear(x, w, quant=None):
            return saved(x, w, quant) if isinstance(w, PackedWeight) else x @ w.to(x.dtype)

        common.linear = linear
        return self

    def __exit__(self, *exc):
        from repro_torch.models import common

        common.linear = self.saved


def paths_diagnostic(torch):
    """`chip_smoke.py paths`: how far the prefill paths' first-token logits
    part at full size, and why. Full-size olmo-1b (seed 0) on the 8
    prompts of the serve stream, per variant: bf16 under the Table III
    policy with the kernels and with plain attention, bf16 unpacked
    (no quantization), and a float32 model under the Table III policy.
    The unquantized model runs twice: its dense products on
    ``dense_matmul`` (the serving path) and on the library's ``x @ w``.
    Prints max |err| of chunked vs solo and batch vs solo, the argmax
    agreement, the logits' spread, and kernel vs plain per path; writes
    paths.json under $CHIP_SMOKE_OUT. Not part of the default run."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.core.precision import parse_policy_spec
    from repro_torch.core.quantized_linear import quantize_params_for_serving
    from repro_torch.models import build_model

    out = {}

    def measure(name, model, params, prompts, plain=False):
        if plain:
            with plain_attention():
                lg = first_token_logits(torch, model, params, prompts)
        else:
            lg = first_token_logits(torch, model, params, prompts)
        solo, chunk, batch = lg
        row = {"chunk_vs_solo": (chunk - solo).abs().max().item(),
               "batch_vs_solo": (batch - solo).abs().max().item(),
               "argmax_chunk_eq_solo": int((chunk.argmax(-1) == solo.argmax(-1)).sum()),
               "argmax_batch_eq_solo": int((batch.argmax(-1) == solo.argmax(-1)).sum()),
               "logit_std": solo.std().item(), "logit_absmax": solo.abs().max().item()}
        out[name] = row
        log(f"paths [{name}]: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                             else f"{k} {v}" for k, v in row.items()))
        return lg

    cfg = get_config("olmo-1b")
    prompts = [r.prompt for r in mixed_requests(cfg, types.SimpleNamespace(max_new=32))]
    mixed = parse_policy_spec(MIXED_POLICY)
    model = build_model(cfg)
    raw = model.init(seed=0, device="cuda")
    packed = quantize_params_for_serving(raw, mixed, min_size=1024)
    kern = measure("bf16 w4a6r25 kernels", model, packed, prompts)
    plain = measure("bf16 w4a6r25 plain attention", model, packed, prompts, plain=True)
    for i, path in enumerate(("solo", "chunk", "batch")):
        d = (kern[i] - plain[i]).abs().max().item()
        out[f"kernel_vs_plain_{path}"] = d
        log(f"paths: bf16 w4a6r25 {path}: kernels vs plain attention max |err| {d:.4g}")
    measure("bf16 unquantized kernels", model, raw, prompts)
    with library_linear():
        measure("bf16 unquantized, library x @ w", model, raw, prompts)
    del raw, packed
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    p32 = quantize_params_for_serving(model32.init(seed=0, device="cuda"), mixed,
                                      min_size=1024)
    measure("f32 w4a6r25 kernels", model32, p32, prompts)
    del p32
    out["rwkv6"] = rwkv6_batch_diagnostic(torch)
    write_detail("paths.json", out)


def rwkv6_batch_diagnostic(torch):
    """Part of `chip_smoke.py paths`: whether rwkv6-3b's static batch of
    4 and solo prefill part, and where. For each of its weight shapes, how
    far the rows of a bf16 product at M in {1, 4, 64, 128, 256, 320}
    (decode and solo prefills of the stream's bucketed prompts) differ
    from the same rows inside a product at M = 1280 (a static batch of 4 ×
    320), for torch.matmul (cuBLAS picks its plan by M) and for the
    dense_matmul kernel the model runs; and the first-token logits of the
    batch vs solo in bf16 and in a float32 copy of the model (full width,
    4 layers)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import dense_matmul
    from repro_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {}
    for K, N in ((2560, 2560), (2560, 8960), (8960, 2560), (2560, 65536)):
        w = (torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((1280, K), generator=gen, device="cuda").to(torch.bfloat16)
        for name, mm in (("torch.matmul", torch.matmul), ("dense_matmul", dense_matmul.launch)):
            full = mm(x, w).float()
            for m in (1, 4, 64, 128, 256, 320):
                res[f"{name} {K}x{N}: rows at M={m} vs the same rows at M=1280"] = \
                    (mm(x[:m], w).float() - full[:m]).abs().max().item()
    prompts = [np.random.default_rng(0).integers(0, 65536, n).astype(np.int64)
               for n in (64, 320, 128, 256)]
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("rwkv6-3b"), dtype=dtype, num_layers=4)
        model = build_model(cfg)
        params = model.init(seed=0, device="cuda")

        def prefill(batch):
            L = max(-(-len(p) // 32) * 32 for p in batch)
            toks = np.zeros((len(batch), L), np.int64)
            for i, p in enumerate(batch):
                toks[i, :len(p)] = p
            return model.prefill(params, {
                "tokens": torch.from_numpy(toks).cuda(),
                "lengths": torch.tensor([len(p) for p in batch], dtype=torch.int32)})[1][:, -1]

        solo = torch.cat([prefill([p]) for p in prompts]).float()
        batch = prefill(prompts).float()
        res[f"{dtype} 4 layers: first-token logits batch of 4 vs solo"] = \
            (batch - solo).abs().max().item()
        del params
    for k, v in res.items():
        log(f"paths [rwkv6]: {k}: max |err| {v:.4g}")
    return res


def solo_vs_mid_decode(engine):
    """A greedy request alone in a 4-slot scheduler vs the same request
    admitted while three others are decoding: identical tokens."""
    import numpy as np

    from repro_torch.serving import ContinuousScheduler, Request

    cfg = engine.cfg
    rng = np.random.default_rng(7)
    target = rng.integers(0, cfg.vocab, 200).astype(np.int64)
    others = [rng.integers(0, cfg.vocab, n).astype(np.int64) for n in (80, 150, 40)]

    def sched():
        return ContinuousScheduler(cfg, engine.params, max_batch=4, max_ctx=256,
                                   block_size=16, prefill_budget=32, device=engine.device)

    solo = sched()
    r = Request(rid=99, prompt=target, max_new_tokens=24)
    solo.run([r])
    mixed = sched()
    for i, p in enumerate(others):
        mixed.submit(Request(rid=i, prompt=p, max_new_tokens=40, temperature=0.7))
    for _ in range(12):
        mixed.step()
    r2 = Request(rid=99, prompt=target, max_new_tokens=24)
    mixed.submit(r2)
    while mixed.num_active or mixed.num_waiting:
        mixed.step()
    if r.out_tokens != r2.out_tokens:
        raise AssertionError(f"solo {r.out_tokens} != mid-decode {r2.out_tokens}")
    return r.out_tokens


HEAD_M = tuple(range(1, 10))


def head_rows(torch, head, transpose=False):
    """The bf16 LM head on the card at M in HEAD_M rows: through
    ``models.common.logits_head`` (``torch.matmul``, the serving route)
    and through ``ops.dense_matmul``; an untied (d, V) head, or with
    `transpose` a tied (V, d) embedding. Returns, per route, the (M, row)
    pairs whose logits are not bitwise the row's logits at M = 4."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import logits_head

    gen = torch.Generator(device=head.device).manual_seed(16)
    w = head.t().contiguous() if transpose else head
    x = torch.randn((max(HEAD_M), w.shape[0]), generator=gen,
                    device=head.device).to(torch.bfloat16)
    routes = {"torch.matmul": lambda a: logits_head(a, head, transpose=transpose),
              "dense_matmul": lambda a: ops.dense_matmul(a, w).to(torch.float32)}
    parted = {}
    for route, fn in routes.items():
        at4 = fn(x[:4])
        parted[route] = [(M, i) for M in HEAD_M for i in range(min(M, 4))
                         if not torch.equal(fn(x[:M])[i], at4[i])]
    torch.cuda.synchronize()
    return parted


def _mem_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9


def launch_counts():
    """The kernels' launch counts since the last reset, with the
    contiguous and ring entries' shares of paged_attention's count, and
    rglru's prefill (T > 1) and step (T = 1) shares of its count, as keys
    of their own."""
    from repro_torch.kernels import ops, paged_attention, rglru

    counts = ops.launch_counts()
    counts["contig_attention"] = paged_attention.contig_launches
    counts["ring_attention"] = paged_attention.ring_launches
    counts["rglru_step"] = rglru.step_launches
    counts["rglru_prefill"] = counts["rglru"] - rglru.step_launches
    return counts


def _draw(torch, dev, cfg, rep, head_check=None):
    """Draw `cfg`'s raw bf16 weights (seed 0) on the card and run
    `head_check` on them; the time, peak and parameter count go into
    `rep`. Returns the raw tree."""
    import gc

    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = build_model(cfg).init(seed=0, device=dev)
    torch.cuda.synchronize()
    rep["init_s"], rep["init_peak_gb"] = time.perf_counter() - t0, _mem_gb(torch)
    rep["parameters"] = _numel(raw)
    if head_check:
        head_check(raw)
    return raw


def _pack(torch, raw, policy, rep):
    """`raw` packed under `policy` (the leaves it does not pack are
    `raw`'s own tensors); the time and peak go into `rep`."""
    from repro_torch.core.precision import parse_policy_spec
    from repro_torch.core.quantized_linear import quantize_params_for_serving

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed = quantize_params_for_serving(raw, parse_policy_spec(policy), min_size=1024)
    torch.cuda.synchronize()
    rep["pack_s"], rep["pack_peak_gb"] = time.perf_counter() - t0, _mem_gb(torch)
    return packed


def _draw_and_pack(torch, dev, cfg, policy, rep, smi, head_check=None):
    """Draw `cfg`'s raw bf16 weights (seed 0) on the card, run
    `head_check` on them, pack them under `policy` and drop them; the
    times and peaks go into `rep`. Returns the packed tree."""
    import gc

    raw = _draw(torch, dev, cfg, rep, head_check)
    packed = _pack(torch, raw, policy, rep)
    del raw
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rep["resident_gb"] = torch.cuda.memory_allocated() / 1e9
    log(f"{cfg.name}: {rep['parameters']} parameters, init {rep['init_s']:.2f}s (peak "
        f"{rep['init_peak_gb']:.2f} GB), packed under {policy} in {rep['pack_s']:.2f}s "
        f"(peak {rep['pack_peak_gb']:.2f} GB), {rep['resident_gb']:.2f} GB resident "
        f"[{smi}]")
    return packed


def _counted(torch, fn):
    """fn() with every launch count set to 0 just before and read just
    after (the contiguous and ring entries' shares of paged_attention's
    count as their own keys). Returns (fn's result, counts)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def serve_new_archs(torch, dev):
    """Runs (o)-(r) of ARCH_RUNS and their gates, one arch at a time: the
    raw bf16 weights (seed 0) are drawn, the head gate runs on them, they
    are packed once under the arch's policy and dropped (the packed tree
    keeps the embedding, head and norms), both runs serve that tree, and
    the tree and the runs' engines are dropped before the next arch.

    Gated (besides ``serve_run``'s checks): the untied head's rows at M =
    1-9 bitwise its rows at M = 4 (``head_rows``, the serving route);
    nemotron-4-15b: (p) static emits (o)'s greedy tokens, chunked and
    whole-prompt first-token logits bitwise equal on the bf16 pool
    (``first_token_logits``), solo ≡ mid-decode admission on (o)'s
    engine; stablelm-12b: (r) emits (q)'s greedy tokens in both passes,
    the draft/verify counters hold together, ``verify_vs_decode`` on (r)'s
    int8 pool at head dim 160 (logits and pool bytes bitwise at Lc =
    2-9), solo ≡ mid-decode admission on (q)'s engine. Prints the time and
    peak device memory of each init, pack and run. Everything prints
    before a gate raises. Returns (report, launch counts summed over the
    four runs)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    plan = (("nemotron-4-15b", MIXED_POLICY, ("o-nemotron-chunked", "p-nemotron-static")),
            ("stablelm-12b", POLICY, ("q-stablelm-int8", "r-stablelm-spec-int8")))
    out, counts, bad = {}, {}, []
    smi = nvidia_smi()
    for arch, policy, names in plan:
        rep = out[arch] = {}

        def untied_head(raw):
            parted = rep["head_parted"] = head_rows(torch, raw["head"])
            log(f"{arch}: untied head {tuple(raw['head'].shape)} rows at M in {HEAD_M} not "
                f"bitwise M = 4: torch.matmul {parted['torch.matmul'] or 'none'} (gated), "
                f"dense_matmul {parted['dense_matmul'] or 'none'}")
            if parted["torch.matmul"]:
                bad.append(f"{arch}: head rows part across M {parted['torch.matmul']}")

        packed = _draw_and_pack(torch, dev, serve_config(arch), policy, rep, smi,
                                untied_head)
        runs = {}
        for name in names:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runs[name] = serve_run(torch, packed, name)
            run_s, peak = time.perf_counter() - t0, _mem_gb(torch)
            rep[name] = {**runs[name][1], "run_seconds": run_s, "peak_gb": peak}
            for k, n in runs[name][2].items():
                counts[k] = counts.get(k, 0) + n
            log(f"  [{name}] {run_s:.1f}s, peak memory {peak:.2f} GB "
                "(torch.cuda.max_memory_allocated)")
        reqs = mixed_requests(get_config(arch), serve.build_parser().parse_args(
            serve_argv(names[0])))
        greedy = [r.rid for r in reqs if r.temperature == 0]
        full = f"{len(greedy)}/{len(greedy)}"
        if arch == "nemotron-4-15b":
            eng = runs["o-nemotron-chunked"][0]
            share = _greedy_share(runs["p-nemotron-static"][3], runs["o-nemotron-chunked"][3],
                                  greedy)
            solo, chunk, batch = first_token_logits(torch, eng.model, eng.params,
                                                    [r.prompt for r in reqs])
            err_chunk = (chunk - solo).abs().max().item()
            err_batch = (batch - solo).abs().max().item()
            toks = solo_vs_mid_decode(eng)
            rep.update(static_vs_continuous=share, logits_err_chunked_vs_whole=err_chunk,
                       logits_err_batch_vs_solo=err_batch, solo_vs_mid_decode=len(toks))
            log(f"{arch}: greedy (p) static vs (o) chunked {share} (gated at all); "
                f"first-token logits chunked vs whole-prompt (bf16 pool) max |err| "
                f"{err_chunk:.3g} (gated at 0), static batch of 4 vs solo {err_batch:.3g}; "
                f"solo == mid-decode admission: {len(toks)} greedy tokens identical")
            if share != full or err_chunk != 0.0:
                bad.append(f"{arch}: (p) vs (o) {share}, chunked vs whole {err_chunk}")
        else:
            eng = runs["r-stablelm-spec-int8"][0]
            _, report, _, tokens = runs["r-stablelm-spec-int8"]
            ref_toks = runs["q-stablelm-int8"][3]
            shares = {"warmup": _greedy_share(report["warmup_tokens"], ref_toks, greedy),
                      "timed": _greedy_share(tokens, ref_toks, greedy)}
            st, verify = report["stats"], report["verify"]
            err = verify_vs_decode(torch, eng, "w4a8", VERIFY_KS)
            toks = solo_vs_mid_decode(runs["q-stablelm-int8"][0])
            rep.update(speculate_vs_none=shares, verify_vs_decode=err,
                       solo_vs_mid_decode=len(toks))
            worst = max(e["logits_max_err"] for e in err.values())
            log(f"{arch}: greedy (r) --speculate 4 vs (q) without: warmup pass "
                f"{shares['warmup']}, timed pass {shares['timed']} (gated at all); "
                f"{st['spec_accepted_tokens']}/{st['spec_draft_tokens']} drafts accepted "
                f"over {st['spec_rounds']} rounds, {st['spec_verify_rows']} rows in "
                f"{st['spec_verify_calls']} verify calls, {verify['launches']} paged_prefill "
                f"launches in {verify['rows']} verified rows x {eng.cfg.num_layers} layers; "
                f"verify vs decode (int8 pool, head dim {eng.cfg.head_dim}) at Lc "
                f"{[k + 1 for k in VERIFY_KS]}: logits max |err| {worst}, pool bitwise "
                f"{all(e['pool_bitwise'] for e in err.values())}, dead rows kept "
                f"{all(e['dead_rows_kept'] for e in err.values())}; solo == mid-decode "
                f"admission: {len(toks)} greedy tokens identical")
            bad += [f"{arch} greedy {p} {v}" for p, v in shares.items() if v != full]
            if report["requests_spec"] != [st["spec_draft_tokens"], st["spec_accepted_tokens"]]:
                bad.append(f"{arch}: requests' drafted/accepted {report['requests_spec']}")
            if not (verify["rows"] == st["spec_verify_rows"] >= verify["calls"] ==
                    st["spec_verify_calls"] > 0
                    and verify["launches"] == verify["rows"] * eng.cfg.num_layers):
                bad.append(f"{arch}: verify launches {verify} against {st}")
            for k, e in err.items():
                if e["logits_max_err"] != 0.0 or not e["pool_bitwise"] or not e["dead_rows_kept"]:
                    bad.append(f"{arch}: verify vs decode at k={k} {e}")
        del runs, packed, eng
        gc.collect()
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"new archs: {bad}")
    return out, counts


# -- the MoE family and nemotron-4-340b: their kernels, runs (u)-(z) ---------

MIXTRAL, LLAMA4, NEMOTRON_340B = ("mixtral-8x22b", "llama4-maverick-400b-a17b",
                                  "nemotron-4-340b")
# (name, experts, rows, top-k, K, N): the MoE layers' expert products. A
# decode step of 4 slots routes 4 rows (mixtral top-2: 8 assignments over
# its 8 experts, at most 4 an expert; llama4 top-1: 4 of its 128 experts);
# a static prefill of 4 x 320 tokens gives mixtral's 8 experts 2 560
# assignments for a capacity of 400 rows each (the first expert takes 500
# of them here, so its last 100 drop), and llama4's 128 experts 1 280 for
# a capacity of 16. They cover the kernel's plans: one consumer warpgroup
# (cap <= 64) and two, each with one K slice (S = 1: mixtral's gate) and
# with S > 1 (the downs; llama4's gate).
EXPERT_CASES = (("mixtral_decode_gate", 8, 4, 2, 6144, 16384),
                ("mixtral_decode_down", 8, 4, 2, 16384, 6144),
                ("mixtral_prefill_gate", 8, 1280, 2, 6144, 16384),
                ("mixtral_prefill_down", 8, 1280, 2, 16384, 6144),
                ("llama4_decode_gate", 128, 4, 1, 5120, 8192),
                ("llama4_prefill_gate", 128, 1280, 1, 5120, 8192))


def _expert_counts(torch, gen, E, rows, k, skew):
    """Assignments an expert of `rows` tokens routed top-`k` to distinct
    experts (top-1 decode rows to distinct experts too); with `skew`, the
    first 500 tokens' first choice is expert 0."""
    if k == 1 and rows <= E:
        picks = torch.randperm(E, generator=gen)[:rows, None]
    else:
        picks = torch.stack([torch.randperm(E, generator=gen)[:k] for _ in range(rows)])
    if skew:
        picks[:500, 0] = 0
        picks[:500, 1:] = torch.where(picks[:500, 1:] == 0, 1, picks[:500, 1:])
    return torch.bincount(picks.reshape(-1), minlength=E).to(torch.int32)


def _bf16_ulps(torch, a, b):
    """Elementwise distance of two bf16 tensors in units in the last place
    (their bit patterns as ordered integers)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _sampled_rows(kept, bm):
    """Per expert, the first, a middle and the last kept row of each of
    its live bm-row tiles."""
    out = []
    for c in kept:
        rows = set()
        for r0 in range(0, c, bm):
            r1 = min(r0 + bm, c) - 1
            rows.update((r0, (r0 + r1) // 2, r1))
        out.append(sorted(rows))
    return out


def _alone(torch, expert_matmul, xe, w, picks, cap):
    """Each picked row (expert e: rows picks[e]) recomputed alone in a
    buffer of capacity `cap`: one launch a round, each expert's round-j row
    at slot 0 with count 1, NaN in every other slot. Returns {(e, r): row}."""
    E, _, K = xe.shape
    out = {}
    for j in range(max(len(p) for p in picks)):
        buf = torch.full((E, cap, K), float("nan"), dtype=xe.dtype, device=xe.device)
        counts = torch.zeros(E, dtype=torch.int32)
        for e, p in enumerate(picks):
            if j < len(p):
                buf[e, 0] = xe[e, p[j]]
                counts[e] = 1
        y = expert_matmul.launch(buf, w, counts.to(xe.device))
        for e, p in enumerate(picks):
            if j < len(p):
                out[(e, p[j])] = y[e, 0]
    return out


def check_expert_matmul(torch, dev, timer):
    """The grouped expert kernel at the shapes of EXPERT_CASES: within
    atol = rtol = 2e-2 of its plain version ``ref.expert_matmul_ref``, with
    NaN in every buffer row past the count and those rows' outputs
    exactly zero; every count 0 gives all zeros. One bit pattern at every
    capacity: the first, a middle and the last kept row of every live
    tile, each recomputed alone at cap 8 (and llama4's prefill rows at
    cap 16 too), bitwise the row in its full buffer. Every kept row
    bitwise ``dense_matmul`` of the expert's kept rows and of the row
    alone (decode: every row; prefill: each expert's first and last):
    ``wgmma``'s k16 step rounds as ``mma.sync``'s (``dense_bits`` counts
    the elements compared, those that differ and the largest gap in
    ulps, for the record). Times each case (CUDA events, L2
    flushed) beside its bound (the touched experts' weights, the kept
    rows and the whole output, or the kept rows' operations), its plain
    version, ``torch.bmm`` over the whole buffer (the library call) and
    the kernel with every expert full (``all_full_ms``: what skipping
    saves); each entry holds ``schedule()``. Returns the llama4 decode case
    with every case under ``entries``."""
    from repro_torch.kernels import dense_matmul, expert_matmul, ref
    from repro_torch.models.moe import capacity

    gen = torch.Generator(device=dev).manual_seed(32)
    cpu_gen = torch.Generator().manual_seed(32)
    entries, worst, cross_rows = {}, 0.0, 0
    dense_total = {"elements": 0, "differ": 0, "max_ulps": 0}
    for name, E, rows, k, K, N in EXPERT_CASES:
        cap = capacity(rows, k, E, 1.25)
        counts = _expert_counts(torch, cpu_gen, E, rows, k, skew=rows > 64).to(dev)
        kept = counts.clamp(max=cap)
        w = torch.randn((E, K, N), generator=gen, device=dev,
                        dtype=torch.bfloat16) * K ** -0.5
        xe = torch.randn((E, cap, K), generator=gen, device=dev, dtype=torch.bfloat16)
        live = torch.arange(cap, device=dev)[None, :] < kept[:, None]
        xe = torch.where(live[..., None], xe, torch.tensor(float("nan"), dtype=xe.dtype,
                                                           device=dev))
        got = expert_matmul.launch(xe, w, counts)
        want = ref.expert_matmul_ref(xe, w, counts)
        torch.cuda.synchronize()
        what = f"expert_matmul {name} E={E} cap={cap} {K}->{N}"
        worst = max(worst, _close(torch, got, want, what))
        if (got[~live] != 0).any():
            raise AssertionError(f"{what}: rows past the count are not zero")
        kept_l = kept.tolist()
        # Against dense_matmul: the expert's kept rows in one product, and
        # each row alone (decode), or its first and last row alone.
        differ, ulps, n_el = 0, 0, 0
        for e, c in enumerate(kept_l):
            if not c:
                continue
            alone = range(c) if c <= 8 else (0, c - 1)
            outs = [(got[e, :c], dense_matmul.launch(xe[e, :c], w[e]))]
            outs += [(got[e, r:r + 1], dense_matmul.launch(xe[e, r:r + 1], w[e]))
                     for r in alone]
            for g, d in outs:
                gap = _bf16_ulps(torch, g, d)
                differ += int((gap > 0).sum())
                ulps = max(ulps, int(gap.max()))
                n_el += g.numel()
        if differ:
            raise AssertionError(f"{what}: {differ} kept-row elements are not bitwise "
                                 f"dense_matmul's (up to {ulps} ulps)")
        for key, v in (("elements", n_el), ("differ", differ)):
            dense_total[key] += v
        dense_total["max_ulps"] = max(dense_total["max_ulps"], ulps)
        # One bit pattern at every capacity: sampled rows alone at cap 8
        # (and 16).
        bm = expert_matmul.launch_plan(cap, K, N)[2]
        picks = _sampled_rows(kept_l, bm)
        caps = (8, 16) if cap == 16 else (8,) if cap > 8 else ()
        for small in caps:
            for (e, r), row in _alone(torch, expert_matmul, xe, w, picks, small).items():
                if not torch.equal(row, got[e, r]):
                    raise AssertionError(f"{what}: expert {e}'s row {r} alone at cap "
                                         f"{small} is not bitwise the row at cap {cap}")
                cross_rows += 1
        full = torch.full_like(counts, cap)
        n_kept, touched = int(kept.sum()), int((kept > 0).sum())
        b_ms, b_by = bound_ms(2 * (n_kept * K + touched * K * N + E * cap * N),
                              2 * n_kept * K * N, BF16_FLOPS_PER_S)
        sch = expert_matmul.schedule(E, cap, K, N)
        entries[name] = {
            "ms": timer(lambda: expert_matmul.launch(xe, w, counts)),
            "all_full_ms": timer(lambda: expert_matmul.launch(xe, w, full)),
            "plain_ms": timer(lambda: ref.expert_matmul_ref(xe, w, counts)),
            "library_ms": timer(lambda: torch.bmm(xe, w)), "library": "torch.bmm, whole buffer",
            "bound_ms": b_ms, "bound_by": b_by, "touched_experts": touched,
            "kept_rows": n_kept, "plan": list(expert_matmul.launch_plan(cap, K, N)),
            "schedule": sch._asdict(),
            "dense_bits": {"elements": n_el, "differ": differ, "max_ulps": ulps},
            "shape": f"E={E} cap={cap} kept rows {n_kept} in {touched} experts {K}->{N} bf16"}
        log(f"  expert_matmul {name}: schedule {sch._asdict()}, {entries[name]['ms']:.4g} "
            f"ms; dense_matmul bits: {differ} of {n_el} elements differ, up to {ulps} ulps")
        del w, xe, got, want
    # Every count 0: all zeros, no weight read.
    E, _, _, K, N = EXPERT_CASES[0][1:]
    xe = torch.full((E, 8, K), float("nan"), dtype=torch.bfloat16, device=dev)
    w = torch.randn((E, K, N), generator=gen, device=dev, dtype=torch.bfloat16)
    none = expert_matmul.launch(xe, w, torch.zeros(E, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    if none.count_nonzero():
        raise AssertionError("expert_matmul: every count 0 but the output is not all zeros")
    del xe, w, none
    log(f"expert_matmul: {len(EXPERT_CASES)} cases within atol=rtol={ATOL} of the plain "
        f"version (max |err| {worst:.3g}); rows past the count zero with NaN in their "
        f"buffer rows; every count 0 all zeros; {cross_rows} rows alone at cap 8 / 16 "
        f"bitwise their rows in the full buffers; kept rows against dense_matmul: "
        f"{dense_total['differ']} of {dense_total['elements']} elements differ, up to "
        f"{dense_total['max_ulps']} ulps")
    head = entries["llama4_decode_gate"]
    return {**head, "max_abs_err": worst, "cross_capacity_rows": cross_rows,
            "dense_bits": dense_total, "entries": entries}


# Mixtral's ring decode rows (window 4096): wrapped once mid-window, just
# full, partial, wrapped twice; timed with every row seeing 4096 keys.
MIXTRAL_RING_Q_POS = (4299, 4095, 1000, 8300)
MIXTRAL_RING_TIMED = (4299, 4600, 6000, 8300)


def check_mixtral_attention(torch, dev, timer):
    """mixtral-8x22b's attention shapes (NQ 48 / NKV 8, H 128, window
    4096): the ring decode entry at B = 4 over rings built by
    ``ring_align`` (q_pos MIXTRAL_RING_Q_POS), bf16 and int8 (codes and
    scales from ``quantize_kv``: the int8 ring no earlier path ran),
    within atol = rtol = 2e-2 of ``common.decode_attention``, each timed
    with every row seeing 4096 keys beside its plain version and SDPA
    (K/V dequantized and expanded to 48 heads, the window as a mask); the
    windowed flash kernel over the ring-wrap prompt (B = 1, T = 4200, past
    the window) within 2e-2 of ``ref.flash_attention_gqa_ref``, timed, and
    timed at the static prefill (B = 4, T = 320). Returns the timed
    entries."""
    from repro_torch.kernels import flash_attention, paged_attention, ref
    from repro_torch.models.common import decode_attention as plain
    from repro_torch.models.kv_cache import dequantize_kv, quantize_kv, ring_align

    gen = torch.Generator(device=dev).manual_seed(33)
    B, nq, nkv, H, w = 4, 48, 8, 128, 4096
    F = torch.nn.functional
    out, worst = {}, 0.0
    T = max(MIXTRAL_RING_TIMED) + 1
    k, v = (torch.randn((1, T, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    q = torch.randn((B, 1, nq, H), generator=gen, device=dev).to(torch.bfloat16)

    def ring(qpos):
        pos = torch.tensor(qpos, dtype=torch.int32, device=dev)
        kr, vr, sp = ring_align(k.expand(B, *k.shape[1:])[None],
                                v.expand(B, *v.shape[1:])[None], pos + 1, w)
        return pos, kr[0].contiguous(), vr[0].contiguous(), sp[0].contiguous()

    for kind in ("bf16", "int8"):
        for qpos in (MIXTRAL_RING_Q_POS, MIXTRAL_RING_TIMED):   # the last one is timed
            pos, kr, vr, sp = ring(qpos)
            scales = {}
            if kind == "int8":
                (kr, ks), (vr, vs) = quantize_kv(kr), quantize_kv(vr)
                scales = dict(k_scale=ks, v_scale=vs)
            got = paged_attention.launch_contig(q, kr, vr, sp, pos, window=w, **scales)
            want = plain(q, kr, vr, sp, pos, window=w, **scales)
            torch.cuda.synchronize()
            worst = max(worst, _close(torch, got, want, f"mixtral ring decode {kind} "
                                                        f"q_pos {qpos}"))
        kd, vd = ((dequantize_kv(kr, scales["k_scale"]), dequantize_kv(vr, scales["v_scale"]))
                  if scales else (kr, vr))
        mask = ((sp >= 0) & (sp <= pos[:, None]) & (sp > pos[:, None] - w))[:, None, None, :]
        ks_, vs_ = (a.to(torch.bfloat16).transpose(1, 2).repeat_interleave(nq // nkv, dim=1)
                    .contiguous() for a in (kd, vd))
        keys = int(mask.sum())
        per_key = nkv * H * (1 if scales else 2) * 2 + (nkv * 4 * 2 if scales else 0)
        nbytes = 2 * q.numel() * 2 + keys * per_key + B * w * 4 + B * 4
        b_ms, b_by = bound_ms(nbytes, 4 * nq * H * keys, BF16_FLOPS_PER_S)
        out[f"ring_mixtral_{kind}"] = {
            "ms": timer(lambda: paged_attention.launch_contig(q, kr, vr, sp, pos, window=w,
                                                              **scales)),
            "plain_ms": timer(lambda: plain(q, kr, vr, sp, pos, window=w, **scales)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), ks_, vs_, attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": worst,
            "shape": f"B={B} ring={w} window={w} keys/row=4096 NQ={nq} NKV={nkv} H={H} "
                     f"{kind}"}
    log(f"mixtral ring decode (B={B}, window {w}, NQ {nq} / NKV {nkv}, H {H}) bf16 and int8 "
        f"within atol=rtol={ATOL} of the plain version (max |err| {worst:.3g})")
    for name, Bf, Tf in (("windowed_mixtral_wrap", 1, 4200), ("mixtral_static_prefill", 4, 320)):
        qf = torch.randn((Bf, Tf, nq, H), generator=gen, device=dev).to(torch.bfloat16)
        kf, vf = (torch.randn((Bf, Tf, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kw = dict(causal=True, window=w, q_offset=0)
        got = flash_attention.launch(qf, kf, vf, **kw)
        want = ref.flash_attention_gqa_ref(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        err = _close(torch, got, want, f"mixtral windowed flash B={Bf} T={Tf}")
        del want
        i = torch.arange(Tf, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
        ks_, vs_ = (a.transpose(1, 2).repeat_interleave(nq // nkv, dim=1).contiguous()
                    for a in (kf, vf))
        pairs = int(mask.sum())
        b_ms, b_by = bound_ms(2 * qf.numel() * 2 + 2 * kf.numel() * 2,
                              4 * Bf * nq * H * pairs, BF16_FLOPS_PER_S)
        out[name] = {
            "ms": timer(lambda: flash_attention.launch(qf, kf, vf, **kw)),
            "plain_ms": timer(lambda: ref.flash_attention_gqa_ref(qf, kf, vf, **kw), iters=5),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                qf.transpose(1, 2), ks_, vs_, attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "shape": f"B*NQ={Bf * nq} NKV={nkv} T={Tf} H={H} bf16 causal window {w}"}
    log(f"mixtral windowed flash at T 4200 (B 1) and 320 (B 4) within atol=rtol={ATOL} "
        f"(max |err| {max(out['windowed_mixtral_wrap']['max_abs_err'], out['mixtral_static_prefill']['max_abs_err']):.3g})")
    return out


# (name, K, N): nemotron-4-340b's FFN, K up to 73 728 (127 x 127 x 73 728
# ~ 1.19e9 in an int32 accumulator, 55 % of its range).
NEMOTRON_340B_KN = (("nemotron-340b w_up", 18432, 73728),
                    ("nemotron-340b w_down", 73728, 18432))


# Runs (u)-(z): mixtral-8x22b, llama4-maverick-400b-a17b and nemotron-4-340b
# at full width, cut to DEPTH's layers, on the stream's first 4 requests.
# Every expert product on expert_matmul; mixtral's window on the ring
# entry (bf16 and int8) and windowed flash; llama4 on the contiguous cache
# (static) and the paged pool with solo admission; nemotron-4-340b as
# (o)/(p) at K up to 73 728, head dim 192, GQA 12.
MOE_RUNS = {
    "u-mixtral-static": (["--arch", MIXTRAL, "--static", *ARCH_STREAM], MIXED_POLICY,
                         ("flash_attention", "ring_attention", "quantize_rows",
                          "bitplane_matmul", "fused_quantize_matmul", "expert_matmul")),
    "v-mixtral-int8": (["--arch", MIXTRAL, "--continuous", "--kv-int8", *ARCH_STREAM],
                       POLICY, ("flash_attention", "ring_attention", "fused_quantize_matmul",
                                "expert_matmul")),
    "w-llama4-static": (["--arch", LLAMA4, "--static", *ARCH_STREAM], POLICY,
                        ("flash_attention", "contig_attention", "fused_quantize_matmul",
                         "expert_matmul")),
    "x-llama4-paged": (["--arch", LLAMA4, "--continuous", *ARCH_STREAM], POLICY,
                       ("flash_attention", "paged_attention", "fused_quantize_matmul",
                        "expert_matmul")),
    "y-nemotron340b-chunked": (["--arch", NEMOTRON_340B, "--continuous", *ARCH_STREAM],
                               MIXED_POLICY, ARCH_RUNS["o-nemotron-chunked"][2]),
    "z-nemotron340b-static": (["--arch", NEMOTRON_340B, "--static", *ARCH_STREAM],
                              MIXED_POLICY, ARCH_RUNS["p-nemotron-static"][2]),
}
RUNS = {**SERVE_RUNS, **ARCH_RUNS, **GRIFFIN_RUNS, **MOE_RUNS}
MOE_PLAN = ((MIXTRAL, ("u-mixtral-static", "v-mixtral-int8")),
            (LLAMA4, ("w-llama4-static", "x-llama4-paged")),
            (NEMOTRON_340B, ("y-nemotron340b-chunked", "z-nemotron340b-static")))
WRAP_T = 4200          # past mixtral's 4096-token window
WRAP_STEPS = 4
# Decode vs prefill logits (float32 from bf16 hidden rows, |logit| up to
# ~16). The bf16 ring runs one order with the flash prefill: its logits
# and its whole ring are gated bitwise. On the int8 ring the decode kernel
# applies the per-key scale to the scores and the per-value scale to the
# probabilities, where the prefill's flash reads the dequantized K/V (the
# JAX package's two paths, the same split): 0.072-0.125 apart in the
# logits on the H100, a sanity bound only. What holds the int8 ring is its
# state (``ring_state_diff``): slot positions at every layer, layer 0
# whole (codes and scales) and every slot no decode step wrote at every
# layer bitwise prefill's ring over the same tokens.
WRAP_TOL = {"bf16": 0.0, "int8": 0.25}


def ring_state_diff(torch, got, want, written):
    """The parts of ring cache `got` (a KVCache after decode steps that
    wrote absolute positions `written`) not bitwise `want` (prefill's ring
    over the same tokens): slot_pos at every layer; each of k, v (and
    k_scale, v_scale on an int8 ring) at layer 0 and at every slot no
    decode step wrote. Returns (those parts' names, the largest |got -
    want| of k and v in the decode-written slots past layer 0: codes on an
    int8 ring)."""
    W = got.slot_pos.shape[-1]
    dec = torch.zeros(W, dtype=torch.bool, device=got.k.device)
    dec[[p % W for p in written]] = True
    bad = [] if torch.equal(got.slot_pos, want.slot_pos) else ["slot_pos"]
    gap = 0.0
    for name in ("k", "v", "k_scale", "v_scale") if got.quantized else ("k", "v"):
        a, b = getattr(got, name), getattr(want, name)          # (L, B, W, NKV, .)
        if not torch.equal(a[0], b[0]):
            bad.append(f"{name} layer 0")
        if not torch.equal(a[1:, :, ~dec], b[1:, :, ~dec]):
            bad.append(f"{name} unwritten slots")
        if name in ("k", "v"):
            gap = max(gap, (a[1:, :, dec].float() - b[1:, :, dec].float()).abs().max().item())
    return bad, gap


def _one_slot_on(torch, kv, pos):
    """A copy of ring cache `kv` whose write of position `pos` also landed
    one slot on (every layer): the planted fault ``ring_state_diff`` must
    see."""
    W = kv.slot_pos.shape[-1]
    s, t = pos % W, (pos + 1) % W
    moved = {}
    for name in ("k", "v", "slot_pos", "k_scale", "v_scale"):
        a = getattr(kv, name)
        if a is not None:
            a = a.clone()
            a[:, :, t] = a[:, :, s]
            moved[name] = a
    return dataclasses.replace(kv, **moved)


def mixtral_ring_wrap(torch, params, quant):
    """A WRAP_T-token prompt on (u)'s weights at capacity factor 16 (no
    token drops, so a token's MoE output does not depend on its batch),
    then WRAP_STEPS decode steps on the ring (bf16, or int8 with `quant`):
    each step's logits against the last-position logits of ``prefill``
    over the same WRAP_T + 1 + i tokens, and its ring against that
    prefill's ring (``ring_state_diff``). A planted control, the last
    write moved one slot on (``_one_slot_on``), must fail the ring gate.
    Returns {"logits": max |err| by step, "ring_parts": the parts that
    differ by step, "written_gap": the largest decode-written gap past
    layer 0 by step, "control_parts": what the control's gate saw}."""
    import numpy as np

    from repro_torch.models import build_model

    cfg = dataclasses.replace(serve_config(MIXTRAL), moe_capacity_factor=16.0,
                              kv_cache_quant=quant)
    model = build_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(32).integers(
        0, cfg.vocab, WRAP_T + WRAP_STEPS)).cuda()[None]
    cache, _ = model.prefill(params, {"tokens": toks[:, :WRAP_T]})
    out = {"logits": [], "ring_parts": [], "written_gap": []}
    for i in range(WRAP_STEPS):
        cache, lg = model.decode_step(params, cache, toks[:, WRAP_T + i:WRAP_T + i + 1])
        ref, want = model.prefill(params, {"tokens": toks[:, :WRAP_T + i + 1]})
        written = range(WRAP_T, WRAP_T + i + 1)
        parts, gap = ring_state_diff(torch, cache.kv, ref.kv, written)
        out["logits"].append((lg - want).abs().max().item())
        out["ring_parts"].append(parts)
        out["written_gap"].append(gap)
    out["control_parts"], _ = ring_state_diff(
        torch, _one_slot_on(torch, cache.kv, written[-1]), ref.kv, written)
    torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def _swapped(module, name, fn):
    """``module.<name>`` replaced by `fn` inside the block; yields the
    original."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield old
    finally:
        setattr(module, name, old)


MOE_LAYER_SHAPES = ((4, 320), (4, 1))   # the static prefill, a decode step


def moe_layer_vs_plain(torch, params, cfg):
    """Layer 0's MoE of a full-width bf16 tree through ``moe.moe_apply``
    on the card (routing, buffer, every expert product on the
    ``expert_matmul`` kernel, activation, combine) against the same call
    with ``ops.expert_matmul`` swapped for its plain version
    (``ref.expert_matmul_ref``), at MOE_LAYER_SHAPES with unit-scale bf16
    tokens: out within atol = rtol = 2e-2, the aux loss and the keep mask
    bitwise, the kernel launched once a product in the first call and
    never in the second. Returns the max |err| by shape."""
    from repro_torch.kernels import expert_matmul, ops, ref
    from repro_torch.models import moe

    moe_p = params["blocks"]["moe"]
    layer = {k: v[0] if isinstance(v, torch.Tensor) else {n: t[0] for n, t in v.items()}
             for k, v in moe_p.items()}
    products = len(layer[moe.expert_group(cfg)])
    gen = torch.Generator(device="cuda").manual_seed(34)
    errs = {}
    for B, T in MOE_LAYER_SHAPES:
        x = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        keep = moe.route(x.reshape(B * T, -1), layer["router"], cfg).keep
        n0 = expert_matmul.launches
        got, aux = moe.moe_apply(layer, x, cfg)
        n1 = expert_matmul.launches
        with _swapped(ops, "expert_matmul",
                      lambda xe, w, counts, backend=None: ref.expert_matmul_ref(xe, w, counts)):
            want, aux_plain = moe.moe_apply(layer, x, cfg)
            keep_plain = moe.route(x.reshape(B * T, -1), layer["router"], cfg).keep
        torch.cuda.synchronize()
        what = f"{cfg.name} moe_apply B={B} T={T}"
        errs[f"B={B} T={T}"] = _close(torch, got, want, what)
        if not (torch.equal(aux, aux_plain) and torch.equal(keep, keep_plain)):
            raise AssertionError(f"{what}: aux loss or keep mask differ from the plain call")
        if (n1 - n0, expert_matmul.launches - n1) != (products, 0):
            raise AssertionError(f"{what}: kernel launches {n1 - n0} (want {products}), "
                                 f"then {expert_matmul.launches - n1} in the plain call")
    return errs


def _static_logits_repeat(torch, eng, prompts):
    """The first-token logits of the stream's static batch of 4 prefilled
    twice: bitwise equal? Also how far each row's solo logits lie (MoE
    routing is capacity-bounded over the batch: printed, not gated)."""
    solo, a = batch_and_solo_logits(torch, eng, prompts)
    _, b = batch_and_solo_logits(torch, eng, prompts)
    return torch.equal(a, b), (a - solo).abs().max().item()


def serve_moe_archs(torch, dev):
    """Runs (u)-(z) of MOE_RUNS and their gates, one arch at a time: the
    raw bf16 weights (seed 0) are drawn, the untied head's rows gated at M
    = 1-9 (``head_rows``), the tree packed under each run's policy (the
    expert leaves and the router stay bf16 / float32 and are shared by
    the packed trees) and the raw tree dropped; both runs serve; every
    tensor and engine is dropped before the next arch.

    Gated (besides ``serve_run``'s checks): (u) and (w), static, give the
    same first-token logits bitwise when their batch is prefilled twice
    (their repeated pass already gives the same greedy tokens); their
    bf16 MoE layer on the kernel within 2e-2 of the plain version
    (``moe_layer_vs_plain``); mixtral's ring wrap (``mixtral_ring_wrap``):
    logits within WRAP_TOL, the ring bitwise where ``ring_state_diff``
    says, and its planted control caught, on the bf16 and the int8 ring;
    (z) static emits (y) chunked's greedy tokens, and chunked
    and whole-prompt first-token logits are bitwise equal. Prints the
    parameter count, init and pack seconds, peak and resident GB, each
    run's time, peak and launches, and the phase's seconds. Returns
    (report, launch counts summed over the six runs)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    out, counts, bad = {}, {}, []
    smi = nvidia_smi()
    for arch, names in MOE_PLAN:
        rep = out[arch] = {}

        def untied_head(raw):
            parted = rep["head_parted"] = head_rows(torch, raw["head"])
            log(f"{arch}: untied head {tuple(raw['head'].shape)} rows at M in {HEAD_M} not "
                f"bitwise M = 4: torch.matmul {parted['torch.matmul'] or 'none'} (gated), "
                f"dense_matmul {parted['dense_matmul'] or 'none'}")
            if parted["torch.matmul"]:
                bad.append(f"{arch}: head rows part across M {parted['torch.matmul']}")

        raw = _draw(torch, dev, serve_config(arch), rep, untied_head)
        trees, rep["pack"] = {}, {}
        for name in names:
            policy = MOE_RUNS[name][1]
            if policy not in trees:
                trees[policy] = _pack(torch, raw, policy, rep["pack"].setdefault(policy, {}))
        del raw
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rep["resident_gb"] = torch.cuda.memory_allocated() / 1e9
        log(f"{arch}: {rep['parameters']} parameters, init {rep['init_s']:.2f}s (peak "
            f"{rep['init_peak_gb']:.2f} GB), packed under "
            + ", ".join(f"{p} in {r['pack_s']:.2f}s (peak {r['pack_peak_gb']:.2f} GB)"
                        for p, r in rep["pack"].items())
            + f", {rep['resident_gb']:.2f} GB resident [{smi}]")
        runs = {}
        for name in names:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runs[name] = serve_run(torch, trees[MOE_RUNS[name][1]], name)
            run_s, peak = time.perf_counter() - t0, _mem_gb(torch)
            rep[name] = {**runs[name][1], "run_seconds": run_s, "peak_gb": peak}
            for k, n in runs[name][2].items():
                counts[k] = counts.get(k, 0) + n
            log(f"  [{name}] {run_s:.1f}s, peak memory {peak:.2f} GB "
                "(torch.cuda.max_memory_allocated)")
        reqs = mixed_requests(get_config(arch), serve.build_parser().parse_args(
            serve_argv(names[0])))
        prompts = [r.prompt for r in reqs]
        t0 = time.perf_counter()
        if arch in (MIXTRAL, LLAMA4):
            static = names[0]
            same, solo_gap = _static_logits_repeat(torch, runs[static][0], prompts)
            rep.update(static_logits_repeat_bitwise=same, batch_vs_solo_logits=solo_gap)
            log(f"{arch}: ({static[0]}) static batch's first-token logits prefilled twice "
                f"bitwise equal: {same} (gated); batch vs solo max |err| {solo_gap:.3g} "
                "(capacity-bounded routing: not gated)")
            if not same:
                bad.append(f"{arch}: static first-token logits differ between two prefills")
        if arch in (MIXTRAL, LLAMA4):
            layer_err = rep["moe_layer_vs_plain"] = moe_layer_vs_plain(
                torch, trees[MOE_RUNS[names[0]][1]], serve_config(arch))
            log(f"{arch}: full-width bf16 MoE layer through moe_apply, kernel vs plain "
                f"version, max |err| {layer_err} (gated at atol=rtol={ATOL}; aux and keep "
                "mask bitwise)")
        if arch == MIXTRAL:
            wrap = {kind: mixtral_ring_wrap(torch, trees[MIXED_POLICY], kind == "int8")
                    for kind in ("bf16", "int8")}
            rep["ring_wrap"] = wrap
            for kind, w in wrap.items():
                log(f"{arch}: {kind} ring wrap, a {WRAP_T}-token prompt then {WRAP_STEPS} "
                    f"decode steps at capacity factor 16 vs prefill over the same tokens: "
                    f"logits max |err| by step {w['logits']} (gated at {WRAP_TOL[kind]}); "
                    f"ring parts not bitwise by step {w['ring_parts']} (gated empty); "
                    f"decode-written slots past layer 0 max |diff| by step "
                    f"{w['written_gap']} (gated at 0 on bf16); planted one-slot-on write: "
                    f"{w['control_parts']} (gated non-empty)")
                if (any(e > WRAP_TOL[kind] for e in w["logits"]) or any(w["ring_parts"])
                        or (kind == "bf16" and any(w["written_gap"]))
                        or not w["control_parts"]):
                    bad.append(f"{arch}: {kind} ring wrap {w}")
        if arch == NEMOTRON_340B:
            greedy = [r.rid for r in reqs if r.temperature == 0]
            share = _greedy_share(runs["z-nemotron340b-static"][3],
                                  runs["y-nemotron340b-chunked"][3], greedy)
            eng = runs["y-nemotron340b-chunked"][0]
            solo, chunk, _ = first_token_logits(torch, eng.model, eng.params, prompts)
            err_chunk = (chunk - solo).abs().max().item()
            rep.update(static_vs_continuous=share, logits_err_chunked_vs_whole=err_chunk)
            log(f"{arch}: greedy (z) static vs (y) chunked {share} (gated at all); "
                f"first-token logits chunked vs whole-prompt max |err| {err_chunk:.3g} "
                "(gated at 0)")
            if share != f"{len(greedy)}/{len(greedy)}" or err_chunk != 0.0:
                bad.append(f"{arch}: (z) vs (y) {share}, chunked vs whole {err_chunk}")
        rep["gates_s"] = time.perf_counter() - t0
        del runs, trees
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"MoE phase (runs (u)-(z) and their gates): {out['phase_s']:.1f}s [{smi}]")
    if bad:
        raise AssertionError(f"MoE archs: {bad}")
    return out, counts


def card_vs_cpu_moe(torch):
    """The reduced float32 mixtral-8x22b and llama4-maverick on the card
    vs on the CPU, from the same weights (the port's init, seed 0, moved
    to the card): ``moe_apply`` over 64 tokens at capacity factors 1.25
    and 1.0 (llama4 drops there): out within 1e-4 and the keep mask
    bitwise; a whole-prompt prefill of two right-padded prompts (40 and 23
    tokens, past mixtral's 16-token window) and four decode steps: logits
    within 1e-3 (float32 sums in other orders). Returns the max |err| of
    each."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model, moe

    errs = {}
    for arch in (MIXTRAL, LLAMA4):
        cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        model = build_model(cfg)
        params = model.init(seed=0, device="cpu")
        layer = {k: v[0] if isinstance(v, torch.Tensor) else {n: t[0] for n, t in v.items()}
                 for k, v in params["blocks"]["moe"].items()}
        x = torch.randn((1, 64, cfg.d_model), generator=torch.Generator().manual_seed(3))
        moe_err = 0.0
        for factor in (1.25, 1.0):
            c = dataclasses.replace(cfg, moe_capacity_factor=factor)
            res = {}
            for dev in ("cpu", "cuda"):
                lp, xd = _to(layer, dev), x.to(dev)
                o, _ = moe.moe_apply(lp, xd, c)
                keep = moe.route(xd[0], lp["router"], c).keep
                res[dev] = (o.cpu(), keep.cpu())
            if not torch.equal(res["cpu"][1], res["cuda"][1]):
                raise AssertionError(f"{arch} moe_apply factor {factor}: keep masks differ "
                                     "between the card and the CPU")
            moe_err = max(moe_err, (res["cpu"][0] - res["cuda"][0]).abs().max().item())
        out = {}
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            toks = (torch.arange(2 * 40, device=dev).reshape(2, 40) * 11) % cfg.vocab
            cache, lg = model.prefill(p, {"tokens": toks, "lengths": torch.tensor([40, 23])})
            lgs = [lg]
            for t in range(4):
                cache, lg = model.decode_step(p, cache, torch.tensor([[3 + t], [5 + t]],
                                                                     device=dev))
                lgs.append(lg)
            out[dev] = torch.cat([lg.reshape(1, -1) for lg in lgs], dim=1).cpu()
        err = (out["cpu"] - out["cuda"]).abs().max().item()
        if not (moe_err <= 1e-4 and err <= 1e-3):
            raise AssertionError(f"reduced fp32 {arch}: card vs CPU moe_apply {moe_err}, "
                                 f"logits {err}")
        errs[arch] = {"moe_apply": moe_err, "logits": err}
    return errs


def moe_kernel_checks(torch, dev, timer):
    """The slice's kernel checks beside ``expert_matmul``'s (a phase of its
    own): mixtral's attention shapes, and the fused kernel and Table III
    leaf at nemotron-4-340b's FFN widths (``check_new_widths`` over
    NEMOTRON_340B_KN, timed at w_up, M = 4). Returns {"attention":
    entries, "fused_340b": check_new_widths' report}."""
    return {"attention": check_mixtral_attention(torch, dev, timer),
            "fused_340b": check_new_widths(torch, dev, timer, NEMOTRON_340B_KN)}


def check_registry(torch, dev, params, ref_tokens):
    """The kernel registry on the card.

    (a) ``autotune`` on a fresh registry at (o)'s decode shape of the
    fused kernel (nemotron-4-15b's `wo`, M = 4, 6144 -> 6144, w8a8, bf16
    rows), at both groups of a Table III leaf (nemotron's w_up at M = 4,
    w4a6r25: ``bitplane_matmul``'s dequant entry at n8 and at the 4-bit
    columns) and at rwkv6-3b's two decode shapes of ``dense_matmul``:
    every candidate, the winner included, gives bitwise the heuristic
    plan's output (the int32 forms, and the dequantized one in float32).
    (b) ``save_plans``, then ``load_plans`` into a fresh registry: the
    same plans. (c) The serve CLI twice with --plans on chunked-int8's
    flags, the process registry emptied before each: the first saves N >=
    1 plans, the second loads N, plans nothing anew, and both emit
    `ref_tokens` (chunked-int8's run). (d) --backend reference on the card
    exits with its message. Raises after printing if any part fails."""
    import io
    import tempfile

    from repro_torch.core.bitplane import pack_weights
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.quantized_linear import pack_weight
    from repro_torch.kernels import bitplane_matmul, dense_matmul, fused_matmul, pack_quant
    from repro_torch.kernels.registry import KernelRegistry, get_registry, heuristic
    from repro_torch.launch import serve

    gen = torch.Generator(device=dev).manual_seed(15)
    reg, bad, tuned = KernelRegistry(), [], {}

    def tune(what, op, mod, shape, run, forms):
        """Autotune `op` at `shape` with `run(blocks)`; then each candidate's
        `forms(blocks)` outputs against the heuristic's."""
        win = reg.autotune(op, shape, run, backend="cuda")
        heur = heuristic(op, shape)
        want = [t.clone() for t in forms(heur)]
        cands = list(dict.fromkeys([heur, win, *mod.candidates(*shape)]))
        parted = [c for c in cands if not all(torch.equal(a, b)
                                              for a, b in zip(forms(c), want))]
        torch.cuda.synchronize()
        tuned[what] = {"op": op, "shape": shape, "heuristic": heur, "winner": win,
                       "candidates": len(cands), "parted": parted}
        log(f"registry: autotune {what} {op} {shape}: {len(cands)} candidates, heuristic "
            f"{heur}, winner {win}; outputs not bitwise the heuristic's: {parted or 'none'}")
        if parted:
            bad.append(f"{what}: {parted}")

    # (o)'s decode shape of the fused kernel: nemotron's wo at w8a8.
    K = N = 6144
    w8 = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    ws = torch.rand((1, N), generator=gen, device=dev) * 1e-3
    xb = torch.randn((4, K), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(w_bits=8, a_bits=8, act_signed=True, w_plane_lo=0)
    yb = torch.empty((4, N), dtype=torch.bfloat16, device=dev)
    yf = torch.empty((4, N), dtype=torch.float32, device=dev)

    def fused_forms(b):
        acc, scales = fused_matmul.launch(xb, w8, plan=b, **kw)
        fused_matmul.launch_dequant(xb, w8, ws, yf, plan=b, **kw)
        return [acc, scales, yf]

    tune("(o) wo decode", "fused_matmul", fused_matmul, (4, K, N),
         lambda b: fused_matmul.launch_dequant(xb, w8, ws, yb, plan=b, **kw), fused_forms)
    # A Table III leaf: nemotron's w_up at decode, both filter groups.
    K, N = 6144, 24576
    pw = pack_weight(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5,
                     QuantConfig(w_bits=4, a_bits=6, mixed_ratio_8b=0.25))
    xq, xs = pack_quant.launch(torch.randn((4, K), generator=gen, device=dev)
                               .to(torch.bfloat16), bits=6, signed=True)
    for group, p, sc, wb in (("8-bit", pw.packed8, pw.scale[:, :pw.n8], 8),
                             ("4-bit", pw.packed, pw.scale[:, pw.n8:], 4)):
        n = p.shape[1]
        ob = torch.empty((4, n), dtype=torch.bfloat16, device=dev)
        of = torch.empty((4, n), dtype=torch.float32, device=dev)
        ikw = dict(w_bits=wb, a_bits=6, act_signed=True, w_plane_lo=0)

        def leaf_forms(b):
            acc = bitplane_matmul.launch(xq, p, plan=b, **ikw)
            bitplane_matmul.launch_dequant(xq, p, xs, sc, of, w_bits=wb, a_bits=6, plan=b)
            return [acc, of]

        tune(f"Table III w_up {group} group", "bitplane_matmul", bitplane_matmul, (4, K, n),
             lambda b: bitplane_matmul.launch_dequant(xq, p, xs, sc, ob, w_bits=wb, a_bits=6,
                                                      plan=b), leaf_forms)
    del pw
    # dense_matmul's tilings at rwkv6-3b's decode shapes (S never offered).
    for K, N in ((2560, 8960), (8960, 2560)):
        w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((4, K), generator=gen, device=dev).to(torch.bfloat16)
        tune(f"rwkv6 {K}->{N} decode", "dense_matmul", dense_matmul, (4, K, N),
             lambda b: dense_matmul.launch(x, w, plan=b),
             lambda b: [dense_matmul.launch(x, w, plan=b)])

    tmp = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    path = os.path.join(tmp, "plans.json")
    n = reg.save_plans(path)
    fresh = KernelRegistry()
    loaded = fresh.load_plans(path)
    same = all(fresh.plan(t["op"], t["shape"], "cuda") == t["winner"] for t in tuned.values())
    log(f"registry: save_plans wrote {n} plans, a fresh registry loaded {loaded}, the same "
        f"plans: {same and loaded == n}")
    if not (same and loaded == n == len(tuned)):
        bad.append(f"save/load: {n} saved, {loaded} loaded, same {same}")

    g = get_registry()
    cli_path = os.path.join(tmp, "serve_plans.json")
    argv = serve_argv("chunked-int8") + ["--plans", cli_path]
    cli = []
    for _ in range(2):
        g.clear_plans()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, done, _ = serve.run(serve.build_parser().parse_args(argv), mixed_requests,
                                   params=params)
        text = buf.getvalue()
        got = [int(m) if m else None for m in (
            (re.search(r"loaded (\d+) block plans", text) or [None, None])[1],
            (re.search(r"saved (\d+) block plans", text) or [None, None])[1])]
        cli.append({"loaded": got[0], "saved": got[1], **g.cache_info(),
                    "tokens_equal": {r.rid: r.out_tokens for r in done} == ref_tokens})
    g.clear_plans()
    log(f"registry: serve --plans on chunked-int8's flags: {cli}")
    first, second = cli
    if not (first["loaded"] is None and first["saved"] and first["saved"] >= 1
            and second["loaded"] == first["saved"] == second["saved"]
            and second["misses"] == 0 and first["tokens_equal"] and second["tokens_equal"]):
        bad.append(f"serve --plans: {cli}")
    try:
        serve.main(serve_argv("chunked-int8") + ["--backend", "reference"])
        refused = None
    except SystemExit as e:
        refused = e.code
    log(f"registry: serve --backend reference on the card: exits with {refused!r}")
    if not (isinstance(refused, str) and "--backend reference runs on cpu" in refused):
        bad.append(f"--backend reference on the card: {refused!r}")
    if bad:
        raise AssertionError(f"registry: {bad}")
    return {"autotune": tuned, "saved": n, "loaded": loaded, "serve_plans": cli,
            "backend_reference_refused": refused}


@contextlib.contextmanager
def table3_codes(torch, replay=None):
    """Within the block each Table III leaf (``ops.mixed_group_matmul``)
    records, in call order, its rows x and the activation codes and scales
    they quantize to on their device (yields that list). With `replay`
    (such a list, from the card), a CPU run's leaves take the recorded
    codes and scales in order in place of their own; the block's end
    checks that every one was taken."""
    from repro_torch.kernels import ops

    rec = []
    if replay is None:
        mixed, quant = ops.mixed_group_matmul, ops.quantize_rows

        def leaf(x, *args, a_bits=8, **kw):
            xq, xs = quant(x, bits=a_bits, signed=True)
            rec.append((x.float().cpu(), xq.cpu(), xs.cpu(), a_bits))
            return mixed(x, *args, a_bits=a_bits, **kw)

        with _swapped(ops, "mixed_group_matmul", leaf):
            yield rec
        return
    taken = iter(replay)

    def recorded(x, *, bits=8, signed=True, backend=None):
        _, xq, xs, _ = next(taken)
        if xq.shape != x.shape:
            raise AssertionError(f"replay: a leaf of {tuple(x.shape)} takes codes of "
                                 f"{tuple(xq.shape)}")
        return xq, xs

    with _swapped(ops, "quantize_rows", recorded):
        yield rec
    if next(taken, None) is not None:
        raise AssertionError("replay: the CPU run took fewer leaves than the card's")


def first_flip(torch, cpu, card):
    """Where two runs' Table III leaf records (``table3_codes``) first
    part: None when every code agrees, else that leaf call's index, the
    codes apart there and their largest gap, whether the card's codes
    there are bitwise the plain quantizer's on the card's own rows, the
    largest gap between the devices' x / scale over the leaf (in codes)
    and the flipped codes' largest distance from a half code on the CPU.
    Raises if the two runs made different calls."""
    from repro_torch.kernels import ref

    if [c[1].shape for c in cpu] != [c[1].shape for c in card]:
        raise AssertionError("Table III leaves: the CPU and the card made different calls")
    for i, ((x, q, s, bits), (x2, q2, s2, _)) in enumerate(zip(cpu, card)):
        apart = q != q2
        if not apart.any():
            continue
        t, t2 = (a * torch.where(b > 0, 1.0 / b, torch.zeros_like(b)) for a, b in ((x, s),
                                                                                (x2, s2)))
        ta = t[apart].abs()
        return {"leaf_call": i, "codes_apart": int(apart.sum()),
                "max_gap": (q.int() - q2.int())[apart].abs().max().item(),
                "card_codes_plain": torch.equal(ref.quantize_rows_ref(x2, bits)[0], q2),
                "leaf_gap": (t - t2).abs().max().item(),
                "max_from_half": (ta - ta.floor() - 0.5).abs().max().item()}
    return None


def card_vs_cpu(torch, arch="olmo-1b"):
    """Reduced `arch` (olmo-1b, nemotron-4-15b, stablelm-12b,
    nemotron-4-340b) in float32 under both serve policies: one prefill
    chunk and two paged decode steps, and a whole-prompt prefill of two
    right-padded prompts and two contiguous decode steps, on the card
    (kernels) vs on the CPU (plain versions): logits within 1e-2. A
    float32 sum in another order may put an activation of a Table III leaf
    on the other side of a rounding boundary, one code apart, and the flip
    cascades through later layers (reduced nemotron-4-340b's a6 leaves,
    rows up to |x| 21: 0.078 in the logits). Past 1e-2 the pair passes
    only if that is all it is: every leaf's codes equal before the first
    that parts (``first_flip``); there the card's codes bitwise the plain
    quantizer's on the card's rows and every code apart by one; and the
    CPU run replaying the card's codes and scales
    (``table3_codes``) within 1e-2 of the card. Returns the worst direct
    max |err| and, for each pair that flipped, its report."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.precision import parse_policy_spec
    from repro_torch.core.quantized_linear import quantize_params_for_serving
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    model = build_model(cfg)

    def logits(p, dev):
        cache = model.init_paged_cache(2, 9, 4, 4, device=dev)
        cache.kv.block_table.copy_(torch.tensor([[1, 2, 3, 4], [5, 6, -1, -1]]))
        toks = torch.arange(10, device=dev)[None] * 7 % cfg.vocab
        cache, lg0 = model.prefill_chunk(p, cache, {
            "tokens": toks, "lengths": [10], "start": 0, "slot": 0,
            "blocks": torch.tensor([1, 2, 3])})
        cache.pos[1] = 0
        lgs = [lg0]
        cur = torch.tensor([[3], [5]], device=dev)
        for _ in range(2):
            cache, lg = model.decode_step(p, cache, cur)
            lgs.append(lg[:1])
            cur = lg[:, -1].argmax(-1, keepdim=True)
        toks = (torch.arange(2 * 24, device=dev).reshape(2, 24) * 11) % cfg.vocab
        cache, lg = model.prefill(p, {"tokens": toks, "lengths": torch.tensor([24, 13])})
        lgs.append(lg)
        cur = lg[:, -1].argmax(-1, keepdim=True)
        for _ in range(2):
            cache, lg = model.decode_step(p, cache, cur)
            lgs.append(lg)
            cur = lg[:, -1].argmax(-1, keepdim=True)
        return torch.cat([lg.reshape(1, -1) for lg in lgs], dim=1).cpu()

    worst, flips = 0.0, {}
    for policy in (POLICY, MIXED_POLICY):
        params = quantize_params_for_serving(model.init(seed=0, device="cpu"),
                                             parse_policy_spec(policy), min_size=1024)
        out, codes = {}, {}
        for dev in ("cpu", "cuda"):
            with table3_codes(torch) as codes[dev]:
                out[dev] = logits(_to(params, dev), dev)
        err = (out["cpu"] - out["cuda"]).abs().max().item()
        worst = max(worst, err)
        if err <= 1e-2:
            continue
        flip = first_flip(torch, codes["cpu"], codes["cuda"])
        with table3_codes(torch, replay=codes["cuda"]):
            replayed = logits(params, "cpu")
        rep = flips[policy] = {
            "logits_err": err, "replayed_err": (replayed - out["cuda"]).abs().max().item(),
            "first_flip": flip}
        log(f"reduced fp32 {arch} ({policy}): card vs CPU logits {err:.3g} past 1e-2; "
            f"the first Table III leaf whose codes part: {flip} (gated: the card's codes "
            "the plain quantizer's, one apart); the CPU on the card's codes and scales "
            f"{rep['replayed_err']:.3g} from the card (gated at 1e-2)")
        if (flip is None or not flip["card_codes_plain"] or flip["max_gap"] > 1
                or not rep["replayed_err"] <= 1e-2):
            raise AssertionError(f"reduced fp32 {arch} ({policy}): card vs CPU logits "
                                 f"differ by {err}, not explained by code flips: {rep}")
    return worst, flips


def card_vs_cpu_rwkv6(torch):
    """Reduced rwkv6-3b in float32: a whole-prompt prefill of two
    right-padded prompts and three decode steps on the card (the wkv6
    kernel, chunked and at T = 1) vs on the CPU (its plain versions):
    logits within 1e-3 (float32 products in other orders)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_reduced_config("rwkv6-3b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        toks = (torch.arange(2 * 80, device=dev).reshape(2, 80) * 11) % cfg.vocab
        cache, lg = model.prefill(p, {"tokens": toks, "lengths": torch.tensor([80, 45])})
        lgs = [lg]
        for t in range(3):
            cache, lg = model.decode_step(p, cache, torch.tensor([[3 + t], [5 + t]],
                                                                 device=dev))
            lgs.append(lg)
        out[dev] = torch.cat([lg.reshape(1, -1) for lg in lgs], dim=1).cpu()
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"reduced fp32 rwkv6: card vs CPU logits differ by {err}")
    return err


# -- recurrentgemma-9b (Griffin): its kernels and runs (s), (t) --------------

GRIFFIN = "recurrentgemma-9b"
# Full-width ring decode rows: wrapped once mid-window, just full, not yet
# full, wrapped twice.
RING_Q_POS = (2299, 2047, 500, 4100)
RING_TIMED_POS = (2299, 2540, 3071, 4100)     # every row sees 2048 keys


def check_ring_decode(torch, dev, timer):
    """paged_attention's ring entry (``launch_contig(window=...)``) against
    its plain version ``common.decode_attention`` on rings built by
    ``ring_align``: recurrentgemma-9b's decode (B = 4, ring and window 2048,
    q_pos RING_Q_POS: wrapped once, full, partial, wrapped twice; NQ 16 /
    NKV 1 / H 256, bf16) within atol = rtol = 2e-2, and the reduced shape
    (ring 16, NQ 4 / NKV 1 / H 16; q_pos 40, 15, 3, 0) in bf16 and, within
    1e-4, float32. One order: with NaN in every empty ring slot, each row
    is bitwise the windowed flash kernel's row at its position over the
    whole sequence (bf16 and float32). Times the full-width entry with
    every row seeing 2048 keys, its plain version and SDPA (K/V expanded
    to the 16 query heads, the window as a mask)."""
    from repro_torch.kernels import flash_attention, paged_attention
    from repro_torch.models.common import decode_attention as plain
    from repro_torch.models.kv_cache import ring_align

    gen = torch.Generator(device=dev).manual_seed(25)
    worst, orders = 0.0, []

    def ring(k, v, pos, w):
        B = pos.shape[0]
        kr, vr, sp = ring_align(k.expand(B, *k.shape[1:])[None],
                                v.expand(B, *v.shape[1:])[None], pos + 1, w)
        return kr[0].contiguous(), vr[0].contiguous(), sp[0].contiguous()

    cases = [(16, 1, 256, 2048, RING_Q_POS, torch.bfloat16),
             (4, 1, 16, 16, (40, 15, 3, 0), torch.bfloat16),
             (4, 1, 16, 16, (40, 15, 3, 0), torch.float32)]
    for nq, nkv, H, w, qpos, dt in cases:
        T = max(qpos) + 1
        what = f"ring decode NQ={nq} NKV={nkv} H={H} window={w} {dt}"
        qa = torch.randn((1, T, nq, H), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((1, T, nkv, H), generator=gen, device=dev).to(dt)
                for _ in range(2))
        pos = torch.tensor(qpos, dtype=torch.int32, device=dev)
        q = qa[0, pos.long()][:, None].contiguous()
        kr, vr, sp = ring(k, v, pos, w)
        got = paged_attention.launch_contig(q, kr, vr, sp, pos, window=w)
        want = plain(q, kr, vr, sp, pos, window=w)
        torch.cuda.synchronize()
        worst = max(worst, _close(torch, got, want, what,
                                  ATOL if dt == torch.bfloat16 else F32_TOL))
        whole = flash_attention.launch(qa, k, v, causal=True, window=w, q_offset=0)
        empty = (sp < 0)[..., None, None]
        nan = torch.tensor(float("nan"), dtype=dt, device=dev)
        dec = paged_attention.launch_contig(q, torch.where(empty, nan, kr),
                                            torch.where(empty, nan, vr), sp, pos, window=w)
        torch.cuda.synchronize()
        if not torch.equal(dec[:, 0], whole[0, pos.long()]):
            err = (dec[:, 0].float() - whole[0, pos.long()].float()).abs().max().item()
            raise AssertionError(f"{what}: not bitwise windowed flash's rows (max |err| "
                                 f"{err})")
        orders.append(f"H={H} window={w} {str(dt).split('.')[-1]}")
    log(f"ring decode: full width (q_pos {RING_Q_POS}) and reduced within atol=rtol="
        f"{ATOL} (bf16) / {F32_TOL} (f32) of the plain version (max |err| {worst:.3g}); "
        f"bitwise windowed flash's rows with NaN in every empty slot: {orders}")

    B, nq, nkv, H, w = 4, 16, 1, 256, 2048
    T = max(RING_TIMED_POS) + 1
    k, v = (torch.randn((1, T, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.tensor(RING_TIMED_POS, dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, nq, H), generator=gen, device=dev).to(torch.bfloat16)
    kr, vr, sp = ring(k, v, pos, w)
    ms = timer(lambda: paged_attention.launch_contig(q, kr, vr, sp, pos, window=w))
    plain_ms = timer(lambda: plain(q, kr, vr, sp, pos, window=w))
    mask = ((sp >= 0) & (sp <= pos[:, None]) & (sp > pos[:, None] - w))[:, None, None, :]
    qs = q.transpose(1, 2)
    ks, vs = (a.transpose(1, 2).expand(B, nq, w, H).contiguous() for a in (kr, vr))
    F = torch.nn.functional
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    keys = int(mask.sum())
    nbytes = 2 * q.numel() * 2 + keys * nkv * H * 2 * 2 + B * w * 4 + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * nq * H * keys, BF16_FLOPS_PER_S)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst,
            "shape": f"B={B} ring={w} window={w} keys/row=2048 NQ={nq} NKV={nkv} H={H} bf16"}


def check_windowed_flash(torch, dev, timer):
    """The flash kernel at recurrentgemma-9b's prefill: B = 4, T = 320 and
    T = 2304 (past the window), NQ 16 / NKV 1 / H 256, bf16, window 2048,
    within atol = rtol = 2e-2 of ``ref.flash_attention_gqa_ref``. Key tiles
    wholly outside the window of every row of a query block are never
    loaded (the JAX kernel's ``visible`` test): 64 queries at q_offset 2240
    over 2304 keys give finite output, bitwise the same, when keys 0-191
    (6 tiles before the first row's window) are NaN. Times T = 2304, its
    plain version and SDPA (K/V expanded to 16 heads, the window as a
    mask)."""
    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device=dev).manual_seed(26)
    B, nq, nkv, H, w = 4, 16, 1, 256, 2048
    worst = 0.0
    data = {}
    for T in (320, 2304):
        q = torch.randn((B, T, nq, H), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, T, nkv, H), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=True, window=w, q_offset=0)
        got = flash_attention.launch(q, k, v, **kw)
        want = ref.flash_attention_gqa_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _close(torch, got, want, f"windowed flash T={T}"))
        data[T] = (q, k, v)
        del want
    q, k, v = data[2304]
    qt = q[:, 2240:].contiguous()
    kw = dict(causal=True, window=w, q_offset=2240)
    clean = flash_attention.launch(qt, k, v, **kw)
    kn, vn = k.clone(), v.clone()
    kn[:, :192] = float("nan")
    vn[:, :192] = float("nan")
    dirty = flash_attention.launch(qt, kn, vn, **kw)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(dirty).all()) and torch.equal(dirty, clean)):
        raise AssertionError("windowed flash: key tiles wholly outside the window were read")
    log(f"flash_attention windowed (recurrentgemma-9b: B={B} NQ={nq} NKV={nkv} H={H} "
        f"window {w}) at T 320 and 2304 within atol=rtol={ATOL} (max |err| {worst:.3g}); "
        "the 6 key tiles before every row's window never read (NaN there: bitwise)")
    T = 2304
    kw = dict(causal=True, window=w, q_offset=0)
    ms = timer(lambda: flash_attention.launch(q, k, v, **kw))
    plain_ms = timer(lambda: ref.flash_attention_gqa_ref(q, k, v, **kw), iters=5)
    i = torch.arange(T, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    qs = q.transpose(1, 2)
    ks, vs = (a.transpose(1, 2).expand(B, nq, T, H).contiguous() for a in (k, v))
    F = torch.nn.functional
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    pairs = int(mask.sum())
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    b_ms, b_by = bound_ms(nbytes, 4 * B * nq * H * pairs, BF16_FLOPS_PER_S)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst,
            "shape": f"B*NQ={B * nq} NKV={nkv} T={T} H={H} bf16 causal window {w}"}


def check_rglru(torch, dev, timer):
    """The RG-LRU kernel against ``ref.rglru_scan_ref`` on the card at
    recurrentgemma-9b's width (W = 4096, B = 4, bf16 y, float32 gate
    projections) for T = 320 and T = 2304, with a carried h0 and ragged
    lengths: h and h at lengths - 1 within atol = rtol = 1e-4 (other
    transcendental roundings); a prompt run as two calls (T1 = 100, then
    the rest from the carry) bitwise one call; the step (T = 1 from h at t
    - 1) bitwise the call's h at t; rows alone, in a pair and in a
    three (B = 1, 2, 3: between them and B = 4 every tile plan of
    ``rglru.PLANS``) bitwise their rows of the B = 4 call, with zero and
    carried h0, with and without lengths; a T = 1 call with lengths (the
    step kernel) bitwise the step. Times B = 4, T = 320, B = 2, T = 2304
    (the ring-wrap prompts), B = 1, T = 320 (a continuous run's solo
    admission) and the T = 1 step, B = 4, each beside ``copy_ms``, one
    device-to-device copy moving the same number of bytes under the same
    timer."""
    from repro_torch.kernels import ref, rglru

    gen = torch.Generator(device=dev).manual_seed(27)
    B, W = 4, 4096

    def inputs(T):
        ga, gi = (torch.randn((B, T, W), generator=gen, device=dev) for _ in range(2))
        y = torch.randn((B, T, W), generator=gen, device=dev).to(torch.bfloat16)
        ab, ib = (torch.randn(W, generator=gen, device=dev) * 0.5 for _ in range(2))
        lam = torch.rand(W, generator=gen, device=dev) + 0.1
        h0 = torch.randn((B, W), generator=gen, device=dev)
        return ga, gi, y, ab, ib, lam, h0

    sms = rglru.sms(dev.index or 0)
    plans = {rglru.plan(B, W, sms)}
    worst = 0.0
    for T in (320, 2304):
        a = inputs(T)
        lengths = torch.tensor([T, T - 7, 1, T // 2], dtype=torch.int32, device=dev)
        held = {}      # h0 -> the B = 4 call with lengths, held to the plain version
        for h0 in (None, a[6]):
            got = held[h0 is not None] = rglru.launch(*a[:6], h0, lengths)
            want = ref.rglru_scan_ref(*a[:6], h0, lengths)
            torch.cuda.synchronize()
            what = f"rglru B={B} T={T} W={W} h0={h0 is not None}"
            worst = max(worst, _close(torch, got[0], want[0], what + " h", F32_TOL),
                        _close(torch, got[1], want[1], what + " h_last", F32_TOL))
        h, last = rglru.launch(*a[:6], a[6])
        h1, last1 = rglru.launch(*(t[:, :100] for t in a[:3]), *a[3:6], a[6])
        h2, last2 = rglru.launch(*(t[:, 100:] for t in a[:3]), *a[3:6], last1)
        step, _ = rglru.launch(*(t[:, 150:151] for t in a[:3]), *a[3:6], h[:, 149])
        step_len = rglru.launch(*(t[:, 150:151] for t in a[:3]), *a[3:6], h[:, 149],
                                lengths)
        torch.cuda.synchronize()
        if not (torch.equal(step_len[0], step) and torch.equal(step_len[1], step[:, 0])):
            raise AssertionError(f"rglru T={T}: a T = 1 call with lengths is not the step")
        if not (torch.equal(torch.cat([h1, h2], 1), h) and torch.equal(last2, last)):
            raise AssertionError(f"rglru T={T}: two calls with the carry are not one call")
        if not torch.equal(step[:, 0], h[:, 150]):
            raise AssertionError(f"rglru T={T}: the T = 1 step is not the call's h at t")
        # Rows alone (B = 1), in a pair (B = 2: the ring-wrap pair's batch)
        # and in a three run other tile plans than B = 4: bitwise their rows
        # of the B = 4 calls above.
        for rows in (slice(2, 3), slice(0, 2), slice(1, 4)):
            n = rows.stop - rows.start
            plans.add(rglru.plan(n, W, sms))
            sub = [t[rows] for t in a[:3]]
            pairs = [(rglru.launch(*sub, *a[3:6], a[6][rows]), (h, last))]
            for has_h0, whole in held.items():
                pairs.append((rglru.launch(*sub, *a[3:6], a[6][rows] if has_h0 else None,
                                           lengths[rows]), whole))
            torch.cuda.synchronize()
            for (h_part, last_part), (h_all, last_all) in pairs:
                if not (torch.equal(h_part, h_all[rows]) and torch.equal(last_part,
                                                                         last_all[rows])):
                    raise AssertionError(
                        f"rglru T={T}: rows {rows.start}-{rows.stop - 1} alone (plan "
                        f"{rglru.plan(n, W, sms)}) are not their rows in the batch")
    if plans != set(rglru.PLANS):
        raise AssertionError(f"rglru: the gates ran plans {sorted(plans)}, not every plan "
                             f"the kernel instantiates {sorted(rglru.PLANS)}")
    log(f"rglru: B={B} W={W} T in (320, 2304), zero and carried h0, ragged lengths, "
        f"within atol=rtol={F32_TOL} of the plain version (max |err| {worst:.3g}); split "
        "= whole, step = T=1 call, rows alone, in a pair and in a three = their rows in "
        f"the batch (plans {sorted(plans)}): bitwise")

    def timed(T, rows):
        a = [t[:rows] if t.dim() > 1 else t for t in inputs(T)]
        ms = timer(lambda: rglru.launch(*a))
        plain_ms = timer(lambda: ref.rglru_scan_ref(*a))
        n = rows * T * W
        # ga, gi, y and h0 read, h written (and h at T - 1 beside it for T > 1).
        nbytes = 2 * n * 4 + n * 2 + n * 4 + rows * W * 4 * (2 if T > 1 else 1) + 3 * W * 4
        copy_ms = copy_time(torch, dev, timer, nbytes)
        b_ms, b_by = bound_ms(nbytes, 18 * n, FP32_FLOPS_PER_S)
        tile = "step kernel" if T == 1 else "tile {}, {} gate warps".format(
            *rglru.plan(rows, W, sms))
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
                "bound_by": b_by, "copy_ms": copy_ms,
                "shape": f"B={rows} T={T} W={W} f32 gates, bf16 y, carried h0, {tile}"}

    entries = {"prefill": timed(320, B), "prefill_t2304": timed(2304, 2),
               "prefill_b1": timed(320, 1), "decode": timed(1, B)}
    return {**entries["prefill"], "max_abs_err": worst, "entries": entries}


def copy_time(torch, dev, timer, nbytes):
    """A yardstick of `nbytes` moved, not of a function: the time of one
    device-to-device copy (cudaMemcpyAsync) that reads half of them and
    writes the other half, under `timer`."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return timer(lambda: dst.copy_(src))


def copy_note(e):
    """The printed form of an entry's bytes yardstick, where it has one."""
    return f", copy of its bytes {e['copy_ms']:.4g} ms" if "copy_ms" in e else ""


def check_dense_f32(torch, dev, timer):
    """``dense_matmul``'s float32 store at recurrentgemma-9b's gate
    projections (4096 -> 4096, bf16 y and W): within 1e-4 of the float32
    product JAX computes (``y.float() @ W.float()``), each row at M in
    HEAD_M (decode, up to 9 rows) and at M = 1280 (a static prefill of 4 x
    320) bitwise the same row at M = 4, and the bf16 store bitwise the
    float32 store rounded. Times M = 4 and M = 1280."""
    from repro_torch.kernels import dense_matmul

    gen = torch.Generator(device=dev).manual_seed(28)
    K = N = 4096
    f32 = torch.float32
    w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((1280, K), generator=gen, device=dev).to(torch.bfloat16)
    full = dense_matmul.launch(x, w, out_dtype=f32)
    want = x.float() @ w.float()
    bf = dense_matmul.launch(x, w)
    at4 = dense_matmul.launch(x[:4], w, out_dtype=f32)
    torch.cuda.synchronize()
    err = _close(torch, full, want, "dense_matmul f32 store 4096x4096", F32_TOL)
    if not torch.equal(bf, full.to(torch.bfloat16)):
        raise AssertionError("dense_matmul: the bf16 store is not the f32 store rounded")
    parted = []
    for M in (*HEAD_M, 1280):
        rows = full[:M] if M == 1280 else dense_matmul.launch(x[:M], w, out_dtype=f32)
        torch.cuda.synchronize()
        parted += [(M, i) for i in range(min(M, 4)) if not torch.equal(rows[i], at4[i])]
    if parted:
        raise AssertionError(f"dense_matmul f32 store: rows part from M = 4 at {parted}")
    log(f"dense_matmul float32 store (griffin gate projections 4096 -> 4096): within "
        f"{F32_TOL} of the f32 product (max |err| {err:.3g}); rows at M in {HEAD_M} and "
        "1280 bitwise their M = 4 rows; bf16 store = f32 store rounded")

    def timed(M):
        xm = x[:M].contiguous()
        ms = timer(lambda: dense_matmul.launch(xm, w, out_dtype=f32))
        plain_ms = timer(lambda: xm.float() @ w.float())
        lib_ms = timer(lambda: torch.matmul(xm, w))
        b_ms, b_by = bound_ms(2 * (M * K + K * N) + 4 * M * N, 2 * M * K * N,
                              BF16_FLOPS_PER_S)
        S, _, bm = dense_matmul.launch_plan(M, K, N)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by, "slices": S, "rows_per_block": bm,
                "shape": f"M={M} {K}->{N} bf16 in, f32 out"}

    return {"max_abs_err": err,
            "entries": {"gate_f32_decode": timed(4), "gate_f32_prefill": timed(1280)}}


# The archs' d_model (hubert-xlarge's 1280 among them), stablelm's head
# dim, and rwkv6's group norm: 64-wide rows, 40 heads a token.
NORM_D = (4096, 6144, 5120, 2560, 2048, 1280, 160, 64)
NORM_ROWS_PER = {64: 40}     # rows a batch row at width d (the group norm's heads)


def check_norm_rows(torch, dev):
    """The norms' row mean (``common.row_mean``: 32-wide sums in stages on
    the card) at every width a norm of the port reduces: each row at M in
    HEAD_M batch rows (times NORM_ROWS_PER: rwkv6's group norm reduces 40
    rows of 64 a token) bitwise its row at M = 4 (gated), and within 1e-6
    of ``x.mean`` relative to the rows' mean |x|. Also reports where
    ``x.mean`` itself parts across M (not gated: PyTorch sizes the
    reduction's blocks from the row count, which is why the norms do not
    use it on the card; at width 64 it is what rwkv6's ``_group_norm``
    runs)."""
    from repro_torch.models.common import row_mean

    gen = torch.Generator(device=dev).manual_seed(29)
    parted, plain_parted, worst = [], {}, 0.0
    for d in NORM_D:
        per = NORM_ROWS_PER.get(d, 1)
        x = torch.randn((max(HEAD_M) * per, d), generator=gen, device=dev) * 3
        at4, mean4 = row_mean(x[:4 * per]), x[:4 * per].mean(-1, keepdim=True)
        scale = x[:4 * per].abs().mean(-1, keepdim=True)
        worst = max(worst, ((at4 - mean4).abs() / scale).max().item())
        for M in HEAD_M:
            got, ref = row_mean(x[:M * per]), x[:M * per].mean(-1, keepdim=True)
            n = min(M, 4) * per
            if not torch.equal(got[:n], at4[:n]):
                parted.append((d, M))
            if not torch.equal(ref[:n], mean4[:n]):
                plain_parted.setdefault(d, []).append(M)
    torch.cuda.synchronize()
    log(f"norm row mean at d in {NORM_D} (rows x {NORM_ROWS_PER} where given): rows at "
        f"M in {HEAD_M} not bitwise M = 4: {parted or 'none'} (gated); x.mean's: "
        f"{plain_parted or 'none'} (not used; at d = 64 rwkv6's _group_norm's); "
        f"gap to x.mean {worst:.3g} of the mean |x|")
    if parted or worst > 1e-6:
        raise AssertionError(f"row_mean: rows part across M at {parted}, gap {worst}")
    return {"plain_mean_parted": plain_parted, "max_rel_gap": worst}


# The ring-wrap pair: a prompt past the window (it wraps inside prefill)
# and one 8 short of it decoding 24 tokens (it wraps while decoding).
WRAP_PROMPTS = ((2300, 24), (2040, 24))


def serve_griffin(torch, dev):
    """Runs (s) and (t) of GRIFFIN_RUNS and their gates: the raw bf16
    weights (seed 0) are drawn once and served unquantized by both runs,
    then dropped with the engines.

    Gated (besides ``serve_run``'s checks): the untied 4096 -> 256 000
    head's rows at M = 1-9 bitwise its rows at M = 4 (``head_rows``); (t)
    continuous emits (s) static's greedy tokens; first-token logits of the
    stream's prompts bitwise equal in a static batch and alone; solo ≡
    mid-decode admission on (t)'s engine; the ring-wrap pair (a 2300-token
    prompt, which wraps the 2048-slot ring inside prefill, and a
    2040-token prompt decoding 24 tokens, which wraps it while decoding),
    static vs continuous on (s)'s engine: the same greedy tokens. Prints
    the time and peak device memory of the init and of each run; every
    gate prints before one raises. Returns (report, launch counts summed
    over the two runs)."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import Request

    cfg = get_config(GRIFFIN)
    rep, counts, bad = {}, {}, []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed=0, device=dev)
    torch.cuda.synchronize()
    rep["init_s"], rep["init_peak_gb"] = time.perf_counter() - t0, _mem_gb(torch)
    rep["resident_gb"] = torch.cuda.memory_allocated() / 1e9

    def numel(tree):
        return (sum(numel(v) for v in tree.values()) if isinstance(tree, dict)
                else tree.numel())

    rep["parameters"] = numel(params)
    rep["head_parted"] = parted = head_rows(torch, params["head"])
    log(f"{GRIFFIN}: {rep['parameters']} parameters, init {rep['init_s']:.1f}s, peak "
        f"{rep['init_peak_gb']:.2f} GB, {rep['resident_gb']:.2f} GB resident; untied head "
        f"{tuple(params['head'].shape)} rows at M in {HEAD_M} not bitwise M = 4: "
        f"torch.matmul {parted['torch.matmul'] or 'none'} (gated), dense_matmul "
        f"{parted['dense_matmul'] or 'none'}")
    if parted["torch.matmul"]:
        bad.append(f"head rows part across M {parted['torch.matmul']}")
    runs = {}
    for name in GRIFFIN_RUNS:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[name] = serve_run(torch, params, name)
        run_s, peak = time.perf_counter() - t0, _mem_gb(torch)
        rep[name] = {**runs[name][1], "run_seconds": run_s, "peak_gb": peak}
        for k, n in runs[name][2].items():
            counts[k] = counts.get(k, 0) + n
        log(f"  [{name}] {run_s:.1f}s, peak memory {peak:.2f} GB "
            "(torch.cuda.max_memory_allocated)")
    reqs = mixed_requests(cfg, serve.build_parser().parse_args(
        serve_argv("s-griffin-static")))
    greedy = [r.rid for r in reqs if r.temperature == 0]
    share = _greedy_share(runs["s-griffin-static"][3], runs["t-griffin-continuous"][3],
                          greedy)
    eng = runs["s-griffin-static"][0]
    t0 = time.perf_counter()
    solo, batch = batch_and_solo_logits(torch, eng, [r.prompt for r in reqs])
    err = (batch - solo).abs().max().item()
    toks = solo_vs_mid_decode(runs["t-griffin-continuous"][0])
    rng = np.random.default_rng(25)
    wrap = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int64),
                    max_new_tokens=m) for i, (n, m) in enumerate(WRAP_PROMPTS)]

    def fresh():
        return [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                for r in wrap]

    static = {r.rid: r.out_tokens for r in eng.generate_static(fresh())}
    cont = {r.rid: r.out_tokens for r in eng.generate(fresh())}
    torch.cuda.synchronize()
    rep.update(static_vs_continuous=share, logits_err_batch_vs_solo=err,
               solo_vs_mid_decode=len(toks), ring_wrap_static=static,
               ring_wrap_continuous=cont, gates_s=time.perf_counter() - t0)
    log(f"{GRIFFIN}: greedy (t) continuous vs (s) static {share} (gated at all); "
        f"first-token logits static batch of 4 vs solo max |err| {err:.3g} (gated at 0); "
        f"solo == mid-decode admission: {len(toks)} greedy tokens identical; ring-wrap "
        f"pair {WRAP_PROMPTS} (prompt, new tokens) static vs continuous: "
        f"{sum(static[i] == cont[i] for i in static)}/{len(static)} identical (gated), "
        f"{[len(t) for t in static.values()]} tokens; gates {rep['gates_s']:.1f}s")
    if share != f"{len(greedy)}/{len(greedy)}":
        bad.append(f"(t) vs (s) {share}")
    if err != 0.0:
        bad.append(f"static batch vs solo logits {err}")
    if static != cont or any(len(t) != m for t, (_, m) in zip(static.values(),
                                                             WRAP_PROMPTS)):
        bad.append(f"ring-wrap pair static {static} vs continuous {cont}")
    del runs, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{GRIFFIN}: {bad}")
    return rep, counts


def card_vs_cpu_griffin(torch):
    """Reduced recurrentgemma-9b in float32 (window 16): a whole-prompt
    prefill of two right-padded prompts (40 and 21 tokens, past the
    window) and five decode steps on the card (windowed flash, the ring
    entry, the RG-LRU kernel) vs on the CPU (their plain versions):
    logits within 1e-3 (float32 sums in other orders)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_reduced_config(GRIFFIN), dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        toks = (torch.arange(2 * 40, device=dev).reshape(2, 40) * 11) % cfg.vocab
        cache, lg = model.prefill(p, {"tokens": toks, "lengths": torch.tensor([40, 21])})
        lgs = [lg]
        for t in range(5):
            cache, lg = model.decode_step(p, cache, torch.tensor([[3 + t], [5 + t]],
                                                                 device=dev))
            lgs.append(lg)
        out[dev] = torch.cat([lg.reshape(1, -1) for lg in lgs], dim=1).cpu()
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"reduced fp32 {GRIFFIN}: card vs CPU logits differ by {err}")
    return err


# -- the frontend families: paligemma-3b (VLM) and hubert-xlarge (encoder) ---

VLM, ENCODER = "paligemma-3b", "hubert-xlarge"
# paligemma's rows: 256 patch embeddings, then text of the stream's first
# 4 prompt lengths, right-padded to 320 (lengths count the patches).
VLM_TEXT = (64, 320, 128, 256)
ENCODER_T = 500           # 10 s clips at HuBERT's 20 ms frame stride
FRONTEND_KERNELS = {
    VLM: ("flash_attention", "contig_attention", "quantize_rows", "bitplane_matmul",
          "fused_quantize_matmul", "dense_matmul"),
    ENCODER: ("flash_attention", "fused_quantize_matmul", "dense_matmul"),
}


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def check_frontend_flash(torch, dev, timer):
    """The flash kernel on the frontend families' masks, within atol = rtol
    = 2e-2 (bf16) and 1e-4 (float32) of ``ref.flash_attention_gqa_ref``:
    prefix-LM at paligemma's MQA 8/1, H 256, with P = 8 (the first 64-row
    block straddles it) at T 300 and P = 256 (on a tile edge) at T 576,
    with and without a window of 128, at q_offset 0 and 16 (a tail whose
    prefix lies before it); bidirectional (causal = 0) at hubert's MHA
    16/16, H 80, T 37 and 500. Bitwise, in bf16: a prefix-LM prompt cut to
    n >= P positions gives its longer batch's rows; bidirectional rows
    among fewer queries (every key kept); rows computed as a tail at
    q_offset 37 (grouped into other 64-row blocks) are the whole prompt's
    rows, for both masks. Times paligemma's prefill (B·NQ 32, NKV 1, T 576
    = 256 + 320, H 256, prefix 256) and hubert's encoder (B·NQ 64, T 500,
    H 80, non-causal) beside their plain versions and SDPA (K/V expanded
    to the query heads; the prefix-LM mask as a boolean mask). Returns
    (entries, max |err|, cases)."""
    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device=dev).manual_seed(31)
    F = torch.nn.functional
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases = 0

    def rand(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dt in (torch.bfloat16, torch.float32):
        tol = ATOL if dt == torch.bfloat16 else F32_TOL
        specs = [(8, 1, 256, T, dict(causal=True, window=w, q_offset=o, prefix_len=P))
                 for P, T in ((8, 300), (256, 576)) for w in (0, 128) for o in (0, 16)]
        specs += [(16, 16, 80, T, dict(causal=False, window=0, q_offset=o, prefix_len=0))
                  for T in (37, 500) for o in (0, 16)]
        for nq, nkv, H, T, kw in specs:
            Tk = T + kw["q_offset"]
            q, k, v = rand(2, T, nq, H, dt=dt), rand(2, Tk, nkv, H, dt=dt), rand(2, Tk, nkv, H, dt=dt)
            got = flash_attention.launch(q, k, v, **kw)
            want = ref.flash_attention_gqa_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            worst[dt] = max(worst[dt], _close(torch, got, want, f"flash NQ={nq} NKV={nkv} "
                                              f"H={H} T={T} {dt} {kw}", tol))
            cases += 1
    bad = []
    for nq, nkv, H, T, kw in ((8, 1, 256, 576, dict(causal=True, window=0, prefix_len=256)),
                              (16, 16, 80, 500, dict(causal=False, window=0, prefix_len=0))):
        q, k, v = rand(2, T, nq, H), rand(2, T, nkv, H), rand(2, T, nkv, H)
        full = flash_attention.launch(q, k, v, q_offset=0, **kw)
        for n in (300, 320):
            if kw["causal"]:
                part = flash_attention.launch(q[:, :n].contiguous(), k[:, :n].contiguous(),
                                              v[:, :n].contiguous(), q_offset=0, **kw)
            else:
                part = flash_attention.launch(q[:, :n].contiguous(), k, v, q_offset=0, **kw)
            if not torch.equal(part, full[:, :n]):
                bad.append(f"{kw} cut to {n}")
        tail = flash_attention.launch(q[:, 37:].contiguous(), k, v, q_offset=37, **kw)
        if not torch.equal(tail, full[:, 37:]):
            bad.append(f"{kw} tail at q_offset 37")
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"flash_attention: rows depend on padding or grouping: {bad}")
    log(f"flash_attention frontends: {cases} cases (prefix-LM NQ 8 / NKV 1 / H 256 at P 8 "
        f"and 256, window 0/128, q_offset 0/16; bidirectional 16/16 / H 80 at T 37 and "
        f"500) within atol=rtol={ATOL} (bf16, max |err| {worst[torch.bfloat16]:.3g}) and "
        f"{F32_TOL} (f32, max |err| {worst[torch.float32]:.3g}); rows bitwise independent "
        "of padding and of their 64-row block, both masks")

    entries = {}
    B, P, T, nq, H = 4, 256, 576, 8, 256
    q, k, v = rand(B, T, nq, H), rand(B, T, 1, H), rand(B, T, 1, H)
    kw = dict(causal=True, window=0, q_offset=0, prefix_len=P)
    i = torch.arange(T, device=dev)
    mask = (i[None, :] <= i[:, None]) | (i[None, :] < P)
    qs = q.transpose(1, 2)
    ks, vs = (a.transpose(1, 2).expand(B, nq, T, H).contiguous() for a in (k, v))
    b_ms, b_by = bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2,
                          4 * B * nq * H * int(mask.sum()), BF16_FLOPS_PER_S)
    entries["prefix_lm_prefill"] = {
        "ms": timer(lambda: flash_attention.launch(q, k, v, **kw)),
        "plain_ms": timer(lambda: ref.flash_attention_gqa_ref(q, k, v, **kw), iters=5),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                   attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": worst[torch.bfloat16],
        "shape": f"B*NQ={B * nq} NKV=1 T={T} H={H} bf16 prefix-LM {P}"}
    B, T, nq, H = 4, ENCODER_T, 16, 80
    q, k, v = rand(B, T, nq, H), rand(B, T, nq, H), rand(B, T, nq, H)
    kw = dict(causal=False, window=0, q_offset=0)
    qs, ks, vs = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    b_ms, b_by = bound_ms(4 * q.numel() * 2, 4 * B * nq * H * T * T, BF16_FLOPS_PER_S)
    entries["bidirectional_encoder"] = {
        "ms": timer(lambda: flash_attention.launch(q, k, v, **kw)),
        "plain_ms": timer(lambda: ref.flash_attention_gqa_ref(q, k, v, **kw), iters=5),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": worst[torch.bfloat16],
        "shape": f"B*NQ={B * nq} NKV={nq} T={T} H={H} bf16 non-causal"}
    return entries, max(worst.values()), cases


def _numel(tree):
    return (sum(_numel(v) for v in tree.values()) if isinstance(tree, dict)
            else tree.numel())


def serve_frontends(torch, dev):
    """paligemma-3b and hubert-xlarge at full width and depth (18 and 48
    layers, random bf16 weights from seed 0, packed; each arch's weights
    dropped before the next) through ``build_model(cfg)``'s entries.

    paligemma-3b under the Table III policy "w4a6r25;wo=w8a8" on the
    contiguous bf16 cache: B = 4 rows of 256 random patch embeddings (1152
    wide) and 64-320 text tokens, right-padded with lengths; prefill, then
    8 greedy decode steps (DECODE_HEADROOM), its launches counted (flash
    under the prefix-LM mask, the contiguous decode entry, the Table III
    and uniform packed linears, ``dense_matmul`` for ``patch_proj``).
    Gated, bitwise: the tied 2048 -> 257 216 head's rows at M = 1-9 its
    rows at M = 4 (``head_rows``); teacher forcing (prefill of each row's
    text and its first greedy token gives the logits of the decode step
    that took that token, both at M = B); each row alone (prefill and 8
    steps) gives its batch row's logits and tokens; the prefix-LM mask
    (the last patch moves position 0; a text token leaves every earlier
    position unchanged).

    hubert-xlarge under "w4a8;wo=w8a8": B = 4 clips of 500 frames (512
    wide); ``forward_hidden`` → ``compute_logits`` and ``prefill``, its
    launches counted (flash with causal = 0, the fused kernel,
    ``dense_matmul`` for ``frame_proj``). Gated: each clip alone gives its
    batch row's hidden states bitwise and its logits within 1e-2 (the
    untied head is ``torch.matmul`` at B·T rows); the last frame moves
    the first position; ``prefill``'s logits within 1e-2 of the forward's
    last position.

    Prints each arch's parameters, init and pack time and peak memory,
    paligemma's prefill time and greedy tokens/s over the 8 steps, and
    the phase's seconds, each beside the card's name and power limit.
    Every gate prints before one raises. Returns (report, launch counts
    summed over the two archs' counted drives)."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer

    smi = nvidia_smi()
    steps = transformer.DECODE_HEADROOM          # the cache's free slots after prefill
    t_phase = time.perf_counter()
    out, counts, bad = {VLM: {}, ENCODER: {}}, {}, []

    def add(c):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n

    # -- paligemma-3b -------------------------------------------------------
    rep = out[VLM]
    cfg = get_config(VLM)
    model = build_model(cfg)

    def tied_head(raw):
        parted = rep["head_parted"] = head_rows(torch, raw["embed"], transpose=True)
        log(f"{VLM}: tied head {tuple(raw['embed'].shape)}^T rows at M in {HEAD_M} not "
            f"bitwise M = 4: torch.matmul {parted['torch.matmul'] or 'none'} (gated), "
            f"dense_matmul {parted['dense_matmul'] or 'none'}")
        if parted["torch.matmul"]:
            bad.append(f"{VLM}: tied head rows part across M {parted['torch.matmul']}")

    params = _draw_and_pack(torch, dev, cfg, MIXED_POLICY, rep, smi, tied_head)
    P = cfg.num_prefix_embeds
    rng = np.random.default_rng(26)
    patches = torch.from_numpy(rng.standard_normal(
        (len(VLM_TEXT), P, cfg.frontend_dim)).astype(np.float32)).to(dev)
    texts = [rng.integers(0, cfg.vocab, n) for n in VLM_TEXT]

    def batch(rows, ts):
        toks = np.zeros((len(ts), max(len(t) for t in ts)), np.int64)
        for i, t in enumerate(ts):
            toks[i, :len(t)] = t
        return {"patches": patches[rows], "tokens": torch.from_numpy(toks).to(dev),
                "lengths": torch.tensor([P + len(t) for t in ts], dtype=torch.int32)}

    def generate(rows, ts):
        """Prefill, then `steps` greedy steps: (prefill s, decode s,
        [first-token logits, each step's logits] (B, V) float32, tokens
        (B, steps + 1))."""
        t0 = time.perf_counter()
        cache, lg = model.prefill(params, batch(rows, ts))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lgs = [lg[:, -1].float()]
        toks = [lg[:, -1].argmax(-1, keepdim=True)]
        for _ in range(steps):
            cache, lg = model.decode_step(params, cache, toks[-1])
            lgs.append(lg[:, -1].float())
            toks.append(lg[:, -1].argmax(-1, keepdim=True))
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1, lgs, torch.cat(toks, dim=1)

    rows = list(range(len(VLM_TEXT)))
    generate(rows, texts)                                    # warm up
    torch.cuda.reset_peak_memory_stats()
    (pre_s, dec_s, lgs, toks), c = _counted(torch, lambda: generate(rows, texts))
    add(c)
    rep.update(peak_gb=_mem_gb(torch), prefill_s=pre_s, decode_s=dec_s,
               decode_tok_per_s=len(rows) * steps / dec_s, launches=c,
               tokens=toks.tolist())
    log(f"{VLM}: prefill B={len(rows)} ({P} patches + {VLM_TEXT} text) {pre_s * 1e3:.1f} ms, "
        f"{steps} greedy steps {dec_s * 1e3:.1f} ms = "
        f"{rep['decode_tok_per_s']:.1f} tok/s, peak {rep['peak_gb']:.2f} GB "
        f"[{smi}]; launches {c}")
    missing = [k for k in FRONTEND_KERNELS[VLM] if c.get(k, 0) <= 0]
    if missing:
        bad.append(f"{VLM}: {missing} never launched")
    t0 = time.perf_counter()
    # Teacher forcing: each text and its first greedy token, prefilled.
    forced = [np.concatenate([t, toks[i, :1].cpu().numpy()]) for i, t in enumerate(texts)]
    _, lg = model.prefill(params, batch(rows, forced))
    tf_err = (lg[:, -1].float() - lgs[1]).abs().max().item()
    # Each row alone.
    solo_err, solo_toks = 0.0, 0
    for i in rows:
        _, _, s_lgs, s_toks = generate([i], [texts[i]])
        solo_err = max(solo_err, max((a[0] - b[i]).abs().max().item()
                                     for a, b in zip(s_lgs, lgs)))
        solo_toks += int(torch.equal(s_toks[0], toks[i]))
    # The mask: prefix-LM over the patches, causal over the text.
    one = batch([0], [texts[0]])
    base = transformer.forward_hidden(params, cfg, one)
    moved = dict(one, patches=one["patches"].clone())
    moved["patches"][:, P - 1] += 1.0
    h_patch = transformer.forward_hidden(params, cfg, moved)
    j = 10
    edited = dict(one, tokens=one["tokens"].clone())
    edited["tokens"][:, j] = (edited["tokens"][:, j] + 1) % cfg.vocab
    h_text = transformer.forward_hidden(params, cfg, edited)
    mask_ok = {"last_patch_moves_position_0": not torch.equal(h_patch[:, 0], base[:, 0]),
               "text_token_keeps_earlier": torch.equal(h_text[:, :P + j], base[:, :P + j]),
               "text_token_moves_itself": not torch.equal(h_text[:, P + j], base[:, P + j])}
    torch.cuda.synchronize()
    rep.update(teacher_forcing_err=tf_err, batch_vs_solo_err=solo_err,
               batch_vs_solo_tokens=f"{solo_toks}/{len(rows)}", mask=mask_ok,
               gates_s=time.perf_counter() - t0)
    log(f"{VLM}: teacher-forced prefill vs decode step logits max |err| {tf_err:.3g} "
        f"(gated at 0); each row alone vs its batch row: logits max |err| {solo_err:.3g} "
        f"(gated at 0), greedy tokens {solo_toks}/{len(rows)} identical; prefix-LM "
        f"mask {mask_ok}; gates {rep['gates_s']:.1f}s")
    if tf_err != 0.0 or solo_err != 0.0 or solo_toks != len(rows) or not all(mask_ok.values()):
        bad.append(f"{VLM}: teacher forcing {tf_err}, solo {solo_err} / {solo_toks}, "
                   f"mask {mask_ok}")
    del params, patches, base, h_patch, h_text, lg, lgs
    gc.collect()
    torch.cuda.empty_cache()

    # -- hubert-xlarge ------------------------------------------------------
    rep = out[ENCODER]
    cfg = get_config(ENCODER)
    model = build_model(cfg)
    params = _draw_and_pack(torch, dev, cfg, POLICY, rep, smi)
    rng = np.random.default_rng(27)
    frames = torch.from_numpy(rng.standard_normal(
        (4, ENCODER_T, cfg.frontend_dim)).astype(np.float32)).to(dev)

    def encode(f):
        hidden = transformer.forward_hidden(params, cfg, {"frames": f})
        return hidden, transformer.compute_logits(params, cfg, hidden)

    def drive():
        t0 = time.perf_counter()
        hidden, logits = encode(frames)
        _, last = model.prefill(params, {"frames": frames})
        torch.cuda.synchronize()
        return time.perf_counter() - t0, hidden, logits, last

    drive()                                                  # warm up
    torch.cuda.reset_peak_memory_stats()
    (enc_s, hidden, logits, last), c = _counted(torch, drive)
    add(c)
    rep.update(peak_gb=_mem_gb(torch), forward_and_prefill_s=enc_s, launches=c)
    log(f"{ENCODER}: forward_hidden + logits + prefill, B=4 x T={ENCODER_T} frames, "
        f"{enc_s * 1e3:.1f} ms, peak {rep['peak_gb']:.2f} GB [{smi}]; launches {c}")
    missing = [k for k in FRONTEND_KERNELS[ENCODER] if c.get(k, 0) <= 0]
    if missing:
        bad.append(f"{ENCODER}: {missing} never launched")
    t0 = time.perf_counter()
    solo_hidden, solo_logits = 0, 0.0
    for i in range(frames.shape[0]):
        h, lg = encode(frames[i:i + 1])
        solo_hidden += int(torch.equal(h[0], hidden[i]))
        solo_logits = max(solo_logits, (lg[0] - logits[i]).abs().max().item())
    f2 = frames[:1].clone()
    f2[:, -1] += 1.0
    moves = not torch.equal(encode(f2)[0][0, 0], hidden[0, 0])
    prefill_err = (last[:, 0] - logits[:, -1]).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    rep.update(batch_vs_solo_hidden=f"{solo_hidden}/4", batch_vs_solo_logits_err=solo_logits,
               last_frame_moves_first=moves, prefill_vs_forward_err=prefill_err,
               gates_s=time.perf_counter() - t0)
    log(f"{ENCODER}: each clip alone vs its batch row: hidden states {solo_hidden}/4 "
        f"bitwise (gated), logits max |err| {solo_logits:.3g} (gated at 1e-2); the last "
        f"frame moves position 0: {moves}; prefill vs forward last-position logits max "
        f"|err| {prefill_err:.3g} (gated at 1e-2); finite {finite}; gates "
        f"{rep['gates_s']:.1f}s")
    if (solo_hidden != 4 or not solo_logits <= 1e-2 or not moves
            or not prefill_err <= 1e-2 or not finite):
        bad.append(f"{ENCODER}: solo {solo_hidden}/4, {solo_logits}, moves {moves}, "
                   f"prefill {prefill_err}, finite {finite}")
    del params, frames, hidden, logits, last
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"frontends phase (paligemma-3b, hubert-xlarge): {out['phase_s']:.1f}s [{smi}]")
    if bad:
        raise AssertionError(f"frontends: {bad}")
    return out, counts


def card_vs_cpu_frontends(torch):
    """Reduced paligemma-3b and hubert-xlarge in float32, unpacked, on the
    card (the float32 flash kernel under the prefix-LM and bidirectional
    masks, the contiguous decode entry) vs on the CPU (plain versions):
    paligemma's right-padded prefill of two rows and three decode steps,
    hubert's forward logits at every position and its prefill. Logits
    within 1e-3 (float32 sums in other orders). Returns arch → max |err|."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model, transformer

    errs = {}
    for arch in (VLM, ENCODER):
        cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        model = build_model(cfg)
        params = model.init(seed=0, device="cpu")
        rng = np.random.default_rng(4)
        if arch == VLM:
            P = cfg.num_prefix_embeds
            patches = torch.from_numpy(rng.standard_normal(
                (2, P, cfg.frontend_dim)).astype(np.float32))
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
        else:
            frames = torch.from_numpy(rng.standard_normal(
                (2, 40, cfg.frontend_dim)).astype(np.float32))
        out = {}
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            if arch == VLM:
                cache, lg = model.prefill(p, {"patches": patches.to(dev),
                                              "tokens": toks.to(dev),
                                              "lengths": torch.tensor([P + 24, P + 13])})
                lgs = [lg]
                for t in range(3):
                    cache, lg = model.decode_step(p, cache, torch.tensor(
                        [[3 + t], [5 + t]], device=dev))
                    lgs.append(lg)
            else:
                hidden = transformer.forward_hidden(p, cfg, {"frames": frames.to(dev)})
                lgs = [transformer.compute_logits(p, cfg, hidden),
                       model.prefill(p, {"frames": frames.to(dev)})[1]]
            out[dev] = torch.cat([lg.reshape(1, -1) for lg in lgs], dim=1).cpu()
        err = errs[arch] = (out["cpu"] - out["cuda"]).abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"reduced fp32 {arch}: card vs CPU logits differ by {err}")
    return errs


def _to(tree, dev):
    from repro_torch.core.quantized_linear import PackedWeight

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return dataclasses.replace(
            tree, packed=tree.packed.to(dev), scale=tree.scale.to(dev),
            packed8=None if tree.packed8 is None else tree.packed8.to(dev))
    return tree.to(dev)


# -- training (slice 16): the flash backward, QAT fine-tuning of olmo-1b ------

# check_flash_backward cases: (name, B, Tq, Tk, NQ, NKV, H, mask). Every
# head dim of the forward, each mask, ragged lengths, a tail at q_offset
# > 0, and rows that see no key (window past the last key).
BWD_CASES = (
    ("olmo causal G=1", 2, 64, 64, 16, 16, 128, dict(causal=True, window=0, q_offset=0)),
    ("nemotron G=6", 1, 100, 100, 12, 2, 128, dict(causal=True, window=0, q_offset=0)),
    ("paligemma prefix-LM 256 of 576, MQA 8/1", 1, 576, 576, 8, 1, 256,
     dict(causal=True, window=0, q_offset=0, prefix_len=256)),
    ("hubert bidirectional", 1, 500, 500, 16, 16, 80, dict(causal=False, window=0, q_offset=0)),
    ("window 64, ragged T 300", 2, 300, 300, 4, 2, 64, dict(causal=True, window=64, q_offset=0)),
    ("ragged T 37", 2, 37, 37, 4, 2, 16, dict(causal=True, window=0, q_offset=0)),
    ("q_offset 16", 2, 33, 49, 8, 2, 160, dict(causal=True, window=0, q_offset=16)),
    ("rows that see no key", 2, 40, 20, 4, 4, 192, dict(causal=True, window=8, q_offset=10)),
    # The bf16 route's tile edges: Tk no multiple of its 64-key tile, G = 4,
    # a window whose rows straddle tile edges; H 256 MQA over four key tiles.
    ("G=4 window 100, ragged T 333", 2, 333, 333, 8, 2, 128,
     dict(causal=True, window=100, q_offset=0)),
    ("MQA 4/1 H 256 over four key tiles", 1, 250, 250, 4, 1, 256,
     dict(causal=True, window=0, q_offset=0)),
    # Griffin's training shape: MQA 16/1, H 256, its 2048-key window.
    ("griffin MQA 16/1 H 256 window 2048", 1, 512, 512, 16, 1, 256,
     dict(causal=True, window=2048, q_offset=0)),
)
BWD_F32_TOL = 1e-4     # relative to max |g| of the plain version's gradient
BWD_BF16_TOL = 2e-2
# The bf16 worst errors of the scalar first design (its last run on the H100), printed
# beside this run's: over the cases, and at the training shape.
BWD_BF16_WORST_BEFORE = (7.04e-3, 4.42e-3)
# The training shape of the timed entry: olmo-1b at --global-batch 8 --seq 512.
TRAIN_B, TRAIN_T = 8, 512


def _bwd_close(torch, got, want, tol, what):
    """(worst |err| over dQ, dK, dV relative to max |g| of the plain
    version's gradient, worst |err|); raises if a gradient is not finite
    or its relative error passes `tol`."""
    torch.cuda.synchronize()
    worst, worst_abs = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"flash backward {what}: {name} not finite")
        scale = max(w.float().abs().max().item(), 1e-30)
        abs_err = (g.float() - w.float()).abs().max().item()
        err = abs_err / scale
        if not err <= tol:
            raise AssertionError(f"flash backward {what}: {name} max |err| {err:.3g} of "
                                 f"max |g| beyond {tol}")
        worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
    return worst, worst_abs


def check_flash_backward(torch, dev, timer):
    """``flash_attention_bwd`` (dQ, dK, dV) against the plain version's
    autograd gradients (``ref.flash_attention_bwd_ref``) on the card, each
    case of BWD_CASES in float32 (the scalar route, within 1e-4 of max
    |g|) and bfloat16 (the tensor-core route, 2e-2): sums in another
    order; in bf16 the plain version's softmax never rounds P, the kernel
    rounds P and dS to bf16 as operands, and its D = rowsum(dO * O) reads
    O rounded to bf16. Rows that see no key get zero gradients, never
    NaN. Two calls give the same bits. Timed at olmo-1b's training shape
    (B 8, 16 heads of 128, T 512, causal, bf16) beside the plain version
    and SDPA's backward (the library's own forward once, then its
    backward timed); there the last timed call is held to the plain
    version's gradients within 2e-2 and a further call to its bits, as
    every case is, and batch row 3 computed alone to the bits of row 3 in
    the batch of 8 (the tile plan depends on H alone). Then timed at
    paligemma's prefix-LM shape and hubert's bidirectional one (the
    ``entries``, each held to its plain version within 2e-2)."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref

    gen = torch.Generator(device=dev).manual_seed(41)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_abs = 0.0
    cases = 0

    def rand(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dt in (torch.float32, torch.bfloat16):
        tol = BWD_F32_TOL if dt == torch.float32 else BWD_BF16_TOL
        for name, B, Tq, Tk, nq, nkv, H, kw in BWD_CASES:
            q = rand(B, Tq, nq, H, dt=dt)
            k, v = rand(B, Tk, nkv, H, dt=dt), rand(B, Tk, nkv, H, dt=dt)
            do = rand(B, Tq, nq, H, dt=dt)
            out = flash_attention.launch(q, k, v, **kw)
            got = flash_attention_bwd.launch(q, k, v, out, do, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
            err, abs_err = _bwd_close(torch, got, want, tol, f"{name} {dt}")
            worst_abs = max(worst_abs, abs_err)
            worst[dt] = max(worst[dt], err)
            if name == "rows that see no key":
                p = kw["q_offset"] + torch.arange(Tq, device=dev)
                blind = p - kw["window"] + 1 > Tk - 1
                if not (blind.any() and (got[0][:, blind] == 0).all()):
                    raise AssertionError("flash backward: a row that sees no key got a "
                                         "nonzero dQ")
            again = flash_attention_bwd.launch(q, k, v, out, do, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash backward {name} {dt}: two calls differ")
            cases += 1
    log(f"flash_attention_bwd: {cases} cases ({', '.join(c[0] for c in BWD_CASES)}; "
        f"float32 and bf16) within {BWD_F32_TOL} (f32, worst {worst[torch.float32]:.3g}) "
        f"and {BWD_BF16_TOL} (bf16, worst {worst[torch.bfloat16]:.3g}; the scalar first "
        f"design's {BWD_BF16_WORST_BEFORE[0]:.3g}) of max |g|; zero gradients on rows that "
        "see no key; two calls bitwise equal")

    B, T, nq, H = TRAIN_B, TRAIN_T, 16, 128
    q, k, v, do = (rand(B, T, nq, H) for _ in range(4))
    kw = dict(causal=True, window=0, q_offset=0)
    out = flash_attention.launch(q, k, v, **kw)
    last = {}

    def kernel():
        last["got"] = flash_attention_bwd.launch(q, k, v, out, do, **kw)

    def plain():
        last["want"] = ref.flash_attention_bwd_ref(q, k, v, do, **kw)

    ms = timer(kernel)
    plain_ms = timer(plain, iters=5)
    # The timed shape is the one training runs: its last timed call held
    # to the plain version's gradients, and a further call to its bits.
    train_err, abs_err = _bwd_close(torch, last["got"], last["want"], BWD_BF16_TOL,
                                    "training shape bf16")
    worst_abs = max(worst_abs, abs_err)
    worst[torch.bfloat16] = max(worst[torch.bfloat16], train_err)
    again = flash_attention_bwd.launch(q, k, v, out, do, **kw)
    if not all(torch.equal(a, b) for a, b in zip(last["got"], again)):
        raise AssertionError("flash backward at the training shape: two calls differ")
    solo = flash_attention_bwd.launch(*(t[3:4].contiguous() for t in (q, k, v, out, do)), **kw)
    if not all(torch.equal(a, b[3:4]) for a, b in zip(solo, again)):
        raise AssertionError("flash backward at the training shape: batch row 3 alone "
                             "differs from row 3 in the batch of 8")
    log(f"flash_attention_bwd at the training shape (B {B}, {nq} heads of {H}, T {T}, "
        f"causal, bf16): within {BWD_BF16_TOL} of max |g| (worst {train_err:.3g}; the "
        f"scalar first design's {BWD_BF16_WORST_BEFORE[1]:.3g}); two calls bitwise equal; "
        "batch row 3 alone bitwise row 3 of the batch")
    del last, again, solo
    F = torch.nn.functional
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2).contiguous()
    lib_ms = timer(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dos, retain_graph=True))
    del qs, ks, vs, lib_out, dos
    pairs = B * nq * (T * (T + 1) // 2)
    nbytes = 8 * q.numel() * 2          # q, k, v, O, dO read; dQ, dK, dV written
    b_ms, b_by = bound_ms(nbytes, 5 * 2 * pairs * H, BF16_FLOPS_PER_S)
    entries = {}
    # The frontend families' shapes: paligemma's prefill (B·NQ 32, MQA,
    # T 576, H 256, prefix-LM 256) and hubert's encoder (B·NQ 64, MHA,
    # T 500, H 80, bidirectional). Bound: q, O, dO read and dQ written at
    # q's size, k, v read and dK, dV written at k's, against five products
    # over the pairs the mask leaves visible. SDPA's backward with K/V
    # expanded to the query heads (the prefix-LM and window masks as a
    # boolean mask). Griffin's training shape: B 8, MQA 16/1, T 512, H 256.
    for name, (B2, T2, nq2, nkv2, H2, kw2) in {
            "prefix_lm": (4, 576, 8, 1, 256, dict(causal=True, window=0, q_offset=0,
                                                  prefix_len=256)),
            "bidirectional": (4, ENCODER_T, 16, 16, 80, dict(causal=False, window=0,
                                                            q_offset=0)),
            # Griffin's training step: MQA 16/1, H 256, its 2048-key window.
            "griffin_window": (TRAIN_B, TRAIN_T, 16, 1, 256, dict(causal=True, window=2048,
                                                                  q_offset=0))}.items():
        q2, do2 = rand(B2, T2, nq2, H2), rand(B2, T2, nq2, H2)
        k2, v2 = rand(B2, T2, nkv2, H2), rand(B2, T2, nkv2, H2)
        out2 = flash_attention.launch(q2, k2, v2, **kw2)
        last = {}

        def kernel2():
            last["got"] = flash_attention_bwd.launch(q2, k2, v2, out2, do2, **kw2)

        def plain2():
            last["want"] = ref.flash_attention_bwd_ref(q2, k2, v2, do2, **kw2)

        e_ms = timer(kernel2)
        e_plain = timer(plain2, iters=5)
        e_err, e_abs = _bwd_close(torch, last["got"], last["want"], BWD_BF16_TOL,
                                  f"{name} shape bf16")
        i = torch.arange(T2, device=dev)
        mask = ((i[None, :] <= i[:, None]) | (i[None, :] < kw2.get("prefix_len", 0))
                if kw2["causal"] else torch.ones(T2, T2, dtype=torch.bool, device=dev))
        if kw2["window"]:
            mask = mask & (i[None, :] > i[:, None] - kw2["window"])
        qs = q2.transpose(1, 2).contiguous().requires_grad_(True)
        ks, vs = (a.transpose(1, 2).expand(B2, nq2, T2, H2).contiguous().requires_grad_(True)
                  for a in (k2, v2))
        lib_out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask if kw2["causal"] else None)
        dos = do2.transpose(1, 2).contiguous()
        e_lib = timer(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dos,
                                                  retain_graph=True))
        e_pairs = B2 * nq2 * int(mask.sum())
        e_bms, e_bby = bound_ms(4 * q2.numel() * 2 + 4 * k2.numel() * 2,
                                5 * 2 * e_pairs * H2, BF16_FLOPS_PER_S)
        entries[name] = {"ms": e_ms, "plain_ms": e_plain, "library_ms": e_lib,
                         "bound_ms": e_bms, "bound_by": e_bby, "max_abs_err": e_abs,
                         "max_rel_err": e_err,
                         "shape": f"B*NQ={B2 * nq2} NKV={nkv2} T={T2} H={H2} "
                                  f"bf16 {name.replace('_', '-')}"}
        worst_abs = max(worst_abs, e_abs)
        del last, qs, ks, vs, lib_out, dos
    plan = flash_attention_bwd.bf16_plans()[H]
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "cases": cases, "max_abs_err": worst_abs,
            "max_rel_err": {"float32": worst[torch.float32],
                            "bfloat16": worst[torch.bfloat16]},
            "max_rel_err_before": {"bfloat16_cases": BWD_BF16_WORST_BEFORE[0],
                                   "bfloat16_train_shape": BWD_BF16_WORST_BEFORE[1]},
            "train_shape_rel_err": train_err, "plan_h128": plan, "entries": entries,
            "shape": f"B*NQ={B * nq} T={T} H={H} bf16 causal (dQ, dK, dV)"}


def check_grad_wrappers(torch, dev):
    """The autograd wrappers change no bit: olmo-1b at DEPTH's 4 layers
    (full width, bf16, seed 0) through ``forward_hidden`` on 2 x 256
    tokens, once with the params requiring grad (the flash and
    ``dense_matmul`` Functions, remat's checkpoints) and once under
    no_grad (the kernels called directly, as serving calls them): the
    hidden states bitwise equal, the forward launches equal, and no
    backward launch without a backward. Returns the launch counts."""
    import numpy as np

    from repro_torch import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, transformer

    cfg = serve_config("olmo-1b")
    params = build_model(cfg).init(seed=0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 256)))
    batch = {"tokens": toks.to(dev)}
    counts = {}
    hidden = {}
    for mode in ("no_grad", "grad"):
        ops.reset_launch_counts()
        if mode == "grad":
            live = tr.map_tree(lambda p: p.detach().requires_grad_(True), params)
            with torch.enable_grad():
                hidden[mode] = transformer.forward_hidden(live, cfg, batch).detach()
        else:
            with torch.no_grad():
                hidden[mode] = transformer.forward_hidden(params, cfg, batch)
        torch.cuda.synchronize()
        counts[mode] = ops.launch_counts()
    if not torch.equal(hidden["grad"], hidden["no_grad"]):
        raise AssertionError("forward_hidden with params requiring grad differs from "
                             "no_grad")
    if counts["grad"] != counts["no_grad"] or counts["grad"]["flash_attention_bwd"]:
        raise AssertionError(f"the wrappers changed the forward's launches: {counts}")
    log(f"autograd wrappers: olmo-1b ({cfg.num_layers} layers) forward_hidden bitwise "
        f"with and without grad; launches {counts['grad']['flash_attention']} flash, "
        f"{counts['grad']['dense_matmul']} dense_matmul, 0 backward, both ways")
    return counts["grad"]


# check_dense_backward: olmo-1b's FFN products at the training shape
# (8 x 512 tokens), each way. Tolerance relative to max |g| of the float64
# reference: the gradients are bf16 products summed in float32 and
# rounded once to bf16 (2^-9 of an element), cuBLAS's split-K may sum
# partials in bf16.
DENSE_BWD_KN = ((2048, 8192), (8192, 2048))
DENSE_BWD_TOL = 2e-2


def check_dense_backward(torch, dev):
    """``ops.dense_matmul`` under autograd (``DenseMatmul``: the kernel
    forward, ``torch.matmul`` gradients) at M = TRAIN_B x TRAIN_T tokens
    and each (K, N) of DENSE_BWD_KN, bf16, with the bf16 store and the
    float32 store (its float32 gradient branch): y, dX and dW within
    DENSE_BWD_TOL of max |ref| of autograd through ``x.double() @
    w.double()`` on the same x, w and incoming gradient; dX and dW in the
    inputs' dtype; one kernel launch each. Returns the worst relative
    error by store."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(43)
    M = TRAIN_B * TRAIN_T
    worst = {}
    for K, N in DENSE_BWD_KN:
        xb = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        wb = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        g = torch.randn((M, N), generator=gen, device=dev)
        xd, wd = (t.detach().double().requires_grad_(True) for t in (xb, wb))
        yd = xd @ wd
        want = (yd.detach(), *torch.autograd.grad(yd, (xd, wd), g.double()))
        for store in (torch.bfloat16, torch.float32):
            x, w = (t.detach().requires_grad_(True) for t in (xb, wb))
            ops.reset_launch_counts()
            y = ops.dense_matmul(x, w, out_dtype=store)
            got = (y.detach(), *torch.autograd.grad(y, (x, w), g.to(store)))
            n = ops.launch_counts()["dense_matmul"]
            what = f"dense_matmul backward M={M} {K}->{N} store {store}"
            # y is the Function's output reshaped: its grad_fn is a view of it.
            fns = [y.grad_fn, *(f for f, _ in y.grad_fn.next_functions if f is not None)]
            if n != 1 or not any("DenseMatmul" in type(f).__name__ for f in fns):
                raise AssertionError(f"{what}: {n} launches, grad_fns {fns}")
            if (y.dtype, got[1].dtype, got[2].dtype) != (store, x.dtype, w.dtype):
                raise AssertionError(f"{what}: dtypes {y.dtype}, {got[1].dtype}, "
                                     f"{got[2].dtype}")
            for name, a, b in zip(("y", "dx", "dw"), got, want):
                err = (a.double() - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                if not err <= DENSE_BWD_TOL:
                    raise AssertionError(f"{what}: {name} max |err| {err:.3g} of max |ref| "
                                         f"beyond {DENSE_BWD_TOL}")
                worst[str(store)] = max(worst.get(str(store), 0.0), err)
    log(f"dense_matmul under autograd: y, dX, dW at M={M}, {DENSE_BWD_KN}, bf16 and "
        f"float32 stores, within {DENSE_BWD_TOL} of max |ref| of float64 autograd "
        f"(worst {worst})")
    return worst


# -- training (slice 19): the recurrences' backward kernels ------------------

# check_wkv6_backward: tolerances relative to max |g| of the plain version's
# gradient. dr, dk, dv are stored in r's dtype: bf16 rounds an element to
# 2^-9 of itself (2e-3), float32 parts by summation order (1e-4). dw =
# d(log w) / w: a rounding of d(log w) comes out multiplied by 1/w (1e6 at
# w = 1e-6, where the plain versions in float32, JAX's too, part from
# float64 by 0.03-0.1 of max |dw|), and the model multiplies dw by w again
# (w = exp(-exp(x))), so dw is held as w dw = d(log w).
WKV_BWD_TOL = {"bf16": 1e-2, "f32": 1e-4}
# (name, B, T, H, K (= V), chunk, dtype, least decay, carried state and dstate).
WKV_BWD_CASES = (
    ("rwkv6-3b training shape", TRAIN_B, TRAIN_T, 40, 64, 64, "bf16", 1e-2, False),
    ("T 300, no multiple of the chunk", 2, 300, 8, 64, 64, "bf16", 1e-2, False),
    ("carried state and dstate_out", 2, 200, 8, 64, 64, "f32", 1e-2, True),
    ("decays 1e-6 to 1", 2, 256, 8, 64, 64, "f32", 1e-6, True),
    ("B 1", 1, TRAIN_T, 40, 64, 64, "bf16", 1e-2, False),
)


def _grad_errs(torch, names, got, want, what, tol_of):
    """{name: max |err| / max |g|} of each gradient pair, raising where one
    is not finite or passes its tolerance (tol_of(name))."""
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: {name} not finite")
        errs[name] = ((g.float() - w.float()).abs().max()
                      / w.float().abs().max().clamp_min(1e-30)).item()
        if not errs[name] <= tol_of(name):
            raise AssertionError(f"{what}: {name} max |err| {errs[name]:.3g} of max |g| "
                                 f"beyond {tol_of(name)}")
    return errs


def check_wkv6_backward(torch, dev, timer):
    """``wkv6_bwd`` against its plain version (``ref.wkv6_chunked_bwd_ref``
    over the plain forward's chunk-start states) on the card, every case
    of WKV_BWD_CASES (rwkv6-3b's training shape, B 8, T 512, H 40, K = V =
    64, chunk 64, bf16 r/k/v; a T no multiple of the chunk; a carried
    state with dstate_out; decays down to 1e-6; B 1): dr, dk, dv, d(log w)
    = w dw, du and dstate_in within WKV_BWD_TOL of max |g|; a further call
    bitwise; batch row 0 alone bitwise row 0 of the batch (every gradient
    but du, which sums the rows). Timed at the training shape. Returns
    the kernel-table row."""
    from repro_torch.kernels import ref, wkv6

    gen = torch.Generator(device=dev).manual_seed(47)
    names = ("dr", "dk", "dv", "dlogw", "du", "dstate")
    worst, worst_abs, row = {}, 0.0, None
    for name, B, T, H, K, C, dt, wlo, carried in WKV_BWD_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        r, k, v = (torch.randn((B, T, H, K), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        w = torch.exp(torch.rand((B, T, H, K), generator=gen, device=dev) * math.log(wlo))
        u = torch.randn((H, K), generator=gen, device=dev) * 0.5
        s0 = (torch.randn((B, H, K, K), generator=gen, device=dev) if carried
              else torch.zeros((B, H, K, K), device=dev))
        do = torch.randn((B, T, H, K), generator=gen, device=dev)
        ds = torch.randn((B, H, K, K), generator=gen, device=dev) if carried else None
        _, _, st = wkv6.launch(r, k, v, w, u, s0, chunk=C, states=True)
        _, _, pst = ref.wkv6_chunked_ref(r, k, v, w, u, s0, C, return_states=True)
        last = {}

        def kernel():
            last["got"] = wkv6.launch_bwd(r, k, v, w, u, st, do, ds, chunk=C)

        def plain():
            last["want"] = ref.wkv6_chunked_bwd_ref(r, k, v, w, u, pst, do, ds, C)

        kernel()
        plain()
        if name == "rwkv6-3b training shape":
            ms, plain_ms = timer(kernel), timer(plain, iters=3, warmup=1)
            launches_ms = device_ms_by_group(torch, kernel, WKV_BWD_LAUNCHES)
        got, want = list(last["got"]), list(last["want"])
        got[3], want[3] = got[3] * w, want[3] * w
        errs = _grad_errs(torch, names, got, want, f"wkv6_bwd {name}",
                          lambda n: WKV_BWD_TOL[dt if n in ("dr", "dk", "dv") else "f32"])
        for n, e in errs.items():
            worst[n] = max(worst.get(n, 0.0), e)
        worst_abs = max(worst_abs, *((a.float() - b.float()).abs().max().item()
                                     for a, b in zip(got, want)))
        again = wkv6.launch_bwd(r, k, v, w, u, st, do, ds, chunk=C)
        if not all(torch.equal(a, b) for a, b in zip(last["got"], again)):
            raise AssertionError(f"wkv6_bwd {name}: two calls differ")
        if B > 1:
            one = [t[:1].contiguous() for t in (r, k, v, w)]
            solo = wkv6.launch_bwd(*one, u, st[:1].contiguous(), do[:1].contiguous(),
                                   None if ds is None else ds[:1].contiguous(), chunk=C)
            if not all(torch.equal(a, b[:1]) for i, (a, b) in enumerate(zip(solo, again))
                       if i != 4):
                raise AssertionError(f"wkv6_bwd {name}: row 0 alone differs from row 0 "
                                     "of the batch")
        del last, again
    # Bound at the training shape: r, k, v read in bf16, w, dout and the
    # chunk-start states in float32; dr, dk, dv written in bf16, dw and
    # dstate_in in float32. Operations, float32 a chunk and head: the
    # products A = dout v^T (C^2 V), dout S^T, v G^T, khat G, rhat^T dout
    # (4 C K V), P^T dout (C^2 V / 2) and the gated sums dr, dk, P (3 C^2
    # K / 2), two each, and one exp a gate in each of the two walks.
    B, T, H, K, C = TRAIN_B, TRAIN_T, 40, 64, 64
    nc = -(-T // C)
    elems = B * T * H * K
    nbytes = 3 * 2 * elems + 2 * 4 * elems + 4 * B * H * nc * K * K \
        + 3 * 2 * elems + 4 * elems + 4 * B * H * K * K
    per = 2 * (C * C * K + 4 * C * K * K + C * C * K // 2 + 3 * C * C * K // 2) + C * C * K
    b_ms, b_by = bound_ms(nbytes, B * H * nc * per, FP32_FLOPS_PER_S)
    launch_bounds = wkv6_bwd_launch_bounds(B, T, H, K, C)
    log(f"wkv6_bwd: {len(WKV_BWD_CASES)} cases ({', '.join(c[0] for c in WKV_BWD_CASES)}) "
        f"within {WKV_BWD_TOL} of max |g| (worst {worst}); two calls bitwise equal; row 0 "
        "alone bitwise row 0 of the batch; at the training shape, device ms a launch "
        f"(torch.profiler): {launches_ms}, each launch's bound: {launch_bounds}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst_abs, "max_rel_err": worst,
            "cases": len(WKV_BWD_CASES), "launches_ms": launches_ms,
            "launch_bounds": launch_bounds,
            "shape": f"B={B} T={T} H=40 K=V=64 chunk 64, bf16 r/k/v (dr, dk, dv, dw, du, "
                     "dstate)"}


# check_rglru_backward: tolerances relative to max |g| of the plain version.
# The kernel recomputes the forward's a bit for bit and rounds every
# operation on its own, as the plain version's float32 ops do; the three
# (W,) gradients sum over B T in another order.
RGLRU_BWD_TOL = 1e-4
# (name, B, T, W, carried h0, the range of Lambda).
RGLRU_BWD_CASES = (
    ("Griffin training shape, zero h0", TRAIN_B, TRAIN_T, 4096, False, (-3.0, 3.0)),
    ("carried h0", TRAIN_B, TRAIN_T, 4096, True, (-3.0, 3.0)),
    ("Lambda near the clamp (a -> 1)", 2, 300, 4096, True, (-30.0, -8.0)),
)


def check_rglru_backward(torch, dev, timer):
    """``rglru_bwd`` against its plain version (``ref.rglru_scan_bwd_ref``
    over the plain forward's h) on the card, every case of
    RGLRU_BWD_CASES (Griffin's training shape, B 8, T 512, W 4096, bf16
    y, with zero and with carried h0; Lambda from -30 to -8, where 1 - a²
    reaches the 1e-12 clamp): dga, dgi, dy, the three (W,) gradients and
    dh0 within RGLRU_BWD_TOL of max |g|; a further call bitwise; batch row
    0 alone bitwise row 0 of the batch (every gradient but the (W,) sums);
    between them the cases run every tile plan of ``rglru.BWD_PLANS``.
    Timed at the training shape with zero h0, beside ``copy_ms``, one
    device-to-device copy moving its bytes under the same timer. Returns
    the kernel-table row."""
    from repro_torch.kernels import ref, rglru

    gen = torch.Generator(device=dev).manual_seed(53)
    names = ("dga", "dgi", "dy", "da_bias", "di_bias", "dlam", "dh0")
    worst, worst_abs, plans = {}, 0.0, set()
    sms = rglru.sms(dev.index or 0)
    for name, B, T, W, carried, (lo, hi) in RGLRU_BWD_CASES:
        plans.update({rglru.plan_bwd(B, W, sms), rglru.plan_bwd(1, W, sms)})
        ga, gi = (torch.randn((B, T, W), generator=gen, device=dev) for _ in range(2))
        y = torch.randn((B, T, W), generator=gen, device=dev).to(torch.bfloat16)
        ab, ib = (torch.randn(W, generator=gen, device=dev) * 0.1 for _ in range(2))
        lam = lo + (hi - lo) * torch.rand(W, generator=gen, device=dev)
        h0 = torch.randn((B, W), generator=gen, device=dev) if carried else None
        dh = torch.randn((B, T, W), generator=gen, device=dev)
        h, _ = rglru.launch(ga, gi, y, ab, ib, lam, h0)
        ph, _ = ref.rglru_scan_ref(ga, gi, y, ab, ib, lam, h0)
        last = {}

        def kernel():
            last["got"] = rglru.launch_bwd(ga, gi, y, ab, ib, lam, h0, h, dh)

        def plain():
            last["want"] = ref.rglru_scan_bwd_ref(ga, gi, y, ab, ib, lam, h0, ph, dh)

        kernel()
        plain()
        if name == RGLRU_BWD_CASES[0][0]:
            ms, plain_ms = timer(kernel), timer(plain, iters=5)
        errs = _grad_errs(torch, names, last["got"], last["want"], f"rglru_bwd {name}",
                          lambda n: RGLRU_BWD_TOL)
        for n, e in errs.items():
            worst[n] = max(worst.get(n, 0.0), e)
        worst_abs = max(worst_abs, *((a.float() - b.float()).abs().max().item()
                                     for a, b in zip(last["got"], last["want"])
                                     if a is not None))
        again = rglru.launch_bwd(ga, gi, y, ab, ib, lam, h0, h, dh)
        if not all(a is None or torch.equal(a, b) for a, b in zip(last["got"], again)):
            raise AssertionError(f"rglru_bwd {name}: two calls differ")
        one = [t[:1].contiguous() for t in (ga, gi, y)]
        solo = rglru.launch_bwd(*one, ab, ib, lam, None if h0 is None else h0[:1].contiguous(),
                                h[:1].contiguous(), dh[:1].contiguous())
        if not all(a is None or torch.equal(a, b[:1])
                   for i, (a, b) in enumerate(zip(solo, again)) if i not in (3, 4, 5)):
            raise AssertionError(f"rglru_bwd {name}: row 0 alone differs from row 0 of "
                                 "the batch")
        del last, again
    if plans != set(rglru.BWD_PLANS):
        raise AssertionError(f"rglru_bwd: the cases ran plans {sorted(plans)}, not every "
                             f"plan the kernel instantiates {sorted(rglru.BWD_PLANS)}")
    B, T, W = TRAIN_B, TRAIN_T, 4096
    n = B * T * W
    # ga, gi, h, dh read in float32 and y in bf16; dga, dgi written in
    # float32 and dy in bf16 (28 bytes an element); ~40 float32 operations
    # an element.
    b_ms, b_by = bound_ms(28 * n, 40 * n, FP32_FLOPS_PER_S)
    copy_ms = copy_time(torch, dev, timer, 28 * n)
    log(f"rglru_bwd: {len(RGLRU_BWD_CASES)} cases ({', '.join(c[0] for c in RGLRU_BWD_CASES)}) "
        f"within {RGLRU_BWD_TOL} of max |g| (worst {worst}); two calls bitwise equal; row 0 "
        "alone bitwise row 0 of the batch")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst_abs, "max_rel_err": worst,
            "cases": len(RGLRU_BWD_CASES), "copy_ms": copy_ms,
            "plans": sorted(plans),
            "shape": f"B={B} T={T} W={W}, f32 gates, bf16 y, zero h0 (dga, dgi, dy, the "
                     "(W,) gradients)"}


# -- training (slice 23): the MoE layers' gradient ------------------------------

# check_expert_backward: tolerance relative to max |g| of the plain version
# (float32 sums of the same bf16 operands, rounded once to bf16): the
# kernel's wgmma sums in fp32 in another order, and its outputs round to
# bf16 (2^-9 of an element).
EXPERT_BWD_TOL = 2e-2
# (name, E, tokens, top-k, K, N): the training shapes of 8 x 512 tokens
# (mixtral's gate/up and down products; llama4's gate/up, at full width
# alone, since its layer does not train on one card), and a sparse case:
# 4 live experts of 128 at cap 8 (tokens None).
EXPERT_BWD_CASES = (("mixtral_train_gate", 8, 4096, 2, 6144, 16384),
                    ("mixtral_train_down", 8, 4096, 2, 16384, 6144),
                    ("llama4_train_gate", 128, 4096, 1, 5120, 8192),
                    ("llama4_sparse_4_live", 128, None, 1, 5120, 8192))
# Experts a plain-version call takes at once (its float32 copies of W and
# dW for 128 experts would not fit beside the bf16 ones).
EXPERT_BWD_PLAIN_ELEMS = 1 << 28


def _plain_expert_bwd(xe, w, dy, counts):
    """``ref.expert_matmul_bwd_ref`` over slices of the experts (each at
    most EXPERT_BWD_PLAIN_ELEMS of W): yields (slice, dx, dw) a slice."""
    from repro_torch.kernels import ref

    E, _, K = xe.shape
    step = max(1, EXPERT_BWD_PLAIN_ELEMS // (K * w.shape[2]))
    for i in range(0, E, step):
        s = slice(i, i + step)
        yield (s, *ref.expert_matmul_bwd_ref(xe[s], w[s], dy[s], counts[s]))


def check_expert_backward(torch, dev, timer):
    """The backward of the grouped expert product (``launch_dx``,
    ``launch_dw``) at EXPERT_BWD_CASES: dX and dW within EXPERT_BWD_TOL of
    max |g| of the plain version (``ref.expert_matmul_bwd_ref``, in slices
    of experts); each launch repeated, bitwise; dX zero past each count and
    dW zero for an expert with count 0; NaN in the rows of xe and dy past
    the counts changes no bit of either (the mask is the kernel's own: the
    first call's rows there hold random finite values). Times each case
    (both launches, CUDA events, L2 flushed) beside its bound (the kept
    rows, the touched experts' weights and both outputs, or the kept rows'
    operations at the bf16 peak), the plain version and ``torch.bmm`` over
    the whole buffer (both products: the library call), with the card.
    Returns the mixtral gate case with every case under ``entries``."""
    from repro_torch.kernels import expert_matmul
    from repro_torch.models.moe import capacity

    smi = nvidia_smi()
    gen = torch.Generator(device=dev).manual_seed(35)
    cpu_gen = torch.Generator().manual_seed(35)
    entries, worst = {}, 0.0
    w, w_key = None, None
    for name, E, tokens, k, K, N in EXPERT_BWD_CASES:
        if tokens is None:
            cap = 8
            counts = torch.zeros(E, dtype=torch.int32)
            live_e = torch.randperm(E, generator=cpu_gen)[:4]
            counts[live_e] = torch.tensor([8, 5, 1, 3], dtype=torch.int32)
            counts = counts.to(dev)
        else:
            cap = capacity(tokens, k, E, 1.25)
            counts = _expert_counts(torch, cpu_gen, E, tokens, k, skew=True).to(dev)
        kept = counts.clamp(max=cap)
        if w_key != (E, K, N):
            w = None
            w = torch.randn((E, K, N), generator=gen, device=dev,
                            dtype=torch.bfloat16) * K ** -0.5
            w_key = (E, K, N)
        xe = torch.randn((E, cap, K), generator=gen, device=dev, dtype=torch.bfloat16)
        dy = torch.randn((E, cap, N), generator=gen, device=dev, dtype=torch.bfloat16)
        live = torch.arange(cap, device=dev)[None, :] < kept[:, None]
        what = f"expert_matmul_bwd {name} E={E} cap={cap} {K}->{N}"
        dx = expert_matmul.launch_dx(dy, w, counts)
        dw = expert_matmul.launch_dw(xe, dy, counts)
        again = (expert_matmul.launch_dx(dy, w, counts), expert_matmul.launch_dw(xe, dy, counts))
        nan = torch.tensor(float("nan"), dtype=torch.bfloat16, device=dev)
        xn, dn = (torch.where(live[..., None], t, nan) for t in (xe, dy))
        masked = (expert_matmul.launch_dx(dn, w, counts), expert_matmul.launch_dw(xn, dn, counts))
        del xn, dn
        torch.cuda.synchronize()
        if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
            raise AssertionError(f"{what}: a repeated launch is not bitwise the first")
        if not (torch.equal(dx, masked[0]) and torch.equal(dw, masked[1])):
            raise AssertionError(f"{what}: NaN in the rows past the counts changed dX or dW")
        del again, masked
        if (dx[~live] != 0).any():
            raise AssertionError(f"{what}: dX rows past the count are not zero")
        empty = (kept == 0).nonzero().flatten().tolist()
        if any(dw[e].count_nonzero() for e in empty):
            raise AssertionError(f"{what}: an expert with count 0 has a nonzero dW")
        # max |kernel - plain| and max |plain| of each gradient, a slice of
        # experts at a time.
        diff, scale = {"dx": 0.0, "dw": 0.0}, {"dx": 0.0, "dw": 0.0}
        for sl, rdx, rdw in _plain_expert_bwd(xe, w, dy, counts):
            for g_name, got, want in (("dx", dx[sl], rdx), ("dw", dw[sl], rdw)):
                want = want.float()
                diff[g_name] = max(diff[g_name], (got.float() - want).abs().max().item())
                scale[g_name] = max(scale[g_name], want.abs().max().item())
        errs = {k: diff[k] / max(scale[k], 1e-30) for k in diff}
        abs_err = max(diff.values())
        for g_name, err in errs.items():
            if not err <= EXPERT_BWD_TOL:
                raise AssertionError(f"{what}: {g_name} max |err| {err:.3g} of max |g| beyond "
                                     f"{EXPERT_BWD_TOL}")
        worst = max(worst, *errs.values())
        del dx, dw
        n_kept, touched = int(kept.sum()), int((kept > 0).sum())
        ops_ = 2 * 2 * n_kept * K * N
        nbytes = 2 * (2 * n_kept * N + touched * K * N + E * cap * K     # dX
                      + n_kept * K + E * K * N)                          # dW
        b_ms, b_by = bound_ms(nbytes, ops_, BF16_FLOPS_PER_S)
        sx = expert_matmul.schedule_dx(E, cap, K, N)
        sw = expert_matmul.schedule_dw(E, cap, K, N)
        entries[name] = {
            "ms": timer(lambda: (expert_matmul.launch_dx(dy, w, counts),
                                 expert_matmul.launch_dw(xe, dy, counts))),
            "dx_ms": timer(lambda: expert_matmul.launch_dx(dy, w, counts)),
            "dw_ms": timer(lambda: expert_matmul.launch_dw(xe, dy, counts)),
            "plain_ms": timer(lambda: [None for _ in _plain_expert_bwd(xe, w, dy, counts)],
                              iters=5),
            "library_ms": timer(lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                         torch.bmm(xe.transpose(1, 2), dy)), iters=5),
            "library": "torch.bmm over the whole buffer, dX and dW",
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": abs_err,
            "rel_err": errs, "kept_rows": n_kept, "touched_experts": touched,
            "schedule": {"dx": sx._asdict(), "dw": sw._asdict()}, "nvidia_smi": smi,
            "shape": f"E={E} cap={cap} kept rows {n_kept} in {touched} experts {K}->{N} bf16, "
                     "dX and dW"}
        e = entries[name]
        log(f"  expert_matmul_bwd {name}: {e['ms']:.4g} ms (dX {e['dx_ms']:.4g}, dW "
            f"{e['dw_ms']:.4g}; bound {b_ms:.3g} ms by {b_by}, plain {e['plain_ms']:.4g} ms, "
            f"torch.bmm {e['library_ms']:.4g} ms); err dX {errs['dx']:.3g} dW "
            f"{errs['dw']:.3g} of max |g| [{smi}]")
        del xe, dy
    del w
    torch.cuda.empty_cache()
    log(f"expert_matmul_bwd: {len(EXPERT_BWD_CASES)} cases within {EXPERT_BWD_TOL} of max |g| "
        f"of the plain version (worst {worst:.3g}); every launch repeated bitwise; dX zero "
        f"past the counts, dW zero for an empty expert; NaN past the counts changes no bit")
    return {**entries["mixtral_train_gate"], "entries": entries}


def _routes(torch, seen):
    """``moe.route`` wrapped to record every call's top-k indices and
    probabilities (on the CPU) into `seen`; use as ``_swapped(moe, "route",
    _routes(torch, seen))``."""
    from repro_torch.models import moe

    route = moe.route

    def recording(xt, router, cfg):
        r = route(xt, router, cfg)
        with torch.no_grad():
            probs = torch.softmax(xt.float() @ router.float(), dim=-1)
        seen.append((r.gate_idx.cpu(), probs.cpu()))
        return r
    return recording


def _flips(torch, a, b, limit=8):
    """Tokens whose top-k choice differs between two recorded routings (a
    list of (indices, probs) a call each): (call, token, the choices and
    each side's two largest probabilities)."""
    out = []
    for call, ((ia, pa), (ib, pb)) in enumerate(zip(a, b)):
        for t in (ia != ib).any(dim=-1).nonzero().flatten().tolist()[:limit]:
            out.append({"call": call, "token": t, "experts": [ia[t].tolist(), ib[t].tolist()],
                        "top2_probs": [pa[t].topk(2).values.tolist(),
                                       pb[t].topk(2).values.tolist()]})
    return out


def check_moe_layer_grads(torch, dev):
    """One full-width bf16 mixtral-8x22b MoE layer (seed 7) under autograd
    on TRAIN_B x TRAIN_T tokens: every leaf's gradient (the router, the
    three expert leaves, x) of sum(out * g) + aux through the kernels (the
    ``ExpertMatmul`` Function: three forward launches, six backward ones)
    within EXPERT_BWD_TOL of max |g| of the same call with
    ``ops.expert_matmul`` swapped for its plain version (autograd through
    ``ref.expert_matmul_ref``). Both calls route through the same float32
    router on the same x before any expert product, so they route alike.
    Returns the relative error by leaf."""
    from repro_torch import tree as tr
    from repro_torch.kernels import ops, ref
    from repro_torch.models import common as cm
    from repro_torch.models import moe

    cfg = _train_cfg(MIXTRAL)
    dev = torch.device(dev)
    stacked = moe.init_moe(cm.generator(dev, 7), cfg, torch.bfloat16, dev, 1)
    layer = {k: v[0] if isinstance(v, torch.Tensor) else {n: t[0] for n, t in v.items()}
             for k, v in stacked.items()}
    gen = torch.Generator(device=dev).manual_seed(36)
    x = torch.randn((TRAIN_B, TRAIN_T, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=dev, dtype=torch.bfloat16)

    def grads():
        live = tr.map_tree(lambda t: t.detach().requires_grad_(True), layer)
        xl = x.detach().requires_grad_(True)
        out, aux = moe.moe_apply(live, xl, cfg)
        loss = (out.float() * g.float()).sum() + aux
        return torch.autograd.grad(loss, [*tr.leaves(live), xl])

    names = [tr.path_str(p) for p, _ in tr.flatten_with_path(layer)] + ["x"]
    ops.reset_launch_counts()
    card = grads()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with _swapped(ops, "expert_matmul",
                  lambda xe, w, c, backend=None: ref.expert_matmul_ref(xe, w, c)):
        plain = grads()
    torch.cuda.synchronize()
    if (counts["expert_matmul"], counts["expert_matmul_bwd"]) != (3, 6):
        raise AssertionError(f"mixtral MoE layer under autograd: launches {counts}")
    errs = {}
    for name, a, b in zip(names, card, plain):
        errs[name] = (a.float() - b.float()).abs().max().item() / max(
            b.float().abs().max().item(), 1e-30)
    bad = {k: v for k, v in errs.items() if not v <= EXPERT_BWD_TOL}
    if bad:
        raise AssertionError(f"mixtral MoE layer: gradients beyond {EXPERT_BWD_TOL} of max "
                             f"|g| of the plain call: {bad}")
    log(f"{MIXTRAL} MoE layer (full width, bf16, {TRAIN_B}x{TRAIN_T} tokens) under autograd: "
        f"every leaf's gradient through expert_matmul / expert_matmul_bwd within "
        f"{EXPERT_BWD_TOL} of max |g| of the plain call ({errs}); launches 3 forward, "
        f"6 backward")
    del card, plain, layer
    torch.cuda.empty_cache()
    return errs


def _train_cfg(arch, reduced=False, qat=None, **over):
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core.precision import parse_quant_token

    cfg = (get_reduced_config if reduced else get_config)(arch)
    cfg = dataclasses.replace(cfg, **over)
    return cfg.with_quant(parse_quant_token(qat)) if qat else cfg


# card_vs_cpu_train tolerances (relative, per step; params absolute, over
# leaves): plain float32 differs by summation order only. Under QAT an
# activation a sum moves across a rounding boundary is one code apart
# (PERF.md §6; JAX's own scanned and unscanned steps part so), and AdamW
# moves each parameter by about lr (at most 1e-2 here) whatever its
# gradient's size, so the QAT params are held by their mean |difference|,
# a quarter of lr. The recurrent families' gradients near zero by
# cancellation (rwkv6's squared-ReLU channel mix) are normalized each by
# its own size in AdamW's first step: on the CPU, against JAX, some
# elements part by up to 5e-4 after it and the next grad norm by 4.4e-4
# (tests/test_torch_train.py), and on the card an element whose gradient
# changed sign took its step the other way (1.16e-2 apart, mean 1.1e-6,
# on an H100 80GB HBM3 at 700 W). So their grad norm is held within 1e-3,
# every param within 2 lr and the mean |difference| within 1e-5.
TRAIN_TOL = {"plain": {"loss": 1e-5, "grad_norm": 1e-4, "params_max": 1e-3},
             "w4a8": {"loss": 2e-3, "grad_norm": 5e-2, "params_mean": 2.5e-3},
             "recurrent": {"loss": 1e-5, "grad_norm": 1e-3, "params_max": 2e-2,
                           "params_mean": 1e-5}}
# (arch, TRAIN_TOL key, --qat) of card_vs_cpu_train.
TRAIN_PARITY = (("olmo-1b", "plain", None), ("olmo-1b", "w4a8", "w4a8"),
                ("rwkv6-3b", "recurrent", None), (GRIFFIN, "recurrent", None),
                (MIXTRAL, "plain", None), (LLAMA4, "plain", None))
# The recurrent rows' watch: a param element that parts by more than the
# plain row's params_max is named. Its first step's gradient must lie
# within NEAR_ZERO_ULPS ulps of zero on both devices (ulps of the largest
# |gradient| of its leaf on that device), and at the first step where its
# gradient is not zero on either device the two signs must differ: AdamW's
# first update of an element (m and v still zero) is a whole step whatever
# the gradient's size, so opposite signs part it by about twice the lr.
NEAR_ZERO_ULPS = 8


def _ulp(x: float) -> float:
    """The spacing of float32 numbers at |x| (x normal)."""
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 24)


def _step_grads(torch, model, params, batch):
    """The loss's gradient at `params` for `batch` (a training step's),
    one CPU tensor a leaf."""
    from repro_torch import tree as tr

    flat = tr.leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in flat]
        loss, _ = model.train_loss(tr.unflatten_like(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return [torch.zeros(p.shape) if g is None else g.detach().float().cpu()
            for p, g in zip(flat, grads)]


def _named_elements(torch, base, pc, pg, gc, gg, limit):
    """Every element of the params `pc` (CPU) and `pg` (card) apart by
    more than `limit`, with its gradient at each step on each device
    (`gc`, `gg`: a list of leaves a step) in ulps of its leaf's largest,
    and whether the two gradients' signs differ there. Returns (the list,
    the largest difference over the other elements)."""
    from repro_torch import tree as tr

    paths = [tr.path_str(p) for p, _ in tr.flatten_with_path(base)]
    named, rest = [], 0.0
    for li, (path, a, b) in enumerate(zip(paths, pc, pg)):
        diff = (a.float() - b.float()).abs()
        over = diff > limit
        rest = max(rest, diff[~over].max().item() if (~over).any() else 0.0)
        for idx in over.nonzero().tolist():
            i, steps = tuple(idx), []
            for ga, gb in zip(gc, gg):
                x, y = ga[li][i].item(), gb[li][i].item()
                steps.append({"grad_cpu": x, "grad_card": y,
                              "ulps_cpu": abs(x) / _ulp(ga[li].abs().max().item() or 1.0),
                              "ulps_card": abs(y) / _ulp(gb[li].abs().max().item() or 1.0),
                              "signs_differ": (x > 0) - (x < 0) != (y > 0) - (y < 0)})
            named.append({"leaf": path, "index": list(i), "diff": diff[i].item(),
                          "steps": steps})
    return named, rest


def card_vs_cpu_train(torch):
    """Reduced models in float32, 3 steps of ``make_train_step`` (batch 4
    x 64 from the data pipeline, lr 1e-2, warmup 2) on the card and on the
    CPU from the same weights: olmo-1b plain and under ``--qat w4a8``,
    rwkv6-3b and recurrentgemma-9b plain (their recurrences' backward
    kernels, Griffin's windowed flash backward), the MoE decoders
    mixtral-8x22b and llama4-maverick plain (the router's aux loss in the
    loss; the experts on ``torch.einsum`` in float32); losses, grad norms
    and params within TRAIN_TOL; a row that parts names every token routed
    to other experts on the two devices. The recurrent rows also name every param
    element apart by more than the plain row's params_max (1e-3): each
    one's first-step gradient within NEAR_ZERO_ULPS of zero on both
    devices, and its first nonzero gradient of opposite signs on the two;
    every other element within 1e-3. Returns "arch mode" → errors."""
    from repro_torch import tree as tr
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataIterator
    from repro_torch.models import build_model, moe
    from repro_torch.train.loop import init_train_state, make_train_step

    out = {}
    for arch, mode, qat in TRAIN_PARITY:
        cfg = _train_cfg(arch, reduced=True, qat=qat, dtype="float32")
        model = build_model(cfg)
        tc = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=30)
        data = DataIterator(cfg, global_batch=4, seq_len=64, seed=0, branch=4)
        base = model.init(seed=0, device="cpu")
        runs, grads, routes = {}, {}, {}
        for dev in ("cpu", "cuda"):
            # The optimizer updates in place: each device starts from a copy.
            state = init_train_state(tr.map_tree(lambda t: t.to(dev, copy=True), base), tc)
            step = make_train_step(model, tc)
            mets, grads[dev], routes[dev] = [], [], []
            for i in range(3):
                if mode == "recurrent":
                    grads[dev].append(_step_grads(torch, model, state.params, data.batch_at(i)))
                with _swapped(moe, "route", _routes(torch, routes[dev])):
                    state, m = step(state, data.batch_at(i))
                mets.append((float(m["loss"]), float(m["grad_norm"])))
            runs[dev] = (mets, [p.detach().cpu() for p in tr.leaves(state.params)])
        tol = TRAIN_TOL[mode]
        (mc, pc), (mg, pg) = runs["cpu"], runs["cuda"]
        per_leaf = [(a - b).abs().max().item() for a, b in zip(pc, pg)]
        err = {"loss": max(abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(mc, mg)),
               "grad_norm": max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(mc, mg)),
               "params_max": max(per_leaf),
               "params_mean": max((a - b).abs().mean().item() for a, b in zip(pc, pg)),
               "params_max_leaf": tr.path_str(
                   tr.flatten_with_path(base)[per_leaf.index(max(per_leaf))][0])}
        out[f"{arch} {mode}"] = err
        bad = [k for k, t in tol.items() if not err[k] <= t]
        if bad:
            raise AssertionError(f"reduced fp32 {arch} training ({mode}): card vs CPU "
                                 f"{err} beyond {tol}; tokens routed to other experts: "
                                 f"{_flips(torch, routes['cpu'], routes['cuda'])}")
        if mode == "recurrent":
            limit = TRAIN_TOL["plain"]["params_max"]
            named, rest = _named_elements(torch, base, pc, pg, grads["cpu"], grads["cuda"],
                                          limit)
            err.update(named=named, params_max_other=rest)
            def explained(e):
                first = e["steps"][0]
                moved = [st for st in e["steps"] if st["grad_cpu"] or st["grad_card"]]
                return (max(first["ulps_cpu"], first["ulps_card"]) <= NEAR_ZERO_ULPS
                        and bool(moved) and moved[0]["signs_differ"])

            loud = [e for e in named if not explained(e)]
            if loud or not rest <= limit:
                raise AssertionError(
                    f"reduced fp32 {arch} training: params apart by more than {limit} whose "
                    f"first-step gradient is not within {NEAR_ZERO_ULPS} ulps of zero on both "
                    f"devices, or whose first nonzero gradient has one sign on both: "
                    f"{loud[:3]}; the other elements' largest difference {rest:.3g}")
    log(f"reduced fp32 training, 3 steps each: card vs CPU {out} (within {TRAIN_TOL})")
    return out


TRAIN_ARGV = ["--arch", "olmo-1b", "--steps", "20", "--global-batch", str(TRAIN_B),
              "--seq", str(TRAIN_T), "--qat", "w4a8"]
# rwkv6-3b at full width and depth (32 layers, 2.86 B parameters), plain
# bf16 as JAX trains it, through the CLI. The recurrent runs take lr 1e-3:
# at the CLI's default 3e-3 rwkv6-3b's loss fell for the warmup's two
# steps, then rose (11.60 -> 13.60 by step 6, 12.15 at step 9, on an H100
# 80GB HBM3 at 700 W).
TRAIN_LR_RECURRENT = 1e-3
RWKV_TRAIN_ARGV = ["--arch", "rwkv6-3b", "--steps", "10", "--global-batch", str(TRAIN_B),
                   "--seq", str(TRAIN_T), "--lr", str(TRAIN_LR_RECURRENT)]
# recurrentgemma-9b at full width, QAT w4a8, cut to 8 layers: two (rglru,
# rglru, attn) groups and the 2-layer rem (3.68 B parameters; 38 layers'
# weights, grads and AdamW moments, about 115 GB, do not fit in 80).
GRIFFIN_TRAIN_LAYERS, GRIFFIN_TRAIN_STEPS = 8, 10
# mixtral-8x22b at full width (d 6144, 48/8 heads, 8 experts of 16384,
# vocab 32768), QAT w4a8, cut in depth: 2.50 B parameters a layer, 12 bytes
# each with bf16 grads and float32 AdamW moments. 1 layer peaks at 41.97
# GB; 2 layers' 64.9 GB of state leave too little for the step: they ran
# out of memory in the clip's norm at 66.5 GB allocated (H100 80GB HBM3,
# 700 W). lr 3e-4: at 1e-3 the router collapsed within three steps (aux
# 1.04 -> 6.94 of at most 8) and the loss jumped to 13.03 before the cosine
# brought it back to 10.77; at 3e-4 it fell every step, 10.91 -> 10.58.
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN_STEPS, MIXTRAL_TRAIN_LR = 1, 10, 3e-4


def _train_report(torch, name, hist, tokens_per_step, wall, smi, counts, need):
    """Gate one full-width training run (every logged loss, grad norm and
    aux loss finite, the last loss below the first, each kernel of `need`
    launched) and print s/step, tokens/s and the peak memory beside the
    card."""
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist] + [h["aux_loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{name} training: a loss or grad norm is not finite: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name} training: the loss did not fall: {losses}")
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name} training launched no {missing}: {counts}")
    steps = sorted(h["dt"] for h in hist[1:])
    s_step = steps[len(steps) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    rep = {"losses": losses, "grad_norms": norms[:len(hist)],
           "aux_losses": norms[len(hist):], "s_per_step_median": s_step,
           "first_step_s": hist[0]["dt"], "tokens_per_s": tokens_per_step / s_step,
           "peak_gb": peak, "wall_s": wall, "nvidia_smi": smi,
           "launches": {k: counts[k] for k in need}}
    log(f"{name} training at full width: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(hist)} steps, {s_step:.4f} s/step (median of steps 1-{len(hist) - 1}; step 0 "
        f"{hist[0]['dt']:.2f} s), {rep['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB, "
        f"{wall:.1f} s in all; launches {rep['launches']} [{smi}]")
    return rep


def train_full(torch, dev, smi):
    """Three training runs at full width, each gated by ``_train_report``:
    ``python -m repro_torch.launch.train`` with TRAIN_ARGV (olmo-1b at
    full depth, 16 layers, 1.18 B parameters, bf16, QAT w4a8, 20 steps of
    8 x 512 tokens) and with RWKV_TRAIN_ARGV (rwkv6-3b at full depth, 32
    layers, 2.86 B, plain bf16, 10 steps of 8 x 512 at lr 1e-3: ``wkv6``
    and ``wkv6_bwd`` launched), in-process; then recurrentgemma-9b at
    GRIFFIN_TRAIN_LAYERS (``_train_cfg(GRIFFIN, qat="w4a8",
    num_layers=8)``, 3.68 B, 10 steps of 8 x 512 through
    ``train/loop.py``'s ``run_training``, the CLI's schedule at lr 1e-3:
    ``rglru``, ``rglru_bwd``, ``flash_attention_bwd`` launched), and
    mixtral-8x22b (``train_mixtral``). The launch counts are the training
    path's: reset just before each run, read just after, summed. Returns
    (report, counts)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataIterator
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train.loop import run_training

    rep, total = {}, {}

    def counted(fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        return out, wall, counts

    for name, argv, need in (
            ("olmo-1b", TRAIN_ARGV, ("flash_attention", "flash_attention_bwd", "dense_matmul")),
            ("rwkv6-3b", RWKV_TRAIN_ARGV, ("wkv6", "wkv6_bwd", "dense_matmul"))):
        out, wall, counts = counted(lambda: train.run(train.build_parser().parse_args(argv)))
        rep[name] = _train_report(torch, name, out["history"], out["tokens_per_step"], wall,
                                  smi, counts, need)
        rep[name]["argv"] = argv
        del out
    cfg = _train_cfg(GRIFFIN, qat="w4a8", num_layers=GRIFFIN_TRAIN_LAYERS)
    steps = GRIFFIN_TRAIN_STEPS
    tc = TrainConfig(lr=TRAIN_LR_RECURRENT, warmup_steps=min(20, steps // 5),
                     total_steps=steps, log_every=1, checkpoint_every=steps)
    data = DataIterator(cfg, global_batch=TRAIN_B, seq_len=TRAIN_T, seed=tc.seed, branch=8)
    (state, hist), wall, counts = counted(
        lambda: run_training(build_model(cfg), tc, data, device=dev))
    del state               # Griffin's 44 GB of state, before mixtral's run
    name = f"{GRIFFIN} ({cfg.num_layers} layers, QAT w4a8)"
    rep[GRIFFIN] = _train_report(torch, name, hist, TRAIN_B * TRAIN_T, wall, smi, counts,
                                 ("rglru", "rglru_bwd", "flash_attention",
                                  "flash_attention_bwd", "dense_matmul"))
    rep[GRIFFIN].update(layers=cfg.num_layers, parameters=cfg.param_count())
    del data, hist
    rep[MIXTRAL], counts = train_mixtral(torch, dev, smi)
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return rep, total


def train_mixtral(torch, dev, smi, layers=None):
    """mixtral-8x22b at full width cut to `layers` (MIXTRAL_TRAIN_LAYERS
    unless given), QAT w4a8, MIXTRAL_TRAIN_STEPS steps of 8 x 512 through
    ``run_training`` at MIXTRAL_TRAIN_LR (the CLI's schedule), its aux
    loss printed each step, gated by
    ``_train_report`` (``expert_matmul``, ``expert_matmul_bwd``, the flash
    pair and ``dense_matmul`` launched). The launch counts are reset just
    before the run and read just after. Returns (report, counts)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataIterator
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.loop import run_training

    cfg = _train_cfg(MIXTRAL, qat="w4a8", num_layers=layers or MIXTRAL_TRAIN_LAYERS)
    steps = MIXTRAL_TRAIN_STEPS
    tc = TrainConfig(lr=MIXTRAL_TRAIN_LR, warmup_steps=min(20, steps // 5),
                     total_steps=steps, log_every=1, checkpoint_every=steps)
    data = DataIterator(cfg, global_batch=TRAIN_B, seq_len=TRAIN_T, seed=tc.seed, branch=8)

    def aux_line(step, rec):
        log(f"  {MIXTRAL} step {step}: loss {rec['loss']:.4f} aux {rec['aux_loss']:.5f} "
            f"gnorm {rec['grad_norm']:.3f} {rec['dt']:.3f} s")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = run_training(build_model(cfg), tc, data, hooks=aux_line, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    del state
    name = f"{MIXTRAL} ({cfg.num_layers} layer{'s' if cfg.num_layers > 1 else ''}, QAT w4a8)"
    rep = _train_report(torch, name, hist, TRAIN_B * TRAIN_T, wall, smi, counts,
                        ("expert_matmul", "expert_matmul_bwd", "flash_attention",
                         "flash_attention_bwd", "dense_matmul"))
    rep.update(layers=cfg.num_layers, parameters=cfg.param_count())
    return rep, counts


def _leaves_equal(torch, a, b):
    from repro_torch import tree as tr

    pa, pb = tr.flatten_with_path(a), tr.flatten_with_path(b)
    bad = [tr.path_str(p) for (p, x), (_, y) in zip(pa, pb)
           if x.dtype != y.dtype or not torch.equal(x, y.to(x.device))]
    same_paths = [tr.path_str(p) for p, _ in pa] == [tr.path_str(p) for p, _ in pb]
    return same_paths, bad


def check_resume(torch, dev, workdir):
    """Checkpoint and resume at DEPTH's 4 layers of olmo-1b, full width,
    QAT w4a8, batch 8 x 512 (about 4.5 GB a checkpoint): one run of 15
    steps saves at steps 5 and 10 (async, keep 1, as ``run_training``
    saves); the state restored right after the step-10 save is bitwise
    the state saved, every leaf; then a restart (``run_training`` with the
    manager: the template drawn on ``meta``, a fresh data iterator set
    from the checkpoint) runs steps 10-14 and gives bitwise the
    uninterrupted run's losses, grad norms and params. Leaves the step-10
    checkpoint in `workdir` for ``serve --ckpt``. Returns (the report, the
    params restored from step 10)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataIterator
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_train_state, make_train_step, run_training

    cfg = _train_cfg("olmo-1b", qat="w4a8", num_layers=DEPTH["olmo-1b"])
    model = build_model(cfg)
    tc = TrainConfig(lr=3e-3, warmup_steps=4, total_steps=15, log_every=1,
                     checkpoint_every=5)

    def data():
        return DataIterator(cfg, global_batch=TRAIN_B, seq_len=TRAIN_T, seed=0, branch=8)

    mgr = CheckpointManager(workdir, keep=1, async_save=True)
    t0 = time.perf_counter()
    it = data()
    state = init_train_state(model.init(0, dev), tc)
    step_fn = make_train_step(model, tc)
    hist, t_restore, size = [], 0.0, 0
    for i in range(tc.total_steps):
        state, m = step_fn(state, next(it))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        if (i + 1) in (5, 10):
            mgr.save(i + 1, state, it.get_state())
        if i + 1 == 10:
            mgr.wait()
            t1 = time.perf_counter()
            restored, data_state, step = mgr.restore(
                lambda: init_train_state(model.init(0, "meta"), tc), device=dev)
            t_restore = time.perf_counter() - t1
            same_tree, bad = _leaves_equal(torch, state, restored)
            if step != 10 or data_state["step"] != 10 or not same_tree or bad:
                raise AssertionError(f"restore: step {step}, data {data_state}, tree "
                                     f"equal {same_tree}, leaves differing {bad[:5]}")
            params10 = restored.params
            del restored
            size = sum(f.stat().st_size for f in (mgr.dir / "10").iterdir())
    t_train = time.perf_counter() - t0
    # The restart: a new run from the step-10 checkpoint (no further saves).
    tc_restart = dataclasses.replace(tc, checkpoint_every=100)
    resumed, hist_b = run_training(model, tc_restart, data(), checkpoint_mgr=mgr, device=dev)
    again = [(h["loss"], h["grad_norm"]) for h in hist_b]
    same_tree, bad = _leaves_equal(torch, state, resumed)
    if again != hist[10:] or not same_tree or bad:
        raise AssertionError(f"resume: steps 10-14 uninterrupted {hist[10:]} vs restarted "
                             f"{again}; params differing {bad[:5]}")
    log(f"checkpoint / resume (olmo-1b, {cfg.num_layers} layers, QAT w4a8): restored "
        f"state bitwise the saved one ({size / 1e9:.2f} GB on disk; 15 steps with 2 "
        f"async saves and a restore {t_train:.1f} s, the restore {t_restore:.1f} s); "
        f"steps 10-14 after a restart bitwise the uninterrupted run (losses "
        f"{[round(h[0], 4) for h in hist[10:]]})")
    del state, resumed
    return {"losses": [h[0] for h in hist], "grad_norms": [h[1] for h in hist],
            "ckpt_gb": size / 1e9, "train_s": t_train, "restore_s": t_restore}, params10


# The recurrent restarts: (arch, layers at full width or None for the
# reduced config, --qat), RESTART_STEPS steps of TRAIN_B x TRAIN_T tokens,
# a save after RESTART_SAVE. Griffin's runs reduced: at full width its
# untied 256 000-wide embedding and head with their AdamW moments make a
# 31 GB checkpoint even at 2 layers, whose save and restore took 101-157 s
# on an H100 host (the script's total 931 s of its 1200).
RESTART_RUNS = (("rwkv6-3b", 2, None), (GRIFFIN, None, "w4a8"), (MIXTRAL, None, None))
# The backward kernel each restart's steps must run.
RESTART_KERNEL = {"rwkv6-3b": "wkv6_bwd", GRIFFIN: "rglru_bwd", MIXTRAL: "expert_matmul_bwd"}
RESTART_STEPS, RESTART_SAVE = 4, 2


def check_restarts(torch, dev, workdir):
    """A bitwise restart of each family of RESTART_RUNS, as
    ``check_resume``'s: rwkv6-3b (plain bf16) at full width cut to 2
    layers, recurrentgemma-9b (QAT w4a8) reduced, mixtral-8x22b (plain
    bf16) reduced, where the expert products run the kernels at d 64, f
    128; each step through its backward kernel (RESTART_KERNEL): on the
    MoE steps also autograd's own backward of the dispatch's and the
    combine's gathers, which sum at most k = 2 terms from zero a row. One run of RESTART_STEPS steps
    saves after step RESTART_SAVE (async, keep 1); a restart
    (``run_training`` with the manager) runs the steps after it and gives
    bitwise the uninterrupted run's losses, grad norms and params. Returns
    arch → report."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataIterator
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_train_state, make_train_step, run_training

    out = {}
    for arch, layers, qat in RESTART_RUNS:
        t0 = time.perf_counter()
        over = {} if layers is None else {"num_layers": layers}
        cfg = _train_cfg(arch, reduced=layers is None, qat=qat, **over)
        model = build_model(cfg)
        tc = TrainConfig(lr=TRAIN_LR_RECURRENT, warmup_steps=1, total_steps=RESTART_STEPS,
                         log_every=1, checkpoint_every=RESTART_SAVE)

        def data():
            return DataIterator(cfg, global_batch=TRAIN_B, seq_len=TRAIN_T, seed=0, branch=8)

        where = os.path.join(workdir, arch)
        mgr = CheckpointManager(where, keep=1, async_save=True)
        ops.reset_launch_counts()
        it, hist = data(), []
        state = init_train_state(model.init(0, dev), tc)
        step_fn = make_train_step(model, tc)
        for i in range(RESTART_STEPS):
            state, m = step_fn(state, next(it))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            if i + 1 == RESTART_SAVE:
                mgr.save(i + 1, state, it.get_state())
        mgr.wait()
        size = sum(f.stat().st_size for f in (mgr.dir / str(RESTART_SAVE)).iterdir())
        resumed, hist_b = run_training(model, dataclasses.replace(tc, checkpoint_every=100),
                                       data(), checkpoint_mgr=mgr, device=dev)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        again = [(h["loss"], h["grad_norm"]) for h in hist_b]
        same_tree, bad = _leaves_equal(torch, state, resumed)
        kernel = RESTART_KERNEL[arch]
        if again != hist[RESTART_SAVE:] or not same_tree or bad or counts[kernel] <= 0:
            raise AssertionError(f"{arch} restart: steps {RESTART_SAVE}-{RESTART_STEPS - 1} "
                                 f"uninterrupted {hist[RESTART_SAVE:]} vs restarted {again}; "
                                 f"params differing {bad[:5]}; {kernel} launches "
                                 f"{counts[kernel]}")
        out[arch] = {"layers": cfg.num_layers, "reduced": layers is None, "qat": qat,
                     "losses": [h[0] for h in hist],
                     "grad_norms": [h[1] for h in hist], "ckpt_gb": size / 1e9,
                     "launches": {kernel: counts[kernel]},
                     "seconds": time.perf_counter() - t0}
        log(f"restart ({cfg.name}, {cfg.num_layers} layers{', QAT ' + qat if qat else ''}): steps "
            f"{RESTART_SAVE}-{RESTART_STEPS - 1} after a restart bitwise the uninterrupted "
            f"run (losses {[round(h[0], 4) for h in hist]}, {size / 1e9:.3g} GB on disk, "
            f"{counts[kernel]} {kernel} launches, {out[arch]['seconds']:.1f} s)")
        del state, resumed
        shutil.rmtree(where, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def serve_ckpt(torch, dev, workdir, params10):
    """The serve CLI on the checkpoint: ``serve --ckpt <workdir> --layers
    4 --continuous --policy "w4a8;wo=w8a8"`` (4 requests of the stream,
    8 new tokens) prints ``restored checkpoint step 10``; the params it
    restores (read as ``serve.restore_params`` returns them, before the
    engine packs them) are bitwise, leaf for leaf, the params
    ``check_resume`` restored from that checkpoint and held bitwise to
    the trained state; and its greedy tokens equal an in-process
    engine's on those params (the same policy, pool and flags)."""
    import io

    from repro_torch.core.precision import parse_policy_spec
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    argv = ["--arch", "olmo-1b", "--layers", str(DEPTH["olmo-1b"]), "--continuous",
            "--policy", POLICY, "--requests", "4", "--max-new", "8", "--ckpt", workdir]
    args = serve.build_parser().parse_args(argv)
    restore, loaded = serve.restore_params, {}

    def held(cfg, ckpt, device):
        params = restore(cfg, ckpt, device)
        loaded["layers"] = cfg.num_layers
        loaded["same_tree"], loaded["differing"] = _leaves_equal(torch, params10, params)
        return params

    buf = io.StringIO()
    serve.restore_params = held
    try:
        with contextlib.redirect_stdout(buf):
            _, done, _ = serve.run(args)
    finally:
        serve.restore_params = restore
    text = buf.getvalue()
    if "restored checkpoint step 10" not in text:
        raise AssertionError(f"serve --ckpt did not restore step 10:\n{text}")
    if (loaded.get("layers") != DEPTH["olmo-1b"] or not loaded["same_tree"]
            or loaded["differing"]):
        raise AssertionError(f"serve --ckpt restored params that are not the checkpoint's: "
                             f"{loaded}")
    cfg = serve_config("olmo-1b")
    engine = ServingEngine(cfg, params10, max_batch=args.max_batch,
                           quant=parse_policy_spec(POLICY), bucket=32,
                           block_size=args.block_size, prefill_budget=args.prefill_budget,
                           device=dev)
    mine = {r.rid: r.out_tokens for r in engine.generate(serve.synthetic_requests(cfg, args))}
    cli = {r.rid: r.out_tokens for r in done}
    if mine != cli:
        raise AssertionError(f"serve --ckpt tokens {cli} differ from the in-process "
                             f"engine's {mine}")
    log(f"serve --ckpt: restored step 10, its {DEPTH['olmo-1b']} layers' params bitwise "
        f"the checkpoint's, leaf for leaf; {len(cli)} requests' greedy tokens equal the "
        f"in-process engine's on them ({POLICY})")
    return {"tokens": cli}


def log_bwd_rows(rows, smi):
    """Print the recurrences' backward rows: time, bound, plain version,
    wkv6_bwd's launches and rglru_bwd's copy yardstick."""
    for name in ("wkv6_bwd", "rglru_bwd"):
        e = rows[name]
        parts = e.get("launches_ms")
        log(f"  {name}: {e['shape']}: {e['ms']:.4g} ms (bound {e['bound_ms']:.3g} ms by "
            f"{e['bound_by']}, plain {e['plain_ms']:.4g} ms, library none{copy_note(e)}"
            + (f"; by launch {', '.join(f'{k} {v:.4g}' for k, v in parts.items())} ms"
               if parts else "") + f") [{smi}]")


def check_backward_kernels(torch, dev, timer):
    """The backward kernels against their plain versions
    (``check_flash_backward``, ``check_wkv6_backward``,
    ``check_rglru_backward``), each timed and printed. Returns their
    rows."""
    smi = nvidia_smi()
    bwd = check_flash_backward(torch, dev, timer)
    for e in (bwd, *bwd["entries"].values()):
        log(f"  flash_attention_bwd: {e['shape']}: {e['ms']:.4g} ms (bound "
            f"{e['bound_ms']:.3g} ms by {e['bound_by']}, plain {e['plain_ms']:.4g} ms, "
            f"SDPA backward {e['library_ms']:.4g} ms) [{smi}]")
    rows = {"flash_attention_bwd": bwd, "wkv6_bwd": check_wkv6_backward(torch, dev, timer),
            "rglru_bwd": check_rglru_backward(torch, dev, timer)}
    log_bwd_rows(rows, smi)
    return rows


def train_phase(torch, dev):
    """The training gates past the backward kernels: the wrappers' bits
    (``check_grad_wrappers``), ``dense_matmul``'s gradients
    (``check_dense_backward``), card vs CPU (``card_vs_cpu_train``),
    olmo-1b, rwkv6-3b and recurrentgemma-9b at full width
    (``train_full``), checkpoint and resume (``check_resume``) and serve
    --ckpt (``serve_ckpt``), the recurrent families' restarts
    (``check_restarts``), each checkpoint in a temporary
    directory removed after. The MoE gates (``check_moe_layer_grads``, the
    MoE rows of the card-vs-CPU check and of the restarts, mixtral in
    ``train_full``) run among them. Returns (report, launch counts of the
    full-width training runs)."""
    import tempfile

    smi = nvidia_smi()
    t0 = time.perf_counter()
    rep = {"wrappers": check_grad_wrappers(torch, dev),
           "dense_backward": check_dense_backward(torch, dev),
           "moe_layer_grads": check_moe_layer_grads(torch, dev),
           "card_vs_cpu": card_vs_cpu_train(torch)}
    t_checks = time.perf_counter() - t0
    rep["full"], counts = train_full(torch, dev, smi)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as workdir:
        rep["resume"], params10 = check_resume(torch, dev, workdir)
        rep["serve_ckpt"] = serve_ckpt(torch, dev, workdir, params10)
        del params10
    t_resume = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as workdir:
        rep["restarts"] = check_restarts(torch, dev, workdir)
    t_full = sum(r["wall_s"] for r in rep["full"].values())
    rep["seconds"] = {"checks": t_checks, "full": t_full, "resume_and_serve": t_resume,
                      "restarts": time.perf_counter() - t0 - t_resume}
    log(f"train phase: card-vs-CPU and gradient checks {t_checks:.1f} s, full-width "
        f"training {t_full:.1f} s, resume and serve --ckpt {t_resume:.1f} s, the "
        f"restarts {rep['seconds']['restarts']:.1f} s")
    return rep, counts


def profile_serve(torch, params_of, names=("a-static", "b-static-int8", "e-rwkv6-static")):
    """`chip_smoke.py profile [run ...]`: one warm serve pass of the
    stream above under torch.profiler, for each named run of RUNS (by
    default the static runs (a) Table III, (b) where every packed leaf
    runs the fused kernel, and (e) rwkv6-3b; MOE_RUNS' names serve at
    DEPTH's layers). Prints device time by kernel name, the device-busy
    share of each pass's wall time and ``expert_matmul``'s device time and
    share of the busy time, and writes the tables to profile.json under
    $CHIP_SMOKE_OUT. Not part of the default run."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    out = {}
    for name in names:
        args = serve.build_parser().parse_args(serve_argv(name))
        engine, _, report = serve.run(args, mixed_requests, params=params_of(name))
        reqs = mixed_requests(engine.cfg, args)
        go = engine.generate if args.continuous else engine.generate_static
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            go(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # Kernel rows only: an operator's row repeats its kernels' time.
        rows = sorted(((e.key, e.self_device_time_total, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e6
        expert = [r for r in rows if "expert_kernel" in r[0]]
        expert_s = sum(r[1] for r in expert) / 1e6
        out[name] = {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
                     "tokens": sum(len(r.out_tokens) for r in reqs),
                     "untimed_pass_tok_per_s": report["tok_per_s"],
                     "expert_matmul": {"device_ms": expert_s * 1e3,
                                       "calls": sum(r[2] for r in expert),
                                       "share_of_busy": expert_s / busy if busy else 0.0},
                     "kernels": [{"name": k, "device_ms": us / 1e3, "calls": n}
                                 for k, us, n in rows[:40]]}
        log(f"profiled pass [{name}]: wall {wall:.2f}s, device busy {busy:.2f}s "
            f"({busy / wall:.0%}), untimed pass {report['tok_per_s']:.1f} tok/s; "
            f"expert_matmul {expert_s * 1e3:.2f} ms in {out[name]['expert_matmul']['calls']} "
            f"calls ({out[name]['expert_matmul']['share_of_busy']:.1%} of the busy time)")
        for r in out[name]["kernels"][:20]:
            log(f"  {r['device_ms']:9.1f} ms  {r['calls']:6d}  {r['name'][:90]}")
        del engine, prof
        gc.collect()
        torch.cuda.empty_cache()
    write_detail("profile.json", out)


# profile_train's kernel groups: substrings of the kernel names (the first
# group that matches takes a kernel).
TRAIN_KERNEL_GROUPS = (
    ("wkv6_bwd", ("wkv6_bwd_",)),
    ("wkv6", ("wkv6_",)),
    ("rglru_bwd", ("rglru_bwd_",)),
    ("rglru", ("rglru_kernel", "rglru_step_kernel")),
    ("flash backward", ("rows_bf16_kernel", "dkdv_bf16_kernel", "lse_rows_kernel",
                        "dkdv_kernel", "dq_kernel")),
    ("flash forward", ("flash_mma_kernel", "flash_f32_kernel")),
    ("dense_matmul", ("dense_kernel",)),
    ("expert_matmul_bwd", ("expert_bwd_kernel",)),
    ("expert_matmul", ("expert_kernel",)),
    ("torch.matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet")),
)


# profile-train's runs: arch → (config, lr, warmup): the four full-width
# training runs of train_full (Griffin at GRIFFIN_TRAIN_LAYERS, mixtral at
# MIXTRAL_TRAIN_LAYERS).
PROFILE_TRAIN = {
    "olmo-1b": (lambda: _train_cfg("olmo-1b", qat="w4a8"), 3e-3, 4),
    "rwkv6-3b": (lambda: _train_cfg("rwkv6-3b"), TRAIN_LR_RECURRENT, 2),
    GRIFFIN: (lambda: _train_cfg(GRIFFIN, qat="w4a8", num_layers=GRIFFIN_TRAIN_LAYERS),
              TRAIN_LR_RECURRENT, 2),
    MIXTRAL: (lambda: _train_cfg(MIXTRAL, qat="w4a8", num_layers=MIXTRAL_TRAIN_LAYERS),
              MIXTRAL_TRAIN_LR, 2),
}


def profile_train(torch, dev, arch="olmo-1b"):
    """`chip_smoke.py profile-train [arch ...]`: a training step of each
    named arch of PROFILE_TRAIN (by default olmo-1b's QAT step at full
    width and depth; rwkv6-3b at its 32 layers, recurrentgemma-9b at
    GRIFFIN_TRAIN_LAYERS, mixtral-8x22b at MIXTRAL_TRAIN_LAYERS) on TRAIN_ARGV's 8 x 512 tokens, seed 0: one
    warmup step, then one step timed in parts on the host clock (the
    loss, its gradients, clipping, AdamW, each synchronized) and two steps
    under torch.profiler: device time a step by kernel group
    (TRAIN_KERNEL_GROUPS, the rest being PyTorch's elementwise, reduction
    and copy kernels) and by kernel, and the device-busy share. Returns
    the report. Not part of the default run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as tr
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataIterator
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_train_state, make_train_step

    make_cfg, lr, warmup = PROFILE_TRAIN[arch]
    cfg = make_cfg()
    model = build_model(cfg)
    tc = TrainConfig(lr=lr, warmup_steps=warmup, total_steps=20)
    data = DataIterator(cfg, global_batch=TRAIN_B, seq_len=TRAIN_T, seed=0, branch=8)
    state = init_train_state(model.init(0, dev), tc)
    step = make_train_step(model, tc)
    state, _ = step(state, data.batch_at(0))
    torch.cuda.synchronize()
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    live = tr.map_tree(lambda p: p.detach().requires_grad_(True), state.params)
    loss, _ = timed("forward_ms", lambda: model.train_loss(live, data.batch_at(1)))
    grads = timed("backward_ms", lambda: torch.autograd.grad(loss, tr.leaves(live)))
    grads = tr.unflatten_like(state.params, list(grads))
    clipped, _ = timed("clip_ms", lambda: adamw.clip_by_global_norm(grads, tc.grad_clip))
    timed("adamw_ms", lambda: adamw.apply_updates(state.params, clipped, state.opt, tc))
    del live, loss, grads, clipped
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in (2, 3):
            state, _ = step(state, data.batch_at(i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    groups = {g: 0.0 for g, _ in TRAIN_KERNEL_GROUPS}
    groups["other (elementwise, reductions, copies)"] = 0.0
    for name, us, _ in rows:
        g = next((g for g, keys in TRAIN_KERNEL_GROUPS
                  if any(k in name.lower() for k in map(str.lower, keys))),
                 "other (elementwise, reductions, copies)")
        groups[g] += us / 2e3                     # ms a step
    busy = sum(r[1] for r in rows) / 2e3
    out = {"layers": cfg.num_layers, "parts": parts, "wall_ms_per_step": wall * 500,
           "device_busy_ms_per_step": busy, "busy_share": busy / (wall * 500),
           "groups_ms_per_step": groups,
           "kernels": [{"name": k, "device_ms_per_step": us / 2e3, "calls": n}
                       for k, us, n in rows[:30]], "nvidia_smi": nvidia_smi()}
    log(f"{arch} ({cfg.num_layers} layers) training step in parts: "
        f"{({k: round(v, 1) for k, v in parts.items()})}; profiled: {wall * 500:.1f} ms a "
        f"step, device busy {busy:.1f} ms ({out['busy_share']:.0%}) [{out['nvidia_smi']}]")
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"  {ms:8.1f} ms  {g}")
    for r in out["kernels"][:15]:
        log(f"  {r['device_ms_per_step']:8.2f} ms {r['calls']:6d}  {r['name'][:90]}")
    del state
    torch.cuda.empty_cache()
    return out


# Library → the tensor-core instruction its SASS must hold (with the TMA
# load where the kernel is fed by one).
TENSOR_CORE_KERNELS = {"flash_attention": "HMMA", "paged_attention": "HMMA",
                       "paged_prefill": "HMMA", "dense_matmul": "HMMA",
                       "bitplane_matmul": "IMMA", "fused_matmul": "IMMA",
                       "flash_attention_bwd": "HMMA", "expert_matmul": ("HGMMA", "UTMALDG"),
                       "expert_matmul_bwd": ("HGMMA", "UTMALDG")}
# Libraries whose products run on wgmma alone: no HMMA in their SASS.
WGMMA_ONLY = ("expert_matmul", "expert_matmul_bwd")
# ptxas notes that undo wgmma's overlap: C7518, every wgmma serialized for
# a wait the compiler put on a divergent path (it cost expert_matmul 5-20 %
# at prefill on the H100); C7517, a wait the compiler injected before the
# accumulators are read. No WGMMA_ONLY library may build with either.
WGMMA_NOTES = ("C7517", "C7518")
# Libraries whose SASS must hold no atomic (ATOM, RED): their sums run in
# an order fixed by the shapes.
NO_ATOMICS = ("flash_attention_bwd", "wkv6_bwd", "rglru_bwd", "expert_matmul",
              "expert_matmul_bwd")


def _sass(paths, name):
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(paths[name])], capture_output=True,
                          text=True, check=True).stdout.splitlines()


def no_atomics(paths, names):
    """Raise if the SASS of a library in `names` holds an atomic (ATOM,
    RED): its sums run in an order fixed by the shapes."""
    for name in names:
        atomics = [line.strip() for line in _sass(paths, name)
                   if re.search(r"\b(ATOMG?|ATOMS|RED)\b", line)]
        if atomics:
            raise AssertionError(f"{name}: atomics in its SASS: {atomics[:3]}")


def wgmma_notes(logs):
    """Raise if the ptxas log of a WGMMA_ONLY library (`logs`: name → the
    log of its build in this process) holds a WGMMA_NOTES note. Returns
    the libraries whose logs were read: one built before this process left
    none."""
    read = [name for name in WGMMA_ONLY if name in logs]
    for name in read:
        notes = [line.strip() for line in logs[name].splitlines()
                 if any(code in line for code in WGMMA_NOTES)]
        if notes:
            raise AssertionError(f"{name}: ptxas serialized or waited on its wgmma: {notes[:3]}")
    return read


def count_hmma(paths):
    """The bf16 attention tile, the flash backward's bf16 route and
    dense_matmul run on the bf16 tensor cores, bitplane_matmul and the
    fused matmul on the int8 ones, expert_matmul on wgmma fed by TMA: the
    SASS of their libraries (``cuobjdump -sass``) must hold HMMA (IMMA;
    HGMMA and UTMALDG, and no HMMA) instructions; the backward kernels'
    (flash, wkv6, RG-LRU) and expert_matmul's must hold none that is
    atomic. Returns library → count of each instruction."""
    counts = {}
    for name, ops_ in TENSOR_CORE_KERNELS.items():
        sass = _sass(paths, name)
        for op in (ops_,) if isinstance(ops_, str) else ops_:
            n = sum(op in line for line in sass)
            counts[name if isinstance(ops_, str) else f"{name} {op}"] = n
            if n == 0:
                raise AssertionError(f"{name}: no {op} instruction in its SASS")
        if name in WGMMA_ONLY and any("HMMA" in line for line in sass):
            raise AssertionError(f"{name}: HMMA in its SASS, which should hold wgmma only")
    no_atomics(paths, NO_ATOMICS)
    log(f"tensor cores: HMMA / IMMA / HGMMA / UTMALDG instructions in the SASS of {counts}; "
        f"no HMMA in {', '.join(WGMMA_ONLY)}'s; no atomics in {', '.join(NO_ATOMICS)}'s")
    return counts


def write_detail(name: str, data) -> None:
    """Write `data` as JSON to $CHIP_SMOKE_OUT/`name`, if that is set."""
    out = os.environ.get("CHIP_SMOKE_OUT")
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, name), "w") as f:
            json.dump(data, f, indent=1, default=str)


# -- the run: one ordered table of phases --------------------------------------

class Run:
    """What the phases of one run share: the kernel rows of the last line
    (``results``, ``dense``), the serve runs by name (``runs``) and their
    launches summed (``counts``), the report of the detail JSON
    (``detail``) and the weights drawn for the serve runs."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.timer = Timer(torch, dev)
        self.results, self.dense, self.counts, self.train_counts = {}, None, {}, {}
        self.runs, self.detail, self.params = {}, {}, {}
        self.t_start = time.perf_counter()

    @property
    def kit(self):
        """(torch, dev, timer), the kernel checks' first arguments."""
        return self.torch, self.dev, self.timer

    def params_of(self, name):
        """The seed-0 weights of serve run `name`'s arch, drawn once."""
        from repro_torch.launch import serve
        from repro_torch.models import build_model

        arch = serve.build_parser().parse_args(serve_argv(name)).arch
        if arch not in self.params:
            self.params[arch] = build_model(serve_config(arch)).init(seed=0, device=self.dev)
        return self.params[arch]

    def params_one_arch(self, name):
        """``params_of(name)``, the other archs' weights dropped first (the
        MoE archs' do not fit the card together)."""
        import gc

        from repro_torch.launch import serve

        arch = serve.build_parser().parse_args(serve_argv(name)).arch
        for other in [a for a in self.params if a != arch]:
            del self.params[other]
        gc.collect()
        self.torch.cuda.empty_cache()
        return self.params_of(name)

    def add(self, counts):
        """A serve phase's launch counts, added to ``counts``."""
        for k, n in counts.items():
            self.counts[k] = self.counts.get(k, 0) + n
        return counts

    def serve(self, *names):
        """``serve_run`` of each of `names` not served yet in this run, its
        launches counted. Returns ``runs``."""
        for name in names:
            if name not in self.runs:
                self.runs[name] = serve_run(self.torch, self.params_of(name), name)
                self.add(self.runs[name][2])
        return self.runs

    def entry(self, kernel, name, e, fold=False):
        """`e` as entry `name` of `kernel`'s row (a holder row where the
        kernel's own check does not run in this mode); with `fold`, its
        error taken into the row's."""
        row = self.results.setdefault(kernel, {"max_abs_err": 0.0})
        row.setdefault("entries", {})[name] = e
        if fold:
            row["max_abs_err"] = max(row["max_abs_err"], e["max_abs_err"])


def phase_build(r):
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f}s "
        f"(nvcc {build.build_seconds:.1f}s, parallel), libraries: "
        + ", ".join(str(p) for p in paths.values()))
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line or (
                    name.endswith("_bwd") and "smem" in line):
                log(f"  ptxas {name}: {line.strip()}")
    read = wgmma_notes(build.build_logs)
    log(f"ptxas notes {', '.join(WGMMA_NOTES)}: none in the build logs of {read or 'no library'}"
        f" (a library built before this run leaves no log)")
    r.detail["hmma_in_sass"] = count_hmma(paths)
    one = r.torch.zeros(1, device=r.dev)
    r.detail["timer_floor_ms"] = r.timer(lambda: one.zero_())
    log(f"timer floor (one launch that fills one float): {r.detail['timer_floor_ms']:.5f} ms")


def phase_frontend_flash(r):
    entries, err, cases = check_frontend_flash(*r.kit)
    for name, e in entries.items():
        r.entry("flash_attention", name, e)
    row = r.results["flash_attention"]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["cases"] = row.get("cases", 0) + cases


def phase_mixed_group(r):
    mixed = check_mixed_group(*r.kit)
    for name, e in mixed["entries"].items():
        r.entry("bitplane_matmul", name, e)
    r.detail["mixed_group_cases"] = mixed["cases"]


def phase_dense(r):
    """dense_matmul in bf16 and its float32 entry: the row beside the
    kernels of the last line."""
    r.dense = check_dense_matmul(*r.kit)
    f32 = check_dense_f32(*r.kit)
    r.dense["entries"].update(f32["entries"])
    r.dense["max_abs_err"] = max(r.dense["max_abs_err"], f32["max_abs_err"])


def phase_new_widths(r):
    new_w = check_new_widths(*r.kit)
    r.entry("fused_quantize_matmul", "decode_nemotron_w_up", new_w["entry"])
    r.detail["new_widths"] = new_w["cases"]


def phase_moe_kernels(r):
    kern = moe_kernel_checks(*r.kit)
    r.entry("fused_quantize_matmul", "decode_nemotron340b_w_up", kern["fused_340b"]["entry"])
    for what, e in kern["attention"].items():
        r.entry("paged_attention" if what.startswith("ring") else "flash_attention", what, e,
                fold=True)


def phase_log_rows(r):
    """Every kernel row and entry of this run: time, bound, plain version,
    library call."""
    rows = [*r.results.items()] + ([("dense_matmul", r.dense)] if r.dense else [])
    for name, row in rows:
        for what, e in [(name, row)] + [(f"{name}[{k}]", e)
                                        for k, e in row.get("entries", {}).items()]:
            if "ms" not in e:
                continue
            lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4g} ms"
            log(f"  {what}: {e['shape']}: {e['ms']:.4g} ms (bound {e['bound_ms']:.3g} "
                f"ms by {e['bound_by']}, plain {e['plain_ms']:.4g} ms, library {lib}"
                + (f", all experts full {e['all_full_ms']:.4g} ms" if "all_full_ms" in e
                   else "") + f"{copy_note(e)})")
    log(f"kernel phase: {time.perf_counter() - r.t_start:.1f}s")


def phase_new_archs(r):
    t0 = time.perf_counter()
    r.detail["new_archs"], counts = serve_new_archs(r.torch, r.dev)
    r.add(counts)
    log(f"runs (o)-(r) and their gates: {time.perf_counter() - t0:.1f}s")


def phase_moe_archs(r):
    r.detail["moe_archs"], counts = serve_moe_archs(r.torch, r.dev)
    r.add(counts)


def phase_griffin(r):
    t0 = time.perf_counter()
    r.detail["griffin"], counts = serve_griffin(r.torch, r.dev)
    r.add(counts)
    log(f"runs (s), (t) and their gates: {time.perf_counter() - t0:.1f}s")


def phase_frontends(r):
    r.detail["frontends"], counts = serve_frontends(r.torch, r.dev)
    r.add(counts)


def phase_train(r):
    r.detail["train"], r.train_counts = train_phase(r.torch, r.dev)
    r.add(r.train_counts)


def phase_serve_runs(r):
    t0 = time.perf_counter()
    r.serve(*SERVE_RUNS)
    log(f"serve phase, runs {len(SERVE_RUNS)}: {time.perf_counter() - t0:.1f}s")


SOLO_VS_MID = ("chunked-bf16", "chunked-int8", "f-rwkv6-continuous")


def phase_solo_vs_mid(r):
    for name in SOLO_VS_MID:
        toks = solo_vs_mid_decode(r.serve(name)[name][0])
        log(f"solo == mid-decode admission [{name}]: {len(toks)} greedy tokens identical")


def phase_lifecycle(r):
    r.detail["lifecycle"] = check_lifecycle(r.torch, r.serve("chunked-int8")["chunked-int8"][0],
                                            r.params_of("chunked-int8"))


def phase_registry(r):
    t0 = time.perf_counter()
    r.detail["registry"] = check_registry(r.torch, r.dev, r.params_of("chunked-int8"),
                                          r.serve("chunked-int8")["chunked-int8"][3])
    log(f"registry phase: {time.perf_counter() - t0:.1f}s")


def phase_card_vs_cpu(r):
    err, _ = card_vs_cpu(r.torch)
    r.detail["card_vs_cpu_max_err"] = err
    log(f"reduced fp32 olmo-1b: card vs CPU logits max |err| {err:.3g}")


def phase_card_vs_cpu_archs(r):
    errs = r.detail["card_vs_cpu_archs_max_err"] = {
        a: card_vs_cpu(r.torch, a) for a in ("nemotron-4-15b", "stablelm-12b", NEMOTRON_340B)}
    log(f"reduced fp32 nemotron-4-15b / stablelm-12b / {NEMOTRON_340B}: card vs CPU logits "
        f"max |err| (and Table III code flips) {errs}")


def phase_card_vs_cpu_moe(r):
    errs = r.detail["card_vs_cpu_moe_max_err"] = card_vs_cpu_moe(r.torch)
    log(f"reduced fp32 {MIXTRAL} / {LLAMA4}: card vs CPU moe_apply and logits max |err| "
        f"{errs}")


def phase_card_vs_cpu_rwkv6(r):
    err = r.detail["card_vs_cpu_rwkv6_max_err"] = card_vs_cpu_rwkv6(r.torch)
    log(f"reduced fp32 rwkv6-3b: card vs CPU logits max |err| {err:.3g}")


def phase_card_vs_cpu_griffin(r):
    err = r.detail["card_vs_cpu_griffin_max_err"] = card_vs_cpu_griffin(r.torch)
    log(f"reduced fp32 {GRIFFIN}: card vs CPU logits max |err| {err:.3g}")


def phase_card_vs_cpu_frontends(r):
    errs = r.detail["card_vs_cpu_frontends_max_err"] = card_vs_cpu_frontends(r.torch)
    log(f"reduced fp32 {VLM} / {ENCODER}: card vs CPU logits max |err| {errs}")


def phase_launches(r):
    """Each kernel row's launches from the serve runs (every kernel's row
    must be there: the whole run only)."""
    counts, results = r.counts, r.results
    if any(counts[k] != r.train_counts[k]
           for k in ("flash_attention_bwd", "wkv6_bwd", "rglru_bwd", "expert_matmul_bwd")):
        raise AssertionError("a serve run launched a backward kernel")
    for k in results:
        results[k]["launches"] = counts[k]
    r.dense["launches"] = counts["dense_matmul"]
    # rglru: prompts (T > 1, the streaming kernel) and decode steps (T = 1).
    results["rglru"]["entries"]["prefill"]["launches"] = counts["rglru_prefill"]
    results["rglru"]["entries"]["decode"]["launches"] = counts["rglru_step"]
    # One TPU kernel, three entries: paged decode, contiguous decode over a
    # full cache and over a ring.
    entries = results["paged_attention"]["entries"]
    entries["contiguous"]["launches"] = counts["contig_attention"]
    entries["ring"]["launches"] = counts["ring_attention"]
    entries["paged"]["launches"] = (counts["paged_attention"] - counts["contig_attention"]
                                    - counts["ring_attention"])
    # The verify row's launches: paged_prefill's counter read inside the
    # speculating runs' verify calls (compare_speculation and compare_tiers
    # gate it at one a layer a row).
    results["paged_prefill"]["entries"]["verify"]["launches"] = \
        sum(run[1]["verify"]["launches"] for run in r.runs.values()) \
        + r.detail["new_archs"]["stablelm-12b"]["r-stablelm-spec-int8"]["verify"]["launches"]


def _detail(key, check, runs=()):
    """A phase storing ``check(r)`` under `key` of the detail, the serve
    runs `runs` served first."""
    def phase(r):
        r.serve(*runs)
        r.detail[key] = check(r)
    return phase


def _row(kernel, check):
    """A phase storing `check`'s row as `kernel`'s."""
    def phase(r):
        r.results[kernel] = check(*r.kit)
    return phase


# The phases of the whole run, in order. A mode of MODES runs the ones it
# names, in this order. Kernel checks first, then the serve, training and
# comparison phases; "launches" needs every kernel row and serve run, so
# only the whole run has it.
PHASES = (
    ("build", phase_build),
    ("fused", _row("fused_quantize_matmul", check_fused)),
    ("paged_attention", _row("paged_attention", check_paged_attention)),
    ("paged_prefill", _row("paged_prefill", check_paged_prefill)),
    ("quantize_rows", _row("quantize_rows", check_quantize_rows)),
    ("bitplane", _row("bitplane_matmul", check_bitplane)),
    ("flash", _row("flash_attention", check_flash)),
    ("wkv6", _row("wkv6", check_wkv6)),
    ("rglru", _row("rglru", check_rglru)),
    ("ring", lambda r: r.entry("paged_attention", "ring", check_ring_decode(*r.kit))),
    ("frontend_flash", phase_frontend_flash),
    ("windowed_flash", lambda r: r.entry("flash_attention", "windowed_prefill",
                                         check_windowed_flash(*r.kit))),
    ("mixed_group", phase_mixed_group),
    ("table3_launches", lambda r: r.detail.update(
        table3_launches=check_table3_launches(r.torch, r.dev))),
    ("dense", phase_dense),
    ("norm_rows", lambda r: r.detail.update(norm_rows=check_norm_rows(r.torch, r.dev))),
    ("head_dims", lambda r: r.detail.update(
        head_dims_max_err=check_head_dims(r.torch, r.dev))),
    ("one_order", lambda r: check_one_order(r.torch, r.dev)),
    ("new_widths", phase_new_widths),
    ("expert", _row("expert_matmul", check_expert_matmul)),
    ("expert_bwd", _row("expert_matmul_bwd", check_expert_backward)),
    ("moe_kernels", phase_moe_kernels),
    ("log_rows", phase_log_rows),
    ("new_archs", phase_new_archs),
    ("moe_archs", phase_moe_archs),
    ("griffin", phase_griffin),
    ("frontends", phase_frontends),
    ("backward", lambda r: r.results.update(check_backward_kernels(*r.kit))),
    ("train", phase_train),
    ("serve_runs", phase_serve_runs),
    ("solo_vs_mid", phase_solo_vs_mid),
    ("prefix", _detail("prefix_cache", lambda r: compare_prefix(r.torch, r.runs),
                       SERVE_RUNS)),
    ("speculation", _detail("speculation", lambda r: compare_speculation(r.torch, r.runs),
                            SPEC_RUNS)),
    ("tiers", _detail("tiers", lambda r: compare_tiers(r.torch, r.runs), TIER_RUNS)),
    ("lifecycle", phase_lifecycle),
    ("preemption", _detail("preemption", lambda r: check_preemption(r.torch, r.runs),
                           PREEMPT_RUNS)),
    ("chaos", _detail("chaos", lambda r: check_chaos(r.torch, r.runs,
                                                     r.params_of("k-spec-int8")),
                      PREEMPT_RUNS)),
    ("host_tier", _detail("host_tier", lambda r: check_host_tier(
        r.torch, r.runs, r.params_of("j-prefix-solo-int8")), HOST_REF_RUNS)),
    ("paths", _detail("paths", lambda r: compare_paths(r.torch, r.runs["c-solo-paged"][0],
                                                       r.runs), SERVE_RUNS)),
    ("rwkv6", _detail("rwkv6", lambda r: compare_rwkv6(r.torch, r.runs), SERVE_RUNS)),
    ("olmo_unpacked", _detail("olmo_unpacked", lambda r: compare_unpacked(r.torch, r.runs),
                              SERVE_RUNS)),
    ("registry", phase_registry),
    ("card_vs_cpu", phase_card_vs_cpu),
    ("card_vs_cpu_archs", phase_card_vs_cpu_archs),
    ("card_vs_cpu_moe", phase_card_vs_cpu_moe),
    ("card_vs_cpu_rwkv6", phase_card_vs_cpu_rwkv6),
    ("card_vs_cpu_griffin", phase_card_vs_cpu_griffin),
    ("card_vs_cpu_frontends", phase_card_vs_cpu_frontends),
    ("launches", phase_launches),
)
# The partial runs (``chip_smoke.py <mode>``, exit 3, no result line): each
# a subset of PHASES, its report in chip_smoke_<mode>.json.
MODES = {
    "kernels": ("build", "fused", "paged_attention", "paged_prefill", "quantize_rows",
                "bitplane", "flash", "wkv6", "rglru", "ring", "frontend_flash",
                "windowed_flash", "mixed_group", "table3_launches", "dense", "norm_rows",
                "head_dims", "one_order", "new_widths", "expert", "moe_kernels", "log_rows"),
    "moe": ("build", "dense", "head_dims", "expert", "expert_bwd", "moe_kernels", "log_rows",
            "moe_archs", "card_vs_cpu_archs", "card_vs_cpu_moe"),
    "expert": ("build", "expert", "expert_bwd", "log_rows"),
    "archs": ("build", "head_dims", "one_order", "new_widths", "log_rows", "new_archs",
              "registry", "card_vs_cpu_archs"),
    "griffin": ("build", "paged_attention", "rglru", "ring", "windowed_flash", "dense",
                "norm_rows", "one_order", "log_rows", "griffin", "card_vs_cpu_griffin"),
    "frontends": ("build", "flash", "frontend_flash", "windowed_flash", "norm_rows",
                  "head_dims", "one_order", "log_rows", "frontends", "solo_vs_mid",
                  "card_vs_cpu_frontends"),
    "train": ("build", "flash", "frontend_flash", "one_order", "expert_bwd", "log_rows",
              "backward", "train"),
    "bwd": ("build", "rglru", "log_rows", "backward"),
    "spec": ("build", "fused", "paged_prefill", "bitplane", "log_rows", "speculation"),
    "tiers": ("build", "tiers", "lifecycle"),
    "preempt": ("build", "preemption", "chaos"),
    "host": ("build", "host_tier"),
}
assert all(set(m) <= dict(PHASES).keys() for m in MODES.values())


def last_line_kernels(r):
    """The ``kernels`` line: every kernel's row with the contract's keys."""
    return {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": row["launches"],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"],
         **({"note": NOT_PALLAS[name]} if name in NOT_PALLAS else {}),
         **({"entries": row["entries"]} if "entries" in row else {})}
        for name, row in [*r.results.items(), ("dense_matmul", r.dense)]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions in full
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mode, rest = (sys.argv[1], sys.argv[2:]) if sys.argv[1:] else (None, [])
    # Diagnostics, not gates: they print and exit 3 (no result line).
    if mode == "paths":
        paths_diagnostic(torch)
        return 3
    if mode == "profile":
        r = Run(torch, dev)
        unknown = [n for n in rest if n not in RUNS]
        if unknown:
            print(f"profile: unknown runs {unknown}", file=sys.stderr)
            return 2
        profile_serve(torch, r.params_one_arch, *([rest] if rest else []))
        return 3
    if mode == "profile-train":
        archs = rest or ["olmo-1b"]
        unknown = [a for a in archs if a not in PROFILE_TRAIN]
        if unknown:
            print(f"profile-train: unknown {unknown}; one of {sorted(PROFILE_TRAIN)}",
                  file=sys.stderr)
            return 2
        from repro_torch.kernels import build

        build.build()
        write_detail("train_profile.json", {a: profile_train(torch, dev, a) for a in archs})
        return 3
    if mode is not None and (mode not in MODES or rest):
        print(f"chip_smoke: unknown mode {sys.argv[1:]}; one of {sorted(MODES)}, "
              "paths, profile [run ...], profile-train [arch ...]", file=sys.stderr)
        return 2
    r = Run(torch, dev)
    names = MODES[mode] if mode else dict(PHASES)
    for name, phase in PHASES:
        if name in names:
            phase(r)
    if mode:
        write_detail(f"chip_smoke_{mode}.json", {
            "kernels": r.results, "dense_matmul": r.dense, "launches": r.counts,
            "serve": {name: run[1] for name, run in r.runs.items()}, **r.detail,
            "nvidia_smi": nvidia_smi()})
        log(f"{mode}: {time.perf_counter() - r.t_start:.1f}s")
        return 3                 # a partial run: no result line
    smi = nvidia_smi()
    write_detail("chip_smoke.json", {
        "kernels": r.results, "dense_matmul": r.dense,
        "serve": {name: run[1] for name, run in r.runs.items()}, **r.detail,
        "nvidia_smi": smi})
    dense = r.dense
    log(f"total: {time.perf_counter() - r.t_start:.1f}s")
    log(json.dumps({"dense_matmul": {
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/dense_matmul.cu",
        "replaces": None, **{k: dense[k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "entries")}}}))
    log(json.dumps(last_line_kernels(r)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
