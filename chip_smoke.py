#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

1. Builds the three CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it: integers (accumulators, activation
   scales, int8 pool bytes, scale planes) bitwise; float attention
   outputs within atol = rtol = 2e-2 (bf16 outputs; summation order and
   expf differ between a one-pass softmax and the online one).
3. Times each kernel, its plain version and one PyTorch library call on
   the same inputs (CUDA events, median of 20, L2 flushed before each).
4. Serves full-size olmo-1b (random weights from a seed, policy
   "w4a8;wo=w8a8") through ``repro_torch.launch.serve`` with a bf16 and
   an int8 KV pool: 8 requests with prompts of 64-320 tokens, 32 new
   tokens each, 4 slots, 16-token blocks, 32-token prefill chunks. Every
   kernel must have launched during those runs. Checks that a greedy
   request served alone and the same request admitted mid-decode emit
   identical tokens, and that a small float32 model gives the same
   logits on the card (kernels) as on the CPU (plain versions).

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Any
failed check raises, so the exit code is non-zero and no result prints.
With ``CHIP_SMOKE_OUT=<dir>`` set, the detailed numbers are also
written to ``<dir>/chip_smoke.json``. ``python3 chip_smoke.py profile``
instead profiles one serve pass (see ``profile_serve``) and exits 3.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12     # dense bf16 tensor-core peak
ATOL = RTOL = 2e-2
POLICY = "w4a8;wo=w8a8"
REPLACES = {
    "fused_quantize_matmul": "src/repro/kernels/fused_matmul.py:114",
    "paged_attention": "src/repro/kernels/paged_attention.py:119",
    "paged_prefill": "src/repro/kernels/paged_prefill.py:172",
}
SOURCES = {
    "fused_quantize_matmul": "src/repro_torch/kernels/csrc/fused_matmul.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_prefill": "src/repro_torch/kernels/csrc/paged_prefill.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median CUDA-event time of `fn` over `iters` calls, with the L2
    cache flushed (a 128 MB write) before each timed call."""

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
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


# -- kernels against their plain versions ------------------------------------

def check_fused(torch, dev, timer):
    from repro_torch.core.bitplane import pack_weights, unpack_weights
    from repro_torch.kernels import fused_matmul, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = 0
    for M in (4, 32):
        for K, N in ((2048, 2048), (2048, 8192), (8192, 2048)):
            for bits in (2, 4, 8):
                lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
                codes = torch.randint(lo, hi, (K, N), generator=gen, device=dev,
                                      dtype=torch.int32)
                packed = pack_weights(codes, bits, axis=0)
                x = torch.randn((M, K), generator=gen, device=dev)
                for a_bits, signed in ((8, True), (4, False)):
                    xs = x if signed else x.abs()
                    for plane_lo in ((0, 1) if bits > 2 else (0,)):
                        kw = dict(w_bits=bits, a_bits=a_bits, act_signed=signed,
                                  w_plane_lo=plane_lo)
                        acc, s = fused_matmul.launch(xs, packed, **kw)
                        acc_r, s_r = ref.fused_quantize_matmul_ref(xs, packed, **kw)
                        torch.cuda.synchronize()
                        if not (torch.equal(acc, acc_r) and torch.equal(s, s_r)):
                            bad = (acc != acc_r).sum().item()
                            raise AssertionError(
                                f"fused M={M} K={K} N={N} w{bits} a{a_bits} "
                                f"signed={signed} lo={plane_lo}: {bad} acc "
                                f"mismatches, scales equal={torch.equal(s, s_r)}")
                        cases += 1
    log(f"fused_quantize_matmul: {cases} cases bitwise equal to the plain version")

    # Timing at the decode shape of w_up/w_gate (M=4, 2048 -> 8192, w4a8).
    M, K, N = 4, 2048, 8192
    codes = torch.randint(-8, 8, (K, N), generator=gen, device=dev, dtype=torch.int32)
    packed = pack_weights(codes, 4, axis=0)
    x = torch.randn((M, K), generator=gen, device=dev)
    kw = dict(w_bits=4, a_bits=8, act_signed=True, w_plane_lo=0)
    w_bf16 = (unpack_weights(packed, 4).float() * 0.01).to(torch.bfloat16)
    x_bf16 = x.to(torch.bfloat16)
    ms = timer(lambda: fused_matmul.launch(x, packed, **kw))
    plain_ms = timer(lambda: ref.fused_quantize_matmul_ref(x, packed, **kw))
    lib_ms = timer(lambda: torch.matmul(x_bf16, w_bf16))
    nbytes = M * K * 4 + K * N * 4 // 8 + M * N * 4 + M * 4
    b_ms, b_by = bound_ms(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "cases": cases,
            "shape": f"M={M} K={K} N={N} w4a8"}


def _pool(torch, dev, gen, nb, bs, nkv, H, quant):
    kf = torch.randn((nb, bs, nkv, H), generator=gen, device=dev)
    vf = torch.randn((nb, bs, nkv, H), generator=gen, device=dev)
    if quant:
        from repro_torch.models.kv_cache import quantize_kv

        pk, ks = quantize_kv(kf)
        pv, vs = quantize_kv(vf)
        return pk, pv, ks, vs
    return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None


def _close(torch, got, want, what):
    g, w = got.float(), want.float()
    if not torch.allclose(g, w, atol=ATOL, rtol=RTOL):
        err = (g - w).abs().max().item()
        raise AssertionError(f"{what}: max |err| {err} beyond atol=rtol={ATOL}")
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
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_err,
            "shape": f"B={B} ctx={ctx} NQ=NKV={nkv} H={H} bs={bs} bf16"}


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
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_err,
            "shape": f"Lc={Lc} start={start} NQ=NKV={nkv} H={H} bs={bs} bf16"}


# -- the serving path ---------------------------------------------------------

def mixed_requests(cfg, args):
    """8 requests with prompts of 64-320 tokens (greedy and temperature
    0.7 alternating), all queued at t=0; the same stream on every call."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    lens = (64, 320, 128, 256, 96, 192, 288, 160)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int64),
                    max_new_tokens=args.max_new,
                    temperature=0.0 if i % 2 == 0 else 0.7)
            for i, n in enumerate(lens)]


def serve_olmo(torch, params, kv_int8: bool):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--policy", POLICY, "--continuous",
            "--requests", "8", "--max-new", "32", "--max-batch", "4",
            "--block-size", "16", "--prefill-budget", "32", "--device", "cuda"]
    if kv_int8:
        argv.append("--kv-int8")
    args = serve.build_parser().parse_args(argv)
    ops.reset_launch_counts()
    engine, done, report = serve.run(args, mixed_requests, params=params)
    counts = ops.launch_counts()
    vocab = engine.cfg.vocab
    for r in done:
        if r.error or len(r.out_tokens) != 32 or not all(0 <= t < vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: bad output {r.error} {r.out_tokens}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched while serving (kv_int8={kv_int8})")
    log(f"serve olmo-1b kv_int8={kv_int8}: {report['tok_per_s']:.1f} tok/s "
        f"steady state, launches {counts}")
    return engine, report, counts


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
                                   block_size=16, prefill_budget=32, device="cuda")

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


def card_vs_cpu(torch):
    """Reduced olmo-1b in float32: one prefill chunk and two decode steps
    on the card (kernels) vs on the CPU (plain versions), logits within
    1e-2 (a product within an ULP of a rounding boundary may quantize an
    activation one code apart on the two devices)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.precision import parse_policy_spec
    from repro_torch.core.quantized_linear import quantize_params_for_serving
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_reduced_config("olmo-1b"), dtype="float32")
    model = build_model(cfg)
    params = quantize_params_for_serving(model.init(seed=0, device="cpu"),
                                         parse_policy_spec(POLICY), min_size=1024)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
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
        out[dev] = torch.cat([lg.reshape(1, -1) for lg in lgs]).cpu()
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    if not err <= 1e-2:
        raise AssertionError(f"reduced fp32 model: card vs CPU logits differ by {err}")
    return err


def _to(tree, dev):
    from repro_torch.core.quantized_linear import PackedWeight

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return dataclasses.replace(
            tree, packed=tree.packed.to(dev), scale=tree.scale.to(dev),
            packed8=None if tree.packed8 is None else tree.packed8.to(dev))
    return tree.to(dev)


def profile_serve(torch, params):
    """`chip_smoke.py profile`: one warm bf16 serve pass of the stream
    above under torch.profiler. Prints device time by kernel name, the
    device-busy share of the pass's wall time, and writes the table to
    profile.json under $CHIP_SMOKE_OUT. Not part of the default run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--policy", POLICY, "--continuous",
            "--requests", "8", "--max-new", "32", "--max-batch", "4",
            "--block-size", "16", "--prefill-budget", "32", "--device", "cuda"]
    args = serve.build_parser().parse_args(argv)
    engine, _, report = serve.run(args, mixed_requests, params=params)
    sched = engine.scheduler()
    chunks0, steps0 = sched.prefill_chunks_run, sched.steps_run
    reqs = mixed_requests(engine.cfg, args)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # Kernel rows only: an operator's row repeats its kernels' time.
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
           "tokens": sum(len(r.out_tokens) for r in reqs),
           "decode_steps": sched.steps_run - steps0,
           "prefill_chunks": sched.prefill_chunks_run - chunks0,
           "untimed_pass_tok_per_s": report["tok_per_s"],
           "kernels": [{"name": k, "device_ms": us / 1e3, "calls": n}
                       for k, us, n in rows[:40]]}
    log(f"profiled pass: wall {wall:.2f}s, device busy {busy:.2f}s "
        f"({busy / wall:.0%}), {out['decode_steps']} decode steps, "
        f"{out['prefill_chunks']} chunks")
    for r in out["kernels"][:20]:
        log(f"  {r['device_ms']:9.1f} ms  {r['calls']:6d}  {r['name'][:90]}")
    write_detail("profile.json", out)


def write_detail(name: str, data) -> None:
    """Write `data` as JSON to $CHIP_SMOKE_OUT/`name`, if that is set."""
    out = os.environ.get("CHIP_SMOKE_OUT")
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, name), "w") as f:
            json.dump(data, f, indent=1, default=str)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    if sys.argv[1:] == ["profile"]:
        profile_serve(torch, build_model(get_config("olmo-1b")).init(seed=0, device=dev))
        return 3                 # a partial run: no result line
    t0 = time.perf_counter()
    paths = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f}s "
        f"(nvcc {build.build_seconds:.1f}s, parallel), libraries: "
        + ", ".join(str(p) for p in paths.values()))
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    timer = Timer(torch, dev)
    results = {
        "fused_quantize_matmul": check_fused(torch, dev, timer),
        "paged_attention": check_paged_attention(torch, dev, timer),
        "paged_prefill": check_paged_prefill(torch, dev, timer),
    }
    results["fused_quantize_matmul"]["max_abs_err"] = 0.0
    params = build_model(get_config("olmo-1b")).init(seed=0, device=dev)
    counts = {k: 0 for k in results}
    serve_reports = {}
    engines = {}
    for kv_int8 in (False, True):
        engine, report, c = serve_olmo(torch, params, kv_int8)
        engines[kv_int8] = engine
        serve_reports["int8" if kv_int8 else "bf16"] = report
        for k in counts:
            counts[k] += c[k]
    for k in results:
        results[k]["launches"] = counts[k]
    for kv_int8, engine in engines.items():
        toks = solo_vs_mid_decode(engine)
        log(f"solo == mid-decode admission (kv_int8={kv_int8}): "
            f"{len(toks)} greedy tokens identical")
    err = card_vs_cpu(torch)
    log(f"reduced fp32 model: card vs CPU logits max |err| {err:.3g}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    write_detail("chip_smoke.json", {"kernels": results, "serve": serve_reports,
                                     "card_vs_cpu_max_err": err,
                                     "nvidia_smi": smi})
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in results.items()]}
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
