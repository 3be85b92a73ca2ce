#!/usr/bin/env python3
"""Time the port's matmul, row-quantizer, wkv6, rglru and backward
kernels of two checkouts on one GPU, in turns.

  python3 tools/kernel_ab.py <other checkout> [<this checkout>] [--only name,...]

Builds ``bitplane_matmul``, ``dense_matmul``, ``expert_matmul``, ``fused_matmul``,
``quantize_rows``, ``wkv6``, ``rglru``, ``flash_attention`` and
``flash_attention_bwd`` from each checkout's
``src/repro_torch/kernels/csrc`` and times them at the serving path's
decode and prefill shapes (``wkv6``: a rwkv6-3b prefill of B = 4, T = 320
and a decode step, T = 1 with the state carried; ``rglru``: recurrentgemma-9b's
W = 4096 at B = 4, T = 320, B = 2, T = 2304 (the ring-wrap prompts) and
B = 1, T = 320 with a carried h0 and ragged lengths, and the step, B = 4
through ``ops.rglru_step``, each with a sha256 of its h and h-at-lengths
bytes, so that two checkouts show whether they compute the same bits; the flash backward, bf16
dQ/dK/dV, at olmo-1b's training shape, paligemma's prefix-LM shape and
hubert's bidirectional one; ``wkv6_bwd`` at rwkv6-3b's training shape
(B 8, T 512, H 40, K = V = 64, bf16) and at B 1, each also launch by
launch under torch.profiler; ``rglru_bwd`` at Griffin's training shape
(B 8, T 512, W 4096, bf16 y) with zero and with carried h0 and at B 1,
each beside a device-to-device copy of its bytes; the ``wkv6`` and the
two backward kernels' rows with a sha256 of every output; ``quantize_rows`` and
the Table III leaf through ``ops``, so a checkout whose quantizer reads
float32 only pays its cast of bfloat16 rows; ``expert_matmul`` at
chip_smoke's EXPERT_CASES, NaN in the buffer rows past each count; the
``dense_matmul`` and ``expert_matmul`` rows with a sha256 of their
output), in four processes on the same
card: other, this, this, other (two runs each, so the spread between a
version's two runs shows beside the difference between versions; the
digests of all four runs print after the times). Each
process imports only its own checkout's ``repro_torch``; the timer is
``chip_smoke.Timer`` of this checkout for both (CUDA events, median of
20, L2 flushed before each call). Inputs come from fixed seeds, the same
in every process. Prints one line per shape and writes the numbers to
``$CHIP_SMOKE_OUT/kernel_ab.json`` when that is set. ``--only`` keeps the
named rows of SHAPES (e.g. ``wkv6_bwd,rglru_bwd``) and builds only their
kernels. Needs a CUDA GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kernel, M, K, N, w_bits): the w4a6r25 groups of olmo-1b's w_up and
# w_down, the fused w4a8 w_up, rwkv6-3b's mixers and channel mix.
SHAPES = [("bitplane_matmul", M, K, N, b) for M in (1280, 4)
          for K, N, b in ((2048, 6144, 4), (2048, 2048, 8), (8192, 1536, 4))]
SHAPES += [("fused_matmul", M, 2048, 8192, 4) for M in (4, 1280)]
SHAPES += [("dense_matmul", M, K, N, 16) for M in (4, 1280)
           for K, N in ((2560, 8960), (8960, 2560), (2560, 2560))]
# (wkv6, B, T, H, K): rwkv6-3b's heads, chunk 64.
SHAPES += [("wkv6", 4, T, 40, 64) for T in (320, 1)]
# (quantize_rows, M, K, -, row dtype): a w4a6r25 layer's rows.
SHAPES += [("quantize_rows", M, 2048, 0, dt) for M in (4, 1280) for dt in ("f32", "bf16")]
# (table3, M, K, N, w_bits): olmo-1b's w4a6r25 leaves through
# ops.mixed_group_matmul, bf16 rows: wq/wk/wv, w_gate/w_up, w_down.
SHAPES += [("table3", M, K, N, 4) for M in (4, 1280)
           for K, N in ((2048, 2048), (2048, 8192), (8192, 2048))]
# (rglru, B, T, W, -): recurrentgemma-9b's RG-LRU; T = 1 is the step.
SHAPES += [("rglru", B, T, 4096, 0) for B, T in ((4, 320), (2, 2304), (1, 320), (4, 1))]
# (flash_bwd, B, T, (NQ, NKV, H), prefix_len or -1 for bidirectional).
SHAPES += [("flash_bwd", 8, 512, (16, 16, 128), 0), ("flash_bwd", 4, 576, (8, 1, 256), 256),
           ("flash_bwd", 4, 500, (16, 16, 80), -1)]
# (wkv6_bwd, B, T, H, K): rwkv6-3b's training shape (chunk 64) and one row.
SHAPES += [("wkv6_bwd", B, 512, 40, 64) for B in (8, 1)]
# (rglru_bwd, B, T, W, carried h0): Griffin's training shape with zero and
# with carried h0, and one row.
SHAPES += [("rglru_bwd", 8, 512, 4096, False), ("rglru_bwd", 8, 512, 4096, True),
           ("rglru_bwd", 1, 512, 4096, False)]
# (expert_matmul, (E, rows, top-k), K, N, case): chip_smoke's EXPERT_CASES,
# mixtral's and llama4's expert products at decode and prefill.
SHAPES += [("expert_matmul", (E, rows, k), K, N, case) for case, E, rows, k, K, N in (
    ("mixtral_decode_gate", 8, 4, 2, 6144, 16384),
    ("mixtral_decode_down", 8, 4, 2, 16384, 6144),
    ("mixtral_prefill_gate", 8, 1280, 2, 6144, 16384),
    ("mixtral_prefill_down", 8, 1280, 2, 16384, 6144),
    ("llama4_decode_gate", 128, 4, 1, 5120, 8192),
    ("llama4_prefill_gate", 128, 1280, 1, 5120, 8192))]
# The kernels each SHAPES entry builds (--only takes the entries' names).
BUILDS = {"bitplane_matmul": ("bitplane_matmul",), "fused_matmul": ("fused_matmul",),
          "dense_matmul": ("dense_matmul",), "wkv6": ("wkv6",),
          "quantize_rows": ("quantize_rows",),
          "table3": ("quantize_rows", "bitplane_matmul", "fused_matmul"),
          "rglru": ("rglru",), "flash_bwd": ("flash_attention", "flash_attention_bwd"),
          "wkv6_bwd": ("wkv6", "wkv6_bwd"), "rglru_bwd": ("rglru", "rglru_bwd"),
          "expert_matmul": ("expert_matmul",)}


def _digest(tensors):
    import hashlib

    import torch

    digest = hashlib.sha256()
    for t in tensors:
        if t is not None:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def worker(root: str, only) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch.core.bitplane import pack_weights
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.quantized_linear import pack_weight
    from repro_torch.kernels import (bitplane_matmul, build, dense_matmul, expert_matmul,
                                     flash_attention, flash_attention_bwd, fused_matmul, ops,
                                     rglru, wkv6)
    from repro_torch.models.moe import capacity

    # chip_smoke puts this checkout's src first on sys.path: import it only
    # after the kernels of `root` are loaded.
    sys.path.insert(1, HERE)
    from chip_smoke import (WKV_BWD_LAUNCHES, Timer, _expert_counts, copy_time,
                            device_ms_by_group)

    if not build.__file__.startswith(os.path.join(root, "src")):
        raise RuntimeError(f"imported {build.__file__}, not the checkout {root}")
    shapes = [(i, s) for i, s in enumerate(SHAPES) if only is None or s[0] in only]
    build.build(sorted({k for _, s in shapes for k in BUILDS[s[0]]}))
    dev = torch.device("cuda")
    timer = Timer(torch, dev)
    out, sha = {}, {}
    for i, (name, M, K, N, bits) in shapes:
        gen = torch.Generator(device=dev).manual_seed(i)
        if name == "wkv6_bwd":
            B, T, H, Kh = M, K, N, bits
            r, k, v = (torch.randn((B, T, H, Kh), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            w = torch.exp(torch.rand((B, T, H, Kh), generator=gen, device=dev) * -4.6)
            u = torch.randn((H, Kh), generator=gen, device=dev) * 0.5
            s0 = torch.zeros((B, H, Kh, Kh), device=dev)
            do = torch.randn((B, T, H, Kh), generator=gen, device=dev)
            _, _, st = wkv6.launch(r, k, v, w, u, s0, chunk=64, states=True)
            fn = lambda: wkv6.launch_bwd(r, k, v, w, u, st, do, chunk=64)  # noqa: E731
            key = f"wkv6_bwd B={B} T={T} H={H} K=V={Kh} bf16"
            out[key] = timer(fn)
            for part, ms in device_ms_by_group(torch, fn, WKV_BWD_LAUNCHES).items():
                out[f"{key} [{part}, profiler]"] = ms
            sha[key] = _digest(fn())
            continue
        if name == "expert_matmul":
            (E, rows, k), case = M, bits
            cap = capacity(rows, k, E, 1.25)
            counts = _expert_counts(torch, torch.Generator().manual_seed(i), E, rows, k,
                                    skew=rows > 64).to(dev)
            w = torch.randn((E, K, N), generator=gen, device=dev,
                            dtype=torch.bfloat16) * K ** -0.5
            xe = torch.randn((E, cap, K), generator=gen, device=dev, dtype=torch.bfloat16)
            live = torch.arange(cap, device=dev)[None, :] < counts.clamp(max=cap)[:, None]
            xe = torch.where(live[..., None], xe, torch.full_like(xe, float("nan")))
            fn = lambda: expert_matmul.launch(xe, w, counts)  # noqa: E731
            key = f"expert_matmul {case} E={E} cap={cap} {K}->{N}"
            out[key] = timer(fn)
            sha[key] = _digest([fn()])
            del w, xe, fn
            continue
        if name == "rglru_bwd":
            B, T, W, carried = M, K, N, bits
            ga, gi = (torch.randn((B, T, W), generator=gen, device=dev) for _ in range(2))
            y = torch.randn((B, T, W), generator=gen, device=dev).to(torch.bfloat16)
            ab, ib = (torch.randn(W, generator=gen, device=dev) * 0.1 for _ in range(2))
            lam = torch.rand(W, generator=gen, device=dev) * 6 - 3
            h0 = torch.randn((B, W), generator=gen, device=dev) if carried else None
            dh = torch.randn((B, T, W), generator=gen, device=dev)
            h, _ = rglru.launch(ga, gi, y, ab, ib, lam, h0)
            fn = lambda: rglru.launch_bwd(ga, gi, y, ab, ib, lam, h0, h, dh)  # noqa: E731
            key = f"rglru_bwd B={B} T={T} W={W} h0={'carried' if carried else 'zero'}"
            out[key] = timer(fn)
            sha[key] = _digest(fn())
            # Its bytes' yardstick: 28 bytes an element, read and written.
            out[f"copy of {key}'s bytes"] = copy_time(torch, dev, timer, 28 * B * T * W)
            continue
        if name == "rglru":
            B, T, W = M, K, N
            ga, gi = (torch.randn((B, T, W), generator=gen, device=dev) for _ in range(2))
            y = torch.randn((B, T, W), generator=gen, device=dev).to(torch.bfloat16)
            ab, ib = (torch.randn(W, generator=gen, device=dev) * 0.5 for _ in range(2))
            lam = torch.rand(W, generator=gen, device=dev) + 0.1
            h0 = torch.randn((B, W), generator=gen, device=dev)
            if T == 1:
                key = f"rglru step B={B} W={W} (ops.rglru_step)"
                fn = lambda: (ops.rglru_step(ga[:, 0], gi[:, 0], y[:, 0], ab,  # noqa: E731
                                             ib, lam, h0),)
            else:
                key = f"rglru B={B} T={T} W={W} bf16 y"
                lengths = torch.tensor([T, T - 7, 1, T // 2][:B], dtype=torch.int32,
                                       device=dev)
                fn = lambda: rglru.launch(ga, gi, y, ab, ib, lam, h0, lengths)  # noqa: E731
            out[key] = timer(fn)
            sha[key] = _digest(fn())
            continue
        if name == "wkv6":
            B, T, H, Kh = M, K, N, bits
            r, k, v = ((torch.randn((B, T, H, Kh), generator=gen, device=dev) * 0.5)
                       .to(torch.bfloat16) for _ in range(3))
            w = torch.rand((B, T, H, Kh), generator=gen, device=dev) * 0.499 + 0.5
            u = torch.randn((H, Kh), generator=gen, device=dev) * 0.5
            s0 = torch.randn((B, H, Kh, Kh), generator=gen, device=dev) * 0.3
            fn = lambda: wkv6.launch(r, k, v, w, u, s0, chunk=64)  # noqa: E731
            key = f"wkv6 B={B} T={T} H={H} K=V={Kh}"
            out[key] = timer(fn)
            sha[key] = _digest(fn())
            continue
        if name == "flash_bwd":
            B, T, (NQ, NKV, H), P = M, K, N, bits
            q, do = (torch.randn((B, T, NQ, H), generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(2))
            k, v = (torch.randn((B, T, NKV, H), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            kw = dict(causal=P >= 0, window=0, q_offset=0, prefix_len=max(P, 0))
            o = flash_attention.launch(q, k, v, **kw)
            fn = lambda: flash_attention_bwd.launch(q, k, v, o, do, **kw)  # noqa: E731
            mask = "bidirectional" if P < 0 else f"prefix-LM {P}" if P else "causal"
            out[f"flash_attention_bwd B*NQ={B * NQ} NKV={NKV} T={T} H={H} {mask}"] = timer(fn)
            continue
        if name == "quantize_rows":
            dtype = torch.float32 if bits == "f32" else torch.bfloat16
            x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            fn = lambda: ops.quantize_rows(x, bits=6, signed=True)  # noqa: E731
            out[f"quantize_rows M={M} K={K} a6 {bits} rows"] = timer(fn)
            continue
        if name == "table3":
            w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
            pw = pack_weight(w, QuantConfig(w_bits=4, a_bits=6, mixed_ratio_8b=0.25))
            args = (pw.packed8, pw.packed, pw.scale[:, :pw.n8], pw.scale[:, pw.n8:])
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            fn = lambda: ops.mixed_group_matmul(x, *args, w_bits=4, a_bits=6)  # noqa: E731
            out[f"mixed_group_matmul M={M} {K}->{N} w4a6r25 bf16"] = timer(fn)
            continue
        if name == "dense_matmul":
            w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            fn = lambda: dense_matmul.launch(x, w)  # noqa: E731
            sha[f"{name} M={M} {K}->{N} bf16"] = _digest([fn()])
        else:
            half = 1 << (bits - 1)
            codes = torch.randint(-half, half, (K, N), generator=gen, device=dev,
                                  dtype=torch.int32)
            packed = pack_weights(codes, bits, axis=0)
            if name == "bitplane_matmul":
                xq = torch.randint(-32, 32, (M, K), generator=gen, device=dev,
                                   dtype=torch.int32).to(torch.int8)
                fn = lambda: bitplane_matmul.launch(  # noqa: E731
                    xq, packed, w_bits=bits, a_bits=6, act_signed=True, w_plane_lo=0)
            else:
                x = torch.randn((M, K), generator=gen, device=dev)
                fn = lambda: fused_matmul.launch(  # noqa: E731
                    x, packed, w_bits=bits, a_bits=8, act_signed=True, w_plane_lo=0)
        dtype = "bf16" if name == "dense_matmul" else f"w{bits}"
        out[f"{name} M={M} {K}->{N} {dtype}"] = timer(fn)
    print(json.dumps({"ms": out, "sha256": sha}))


def main() -> int:
    args = sys.argv[1:]
    only = None
    if "--only" in args:
        at = args.index("--only")
        only = args[at + 1].split(",")
        del args[at:at + 2]
        unknown = [n for n in only if n not in BUILDS]
        if unknown:
            print(f"--only: unknown {unknown}; one of {sorted(BUILDS)}", file=sys.stderr)
            return 2
    if args[:1] == ["--worker"]:
        worker(args[1], only)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(args[0])
    this = os.path.abspath(args[1]) if args[1:] else HERE
    runs = []
    for label, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root]
                             + (["--only", ",".join(only)] if only else []),
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{'shape':42s} {'other ms (2 runs)':>22s} {'this ms (2 runs)':>22s}  this/other")
    table, digests = {}, {}
    for key in runs[0][1]["ms"]:
        o = [r["ms"][key] for lab, r in runs if lab == "other"]
        t = [r["ms"][key] for lab, r in runs if lab == "this"]
        table[key] = {"other_ms": o, "this_ms": t}
        print(f"{key:42s} {o[0]:10.4f} {o[1]:10.4f}  {t[0]:10.4f} {t[1]:10.4f}  "
              f"{min(t) / min(o):9.3f}")
    for key in runs[0][1]["sha256"]:
        got = {lab: [r["sha256"][key] for lb, r in runs if lb == lab]
               for lab in ("other", "this")}
        digests[key] = got
        same = len({d for ds in got.values() for d in ds}) == 1
        print(f"{key}: sha256 other {got['other'][0][:16]} this {got['this'][0][:16]}: "
              f"{'equal in all four runs' if same else 'DIFFER'}")
    print(smi)
    dest = os.environ.get("CHIP_SMOKE_OUT")
    if dest:
        os.makedirs(dest, exist_ok=True)
        with open(os.path.join(dest, "kernel_ab.json"), "w") as f:
            json.dump({"other": other, "this": this, "nvidia_smi": smi, "ms": table,
                       "sha256": digests}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
