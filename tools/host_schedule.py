#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s host-tier phases (H1-H4 and the CLI) on
the CPU, at the reduced olmo-1b width but the stream's own lengths,
block size, slots, pools and budgets, and print what they schedule.

  PYTHONPATH=src python tools/host_schedule.py [--out FILE]

The schedule — admissions, preemptions, resumes, spills, swap-ins, host
hits, evictions — depends on the lengths and the pool, not on the
weights or the model's width, so these counters are what the card's run
should show. One count is cut to size: the 512 MiB host budget holds
256 full-width bf16 blocks (496 int8 ones); here it is set to 256 of the
reduced width's bf16 blocks (409 int8 ones), so the int8 phases may
keep fewer blocks only if they ever hold more than 409. The budget case
(8 blocks' bytes) is counted in blocks as on the card. Every gate of
``check_host_tier`` runs as on the card; token gates compare with the
same runs served here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the phases' records as JSON")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousScheduler

    torch.set_num_threads(min(4, torch.get_num_threads()))
    cs.SERVE_ARGS = [("cpu" if a == "cuda" else a) for a in cs.SERVE_ARGS] + ["--reduced"]
    cfg = get_reduced_config("olmo-1b")
    probe = ContinuousScheduler(cfg, build_model(cfg).init(seed=0, device="cpu"),
                                max_batch=1, max_ctx=16, pool_blocks=1, device="cpu",
                                host_pool_bytes=1)
    cs.HOST_BYTES = 256 * probe._host_block_nbytes()
    raw = build_model(cfg).init(seed=0, device="cpu")
    runs = {}
    for name in cs.HOST_REF_RUNS:
        run_args = serve.build_parser().parse_args(cs.serve_argv(name))
        engine, done, report = serve.run(run_args, cs.mixed_requests, params=raw)
        runs[name] = (engine, report, {}, {r.rid: r.out_tokens for r in done})
    shim = types.SimpleNamespace(cuda=types.SimpleNamespace(synchronize=lambda *a: None))
    out = cs.check_host_tier(shim, runs, raw)
    summary = {
        **{p: [{k: r[k] for k in ("identical", "swap_ins", "swap_outs", "host_hit_blocks",
                                  "host_hit_tokens", "host_evictions", "preemptions",
                                  "host_blocks")} for r in out[p]["rounds"]]
           for p in cs.HOST_RUNS},
        "H1/H2 resumes": {p: out[p]["resumes"] for p in cs.HOST_RUNS},
        "H3": {c: {k: r[k] for k in ("identical", "preemptions", "swap_outs", "swap_ins",
                                     "host_hit_tokens", "host_evictions", "resumes")}
               | {"peak_host_blocks": r["host"]["peak_host_bytes"] // r["block_bytes"]}
               for c, r in out["H3"].items()},
        "H4": {k: out["H4"][k] for k in ("digests_saved", "digests_loaded", "identical_a",
                                         "identical_b", "a", "b", "bf16_pool_loaded")},
        "cli": [{k: c[k] for k in ("saved", "loaded", "identical", "swap_ins",
                                   "host_hit_blocks", "host_hit_tokens")} for c in out["cli"]],
    }
    print(json.dumps(summary, indent=1, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
