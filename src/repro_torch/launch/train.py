"""Training CLI: arch config → model → train state → data pipeline →
fault-tolerant loop (checkpoint/resume, straggler monitor, preemption
saves), on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      [--reduced] [--steps 100] [--global-batch 8] [--seq 128] [--lr 3e-3] \
      [--microbatches 1] [--compress] [--qat w4a8] [--ckpt DIR] \
      [--device cpu]

Port of ``repro.launch.train`` for these flags, with its printed lines.
It runs on CUDA unless ``--device cpu`` is given. ``--qat wXaY`` trains
with fake-quantized block projections (the straight-through gradient);
``--ckpt DIR`` saves every ``steps // 3`` steps (async, keep 2) and
resumes from the newest checkpoint there; ``serve --ckpt DIR`` serves
it. Weights come from a seed (``model.init(seed)``), not JAX's PRNG. Every
ported family trains: the transformers (olmo-1b, nemotron-4-15b,
stablelm-12b, paligemma-3b, hubert-xlarge; the MoE decoders mixtral-8x22b
and llama4-maverick-400b-a17b with their router's load-balance loss),
rwkv6-3b (``--qat`` leaves it
unquantized, as JAX's raw mixers do) and recurrentgemma-9b, the two
recurrences on their backward kernels. ``--fake-devices`` and
``--mesh-shape`` (JAX's data/model mesh) exit: the port's multi-card
tooling is ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--qat", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--fake-devices", type=int, default=0)
    ap.add_argument("--mesh-shape", default=None)
    return ap


def run(args) -> dict:
    """Train as the flags say; returns {"history", "state", "seconds",
    "tokens_per_step", "device"}."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.precision import parse_quant_token
    from repro_torch.data import DataIterator
    from repro_torch.models import build_model
    from repro_torch.train.loop import run_training

    if args.fake_devices or args.mesh_shape:
        raise SystemExit("--fake-devices / --mesh-shape: the port trains on one "
                         "device; its mesh and collectives are ROADMAP Queue 1 item 4")
    device = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if args.qat and args.qat != "none":
        cfg = cfg.with_quant(parse_quant_token(args.qat))
    model = build_model(cfg)
    print(f"mesh: {{'data': 1, 'model': 1}}, "
          f"arch: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")

    tc = TrainConfig(
        lr=args.lr, warmup_steps=min(20, args.steps // 5), total_steps=args.steps,
        microbatches=args.microbatches,
        grad_compress_bits=8 if args.compress else 0,
        log_every=max(1, args.steps // 20),
        checkpoint_every=max(1, args.steps // 3),
    )
    data = DataIterator(cfg, global_batch=args.global_batch, seq_len=args.seq,
                        seed=tc.seed, host_id=0, host_count=1, branch=8)
    mgr = CheckpointManager(args.ckpt, keep=2, async_save=True) if args.ckpt else None

    def hook(step, rec):
        print(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
              f"gnorm {rec['grad_norm']:.2f}  {rec['dt']*1e3:.0f} ms"
              + ("  [STRAGGLER]" if rec.get("straggler") else ""), flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state, history = run_training(model, tc, data, checkpoint_mgr=mgr, hooks=hook,
                                  device=device)
    seconds = time.perf_counter() - t0
    if mgr:
        mgr.wait()
    print(f"done: {len(history)} logged steps, "
          f"final loss {history[-1]['loss']:.4f}")
    out = {"history": history, "state": state, "seconds": seconds,
           "tokens_per_step": args.global_batch * args.seq, "device": str(device)}
    if device.type == "cuda":
        steps = [h["dt"] for h in history]
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        s_step = sorted(steps)[len(steps) // 2]
        print(f"{torch.cuda.get_device_name(device)}: {s_step:.3f} s/step (median of "
              f"{len(steps)} logged), {out['tokens_per_step'] / s_step:.0f} tokens/s, "
              f"peak {out['peak_gb']:.2f} GB")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
