"""Training loop: port of ``repro.train.loop``.

The step factory (gradient-accumulation microbatching in float32,
clipping, int8-compressed gradients with error feedback, AdamW) and a
fault-tolerant runner (checkpoint/resume, straggler monitor,
preemption-safe saves). PyTorch runs eagerly: the step is plain Python
over autograd (JAX jits and donates the state); the optimizer updates the
state's tensors in place (``optim.adamw``).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import adamw
from repro_torch.parallel import collectives


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamState
    err: Any            # error-feedback buffers (None when compression off)


def init_train_state(params, tc: TrainConfig) -> TrainState:
    err = collectives.init_error(params) if tc.grad_compress_bits else None
    return TrainState(params=params, opt=adamw.init_state(params), err=err)


def _split(batch: dict, n: int, i: int) -> dict:
    """Microbatch `i` of `n`: rows [i * b/n, (i + 1) * b/n) of every input."""
    out = {}
    for k, x in batch.items():
        mb = x.shape[0] // n
        out[k] = x[i * mb:(i + 1) * mb]
    return out


def make_train_step(model, tc: TrainConfig) -> Callable:
    """Returns train_step(state, batch) → (state, metrics).

    microbatches > 1 splits the batch on axis 0 and sums the
    microbatches' gradients in float32 (JAX's ``lax.scan``): the
    activation-memory knob beside remat."""
    lr_fn = adamw.cosine_schedule(tc)

    def grad_fn(params, batch):
        flat = tr.leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in flat]
            loss, metrics = model.train_loss(tr.unflatten_like(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        # A leaf the loss never reads (hubert's token embedding) gets 0.
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tr.unflatten_like(params, grads))

    def compute_grads(params, batch):
        if tc.microbatches <= 1:
            return grad_fn(params, batch)
        n = tc.microbatches
        g_acc = tr.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        l_acc = 0.0
        for i in range(n):
            loss, _, g = grad_fn(params, _split(batch, n, i))
            g_acc = tr.map_tree(lambda a, b: a + b.to(torch.float32), g_acc, g)
            l_acc = l_acc + loss
        inv = 1.0 / n
        grads = tr.map_tree(lambda g: g * inv, g_acc)
        loss = l_acc * inv
        return loss, {"loss": loss, "aux_loss": torch.zeros((), dtype=torch.float32,
                                                           device=loss.device)}, grads

    def train_step(state: TrainState, batch):
        loss, metrics, grads = compute_grads(state.params, batch)
        grads, gnorm = adamw.clip_by_global_norm(grads, tc.grad_clip)
        err = state.err
        if tc.grad_compress_bits:
            _, err, grads = collectives.compress_gradients(grads, err,
                                                           bits=tc.grad_compress_bits)
        params, opt, lr = adamw.apply_updates(state.params, grads, state.opt, tc, lr_fn)
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, loss=loss)
        return TrainState(params=params, opt=opt, err=err), metrics

    return train_step


# --------------------------------------------------------------------------
# Fault-tolerant runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor: a step slower than `threshold` times the
    running mean is flagged (the launcher contract is flag → checkpoint →
    evict → restart; here it is logged)."""

    alpha: float = 0.1
    threshold: float = 2.5
    ewma: Optional[float] = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flagged += 1
        return slow


class _PreemptionFlag:
    """SIGTERM → finish the current step, checkpoint, exit cleanly."""

    def __init__(self):
        self.raised = False
        try:
            signal.signal(signal.SIGTERM, self._handle)
        except ValueError:  # non-main thread (tests)
            pass

    def _handle(self, *_):
        self.raised = True


def _wait(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_training(
    model,
    tc: TrainConfig,
    data_iter: Iterator,
    checkpoint_mgr=None,
    init_seed: Optional[int] = None,
    hooks: Optional[Callable[[int, dict], None]] = None,
    device=None,
):
    """End-to-end training with restore-if-present, periodic and
    preemption checkpoints, and straggler monitoring, on `device` (CUDA
    unless named). Weights come from ``model.init(init_seed)`` (default
    ``tc.seed``) unless a committed checkpoint exists; its template is
    drawn on the ``meta`` device (nothing drawn). Returns (state,
    history)."""
    seed = tc.seed if init_seed is None else init_seed
    start_step = 0
    if checkpoint_mgr is not None and checkpoint_mgr.latest_step() is not None:
        state, data_state, start_step = checkpoint_mgr.restore(
            lambda: init_train_state(model.init(seed, "meta"), tc), device=device)
        if data_state is not None and hasattr(data_iter, "set_state"):
            data_iter.set_state(data_state)
    else:
        state = init_train_state(model.init(seed, device), tc)

    step_fn = make_train_step(model, tc)
    monitor = StragglerMonitor()
    preempt = _PreemptionFlag()
    history = []
    for step in range(start_step, tc.total_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _wait(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = monitor.observe(dt)
        if step % tc.log_every == 0 or slow:
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, dt=dt, straggler=slow)
            history.append(rec)
            if hooks:
                hooks(step, rec)
        should_ckpt = checkpoint_mgr is not None and (
            (step + 1) % tc.checkpoint_every == 0 or preempt.raised)
        if should_ckpt:
            data_state = data_iter.get_state() if hasattr(data_iter, "get_state") else None
            checkpoint_mgr.save(step + 1, state, data_state)
        if preempt.raised:
            break
    return state, history
