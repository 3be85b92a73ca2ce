"""Helpers for the parity tests of the PyTorch port against the JAX package:
turn JAX parameter trees into the numpy trees ``repro_torch.convert``
takes, and compare port trees with them."""
from __future__ import annotations

import numpy as np
import torch

from repro.core.quantized_linear import PackedWeight as JaxPacked
from repro_torch.core.quantized_linear import PackedWeight as TorchPacked

# The suite runs in several worker processes at once; the port's tensors
# here are tiny, and one intra-op thread per worker keeps PyTorch from
# oversubscribing the cores the JAX tests share.
torch.set_num_threads(1)


def to_numpy_tree(tree):
    """JAX params (nested dicts, PackedWeight leaves) → numpy tree."""
    if isinstance(tree, JaxPacked):
        return {"packed": np.asarray(tree.packed), "scale": np.asarray(tree.scale),
                "packed8": None if tree.packed8 is None else np.asarray(tree.packed8),
                "bits": tree.bits, "k": tree.k, "n8": tree.n8, "a_bits": tree.a_bits,
                "act_signed": tree.act_signed, "plane_lo": tree.plane_lo}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def np_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, '/'-joined paths."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def assert_packed_equal(jp: JaxPacked, tp: TorchPacked, path: str = ""):
    assert (jp.bits, jp.k, jp.n8, jp.a_bits, jp.act_signed, jp.plane_lo) == (
        tp.bits, tp.k, tp.n8, tp.a_bits, tp.act_signed, tp.plane_lo), path
    assert np.array_equal(np.asarray(jp.packed), tp.packed.numpy()), path
    assert np.array_equal(np.asarray(jp.scale), tp.scale.numpy()), path
    if jp.packed8 is None:
        assert tp.packed8 is None, path
    else:
        assert np.array_equal(np.asarray(jp.packed8), tp.packed8.numpy()), path


def synced(jax_scheduler):
    """`jax_scheduler` with each ``step()`` waited out on the device before
    it returns. Under the CPU backend's asynchronous dispatch a chunk the
    JAX scheduler dispatched last in a step may still be queued when the
    next step rewrites its host block table (a cancel or deadline
    retirement sets the row to -1), and that chunk then writes a block it
    does not own; waiting after each step keeps the reference's runs
    deterministic. The port's scheduler copies host state before it
    hands it to a kernel."""
    import jax

    step = jax_scheduler.step

    def synced_step():
        out = step()
        jax.block_until_ready(jax_scheduler.cache)
        return out

    jax_scheduler.step = synced_step
    return jax_scheduler
