"""Carry parameters from the JAX package into the port.

``params_from_numpy(tree, device)`` takes the JAX package's parameter
tree with every array already turned into numpy (``np.asarray`` on the
JAX side) and returns the port's: nested dicts of torch tensors, with a
``PackedWeight`` given as a dict of its arrays plus ``bits``, ``k``,
``n8``, ``a_bits``, ``act_signed`` and ``plane_lo``. Bytes are carried
verbatim (bfloat16 through its 16-bit pattern). Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantized_linear import PackedWeight

_PACKED_META = ("bits", "k", "n8", "a_bits", "act_signed", "plane_lo")


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")     # writable, owned by torch
    if a.dtype.name == "bfloat16":             # ml_dtypes bfloat16
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _is_packed(node) -> bool:
    return isinstance(node, dict) and "packed" in node and "bits" in node


def params_from_numpy(tree, device):
    """Numpy parameter tree (nested dicts) → the port's parameter tree."""
    if _is_packed(tree):
        meta = {k: tree[k] for k in _PACKED_META if k in tree}
        p8 = tree.get("packed8")
        return PackedWeight(
            packed=tensor_from_numpy(tree["packed"], device),
            scale=tensor_from_numpy(tree["scale"], device),
            packed8=None if p8 is None else tensor_from_numpy(p8, device),
            bits=int(meta["bits"]), k=int(meta["k"]), n8=int(meta.get("n8", 0)),
            a_bits=int(meta.get("a_bits", 8)),
            act_signed=bool(meta.get("act_signed", True)),
            plane_lo=int(meta.get("plane_lo", 0)))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
