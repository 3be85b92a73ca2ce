"""Self-speculative decoding from the resident bit-plane weights.

Port of ``repro.serving.speculative``. Weights are stored as
little-endian 2-bit planes (``repro_torch.core.bitplane``), so a
low-precision *draft* model is already resident: contracting only the
top planes of the packed w8 weights is a w4/w2 forward pass with zero
extra weight memory. This module is the policy half of that subsystem:

  * :func:`derive_draft_params` — the serving params as a draft view:
    ``plane_lo`` set on every packed leaf stored above the draft width
    (:func:`repro_torch.core.precision.truncate_policy_view`). Every
    tensor of the view is the target's own, so the draft costs no
    device memory.
  * :func:`greedy_accept` — the acceptance rule. Every emitted token is
    a full-policy verify argmax (the draft only decides *how many* of
    them land per round), which is why greedy speculation is bitwise
    identical to non-speculative greedy decode.

The scheduling half lives in ``ContinuousScheduler._spec_phase``: draft
k tokens per eligible slot with the view params (speculative K/V written
into the row's own pool blocks), verify the ``[current token, drafts]``
windows through ``prefill_chunk_logits_multi`` (its K/V writes overwrite
the draft's) and roll back positions for the rejected tail
(:func:`repro_torch.models.kv_cache.set_decode_positions`).

Plane math: a w8 leaf served at w4 drops ``lo = (8-4)/2 = 2`` planes, at
w2 drops 3; a w4 leaf served at w2 drops 1.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

from repro_torch.core.precision import (  # noqa: F401  (re-exported, as in repro)
    PLANE_BITS,
    parse_tier_token,
    plane_offset,
    truncate_policy_view,
)
from repro_torch.core.quant import QuantConfig


def parse_draft_spec(spec: Union[str, QuantConfig]) -> QuantConfig:
    """Normalize a ``--draft-policy`` value ("w2a8" / "w4a8" or an
    already-built QuantConfig). Drafts are pure plane truncations, so the
    Table-III mixed-group ratio ("rZZ") is refused, as for a tier."""
    return parse_tier_token(spec)


def derive_draft_params(params, draft: Union[str, QuantConfig]) -> Tuple[object, int]:
    """Draft-policy view of served params: every PackedWeight leaf whose
    precision exceeds the draft's gets ``plane_lo`` set so its matmuls
    contract only the top planes. Returns ``(draft_params, truncated)``.

    The view shares every tensor with the target params by identity
    (``draft.packed is target.packed``). Raises if the params carry no
    packed leaves (serve with a quant policy first) or if the draft
    truncates nothing (target already at or below draft precision)."""
    return truncate_policy_view(params, parse_draft_spec(draft),
                                require_truncation=True)


def greedy_accept(verify_tokens: Sequence[int],
                  draft_tokens: Sequence[int]) -> List[int]:
    """Longest-matching-prefix acceptance for greedy speculation.

    ``verify_tokens[i]`` is the full-policy argmax at chunk position i of
    the verify call over ``[current token, d_1 .. d_k]`` — the token
    greedy decode would emit after accepting the first i draft tokens.
    Accept while ``d_{i+1} == verify_tokens[i]``; the returned list is
    ``[g_0, .., g_m]``, every element a *verify* argmax (between 1 and
    k+1 tokens — the last is the free "bonus" token when all drafts
    match). The draft never contributes a token, only the count."""
    emitted = [int(verify_tokens[0])]
    for i, d in enumerate(draft_tokens):
        if int(d) != emitted[-1]:
            break
        emitted.append(int(verify_tokens[i + 1]))
    return emitted
