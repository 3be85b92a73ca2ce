"""The algebra of the chunk-parallel ``wkv6`` kernel (``csrc/wkv6.cu``),
emulated in PyTorch on the CPU, against ``ref.wkv6_chunked_ref`` and the
JAX package.

The kernel spreads a prompt's chunks over thread blocks. One launch
gives each chunk its decay ``D = e^{L_last}`` and its state increment
``U = (k e^{L_last - L})^T v``; a second folds the states in chunk
order, ``S <- D S + U``; a third gives each chunk its outputs from the
state entering it. Inside a chunk, the log-decay prefix ``L`` is summed per
16-token sub-chunk and offset by the sub-chunks before it, and the
pairwise term of a token t and an earlier token s of another sub-chunk
factors through the boundary ``b = 16 J(t) - 1`` (the last token before
t's sub-chunk): ``e^{Lsh_t - L_s} = e^{Lsh_t - L_b} e^{L_b - L_s}``,
both exponents <= 0, so those blocks are plain dot products of scaled r
and k (the kernel chains the k scaling from one boundary to the next in
place). Only the 16 x 16 diagonal blocks keep one exp per (t, s, k).

Tolerance: 1e-5 in float32 against the plain version, JAX and the
sequential recurrence (other summation orders, products of two exps);
at decays of 1e-6 against the sequential recurrence (see
``test_split_algebra_small_decays``). Padding a prompt with 40 pad
tokens (k = 0, w = 1) is bitwise the prompt in the emulation too, as the
kernel's own gate in ``chip_smoke.py`` holds it on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import ref

SUB = 16


def _prefix(lw: torch.Tensor):
    """The log-decay sums of a chunk (C, ...), per 16-token sub-chunk J,
    each summed in order as one thread of the kernel sums it: ``lsh_t``
    the sum before t inside J (Lsh_t - L_b, b the row before J),
    ``sufl_s`` the sum after s inside J (L_b' - L_s, b' J's last row),
    ``tot[J]`` J's total, ``off[J]`` the totals before J (``off[nJ]`` is
    the chunk's L_last) and ``suf[J]`` the totals after J. No exponent is
    the difference of two long prefixes."""
    C = lw.shape[0]
    lsh, sufl, tot = torch.empty_like(lw), torch.empty_like(lw), []
    for j0 in range(0, C, SUB):
        j1 = min(j0 + SUB, C)
        run = torch.zeros_like(lw[0])
        for t in range(j0, j1):
            lsh[t] = run
            run = run + lw[t]
        tot.append(run)
        run = torch.zeros_like(lw[0])
        for t in range(j1 - 1, j0 - 1, -1):
            sufl[t] = run
            run = run + lw[t]
    off = [torch.zeros_like(tot[0])]
    for t_J in tot:
        off.append(off[-1] + t_J)
    suf = [torch.zeros_like(tot[0])]
    for t_J in tot[:0:-1]:
        suf.insert(0, suf[0] + t_J)
    return lsh, sufl, tot, off, suf


def _e(x):
    return torch.exp(torch.clamp(x, max=0.0))


def _chunk_state(k, v, lw):
    """Kernel one: (D (H, K), U (H, K, V)) of one chunk (C, H, ·):
    ``D = e^{L_last}``, ``U = sum_s (k_s e^{L_last - L_s}) v_s^T``."""
    _, sufl, _, off, suf = _prefix(lw)
    khat = torch.empty_like(k)
    for J, j0 in enumerate(range(0, k.shape[0], SUB)):
        sj = slice(j0, j0 + SUB)
        khat[sj] = k[sj] * _e(sufl[sj]) * _e(suf[J])
    return torch.exp(off[-1]), torch.einsum("shk,shv->hkv", khat, v)


def _chunk_out(r, k, v, lw, u, S):
    """Kernel two's outputs (C, H, V) of one chunk from its carried state
    S (H, K, V)."""
    C = r.shape[0]
    lsh, sufl, tot, off, _ = _prefix(lw)
    P = torch.zeros((r.shape[1], C, C))                       # (H, t, s)
    for j0 in range(0, C, SUB):                               # diagonal blocks
        for t in range(j0, min(j0 + SUB, C)):
            P[:, t, t] = (r[t] * u * k[t]).sum(-1)
            acc = torch.zeros_like(lw[0])                     # sum of lw in (s, t)
            for s in range(t - 1, j0 - 1, -1):
                P[:, t, s] = (r[t] * k[s] * _e(acc)).sum(-1)
                acc = acc + lw[s]
    rt = r * _e(lsh)                                          # r e^{Lsh_t - L_b}
    kt = k.clone()
    for J in range(1, -(-C // SUB)):                          # earlier sub-chunks
        j0, prev = SUB * J, SUB * (J - 1)
        tj = slice(j0, min(j0 + SUB, C))
        kt[prev:j0] = k[prev:j0] * _e(sufl[prev:j0])          # k e^{L_b - L_s}
        if J > 1:
            kt[:prev] = kt[:prev] * _e(tot[J - 1])
        P[:, tj, :j0] = torch.einsum("thk,shk->hts", rt[tj], kt[:j0])
    rhat = rt.clone()                                         # r e^{Lsh_t}
    for J in range(1, -(-C // SUB)):
        tj = slice(SUB * J, min(SUB * J + SUB, C))
        rhat[tj] = rt[tj] * _e(off[J])
    return (torch.einsum("thk,hkv->thv", rhat, S)
            + torch.einsum("hts,shv->thv", P, v))


def wkv6_split(r, k, v, w, u, state, chunk: int):
    """The kernel's algebra: r/k/w (B, T, H, K), v (B, T, H, V), u (H,
    K), state (B, H, K, V) → (out (B, T, H, V), state), float32. T is
    padded up to whole chunks with k = v = r = 0 and w = 1."""
    B, T, H, K = r.shape
    C = chunk
    pad = -T % C
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, w))
    if pad:
        def zp(a, value=0.0):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = zp(r), zp(k), zp(v), zp(w, 1.0)
    u = u.to(torch.float32)
    lw = torch.log(torch.clamp(w, min=1e-12))
    outs, finals = [], []
    for b in range(B):
        chunks = [slice(c0, c0 + C) for c0 in range(0, T + pad, C)]
        DU = [_chunk_state(k[b, c], v[b, c], lw[b, c]) for c in chunks]
        S = state[b].to(torch.float32)
        row = []
        for c, (D, U) in zip(chunks, DU):
            row.append(_chunk_out(r[b, c], k[b, c], v[b, c], lw[b, c], u, S))
            S = D[..., None] * S + U
        outs.append(torch.cat(row)[:T])
        finals.append(S)
    return torch.stack(outs), torch.stack(finals)


def _inputs(B, T, H, K, seed, decay=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.5 for _ in range(3))
    w = (np.full((B, T, H, K), decay, np.float32) if decay is not None else
         rng.uniform(0.5, 0.999, (B, T, H, K)).astype(np.float32))
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.3
    return [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]


def _scan(r, k, v, w, u, state):
    """The recurrence token by token (``ref.wkv6_step``): no logs, no
    chunks."""
    outs = []
    for t in range(r.shape[1]):
        o, state = ref.wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, state)
        outs.append(o)
    return torch.stack(outs, dim=1), state


@pytest.mark.parametrize("B,T,H,K,chunk", [
    (2, 64, 2, 16, 64), (1, 100, 2, 16, 64), (2, 70, 1, 16, 32), (1, 33, 2, 32, 32),
    (1, 50, 1, 64, 64), (1, 45, 2, 16, 16)])
def test_split_algebra_matches_the_plain_version(B, T, H, K, chunk):
    """Outputs and final state within 1e-5 of ``ref.wkv6_chunked_ref`` and
    of the sequential recurrence, T not a multiple of the chunk, K = 16."""
    a = _inputs(B, T, H, K, seed=T * 7 + K)
    got = wkv6_split(*a, chunk)
    for want in (ref.wkv6_chunked_ref(*a, chunk), _scan(*a)):
        for g, w_ in zip(got, want):
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,K,chunk,decay", [(64, 16, 16, 1e-6), (130, 8, 16, 1e-6),
                                             (130, 8, 64, 1e-6), (100, 16, 64, 0.05)])
def test_split_algebra_small_decays(T, K, chunk, decay):
    """Decays down to 1e-6, where a chunk's log-decay prefix reaches -221
    (chunk 16) or -884 (chunk 64): within 1e-5 of the sequential
    recurrence, which forms no logs. Every exponent here is a sum of
    sub-chunk-local terms, never the difference of two prefixes, so the
    form is more exact than ``ref.wkv6_chunked_ref``, whose ``L_t - L_s``
    keeps float32's spacing at |L| (1.5e-5 at 221); against it the
    outputs agree within the card gate's 1e-4 at chunk 16."""
    a = _inputs(2, T, 2, K, seed=T + chunk, decay=decay)
    got = wkv6_split(*a, chunk)
    for g, w_ in zip(got, _scan(*a)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-5, atol=1e-5)
    if chunk == 16:
        for g, w_ in zip(got, ref.wkv6_chunked_ref(*a, chunk)):
            np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,chunk", [(64, 16), (40, 16), (96, 32)])
def test_split_algebra_matches_jax(T, chunk):
    """Against JAX's ``rwkv6.wkv6_chunked`` with a carried state, and its
    Pallas ``wkv6`` (interpret mode) from a zero state: within 1e-5."""
    r, k, v, w, u, s0 = _inputs(2, T, 2, 16, seed=T + chunk)
    oj, sj = jrwkv.wkv6_chunked(*(jnp.asarray(x.numpy()) for x in (r, k, v, w, u, s0)),
                                chunk=chunk)
    ot, st = wkv6_split(r, k, v, w, u, s0, chunk)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)
    zero = torch.zeros_like(s0)
    ok = np.asarray(jops.wkv6(*(jnp.asarray(x[0].numpy()) for x in (r, k, v, w)),
                              jnp.asarray(u.numpy()), chunk=chunk))
    np.testing.assert_allclose(wkv6_split(r, k, v, w, u, zero, chunk)[0][0].numpy(), ok,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,chunk", [(100, 64), (37, 16), (64, 32)])
def test_split_algebra_padding_is_bitwise(T, chunk):
    """A prompt and the same prompt followed by 40 pad tokens (k = 0, w =
    1, r and v random) give bitwise equal outputs and final states."""
    r, k, v, w, u, s0 = _inputs(2, T + 40, 2, 16, seed=T)
    k[:, T:] = 0
    w[:, T:] = 1
    exact = wkv6_split(r[:, :T], k[:, :T], v[:, :T], w[:, :T], u, s0, chunk)
    padded = wkv6_split(r, k, v, w, u, s0, chunk)
    assert torch.equal(exact[0], padded[0][:, :T])
    assert torch.equal(exact[1], padded[1])
