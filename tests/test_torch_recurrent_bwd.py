"""The design of the two recurrences' backward kernels, held on the CPU.

``csrc/wkv6_bwd.cu`` factors a chunk's off-diagonal blocks through
sub-chunk boundaries, as the forward (``csrc/wkv6.cu``) does: for t in
sub-chunk Jt and s in an earlier Js, the gate e^(Lsh_t - L_s) is e^(p_t)
F(Js, Jt) e^(q_s), with p_t the sum of lw before t inside Jt, q_s the sum
after s inside Js and F the totals of the sub-chunks between them. So
dr's A_off K̃, dk's A_offᵀ R̃, P = R̃ K̃ᵀ and dv's Pᵀ dout are plain
products of r e^p and k e^q, the F factors chained Horner-wise over the
sub-chunks; only the diagonal blocks keep a walk with one exp per (t, s,
k). :func:`wkv6_bwd_factored` is that walk in float32, step for step as a
thread of the kernel owns (sub-chunk, k), at the kernel's 8-row
sub-chunks and at the forward's 16; the tests hold it against
``ref.wkv6_chunked_bwd_ref`` within chip_smoke's ``WKV_BWD_TOL["f32"]``
of max |g| (d(log w) as w·dw), with every exponent it forms <= 0.

``csrc/rglru_bwd.cu`` streams a row's channels through a ring of stages
tiled by :func:`rglru.plan_bwd`; its tests are the plan's.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, rglru

TOL = 1e-4          # chip_smoke.WKV_BWD_TOL["f32"]


class Exps:
    """exp() that records the largest exponent it was given."""

    def __init__(self):
        self.most = -float("inf")

    def __call__(self, x):
        self.most = max(self.most, float(x.max()))
        return torch.exp(x)


def _chunk_bwd(rb, kb, vb, lw, db, u, S, G, ex, SUB):
    """One chunk's gradients as the chunk kernel computes them, sub-chunks
    of SUB rows: rows (B, R, H, .) with R a multiple of SUB, pads zero (lw
    0). Returns dr, dk, dv, d(lw) (B, R, H, .), du (H, K), and the W_c and
    D_c of the state kernel."""
    B, R, H, K = rb.shape
    NS = R // SUB
    seg = [slice(J * SUB, (J + 1) * SUB) for J in range(NS)]
    # Per (sub-chunk, k): p = the sum of lw before t inside J, q = after s
    # inside J, tot = J's total, summed in row order by one thread.
    p, q = torch.zeros_like(lw), torch.zeros_like(lw)
    tot = []
    for J in range(NS):
        run = torch.zeros_like(lw[:, 0])
        for t in range(J * SUB, (J + 1) * SUB):
            p[:, t] = run
            run = run + lw[:, t]
        tot.append(run)
        run = torch.zeros_like(lw[:, 0])
        for t in reversed(range(J * SUB, (J + 1) * SUB)):
            q[:, t] = run
            run = run + lw[:, t]
    off = [sum(tot[:J], torch.zeros_like(tot[0])) for J in range(NS)]
    suf = [sum(tot[J + 1:], torch.zeros_like(tot[0])) for J in range(NS)]
    last = sum(tot, torch.zeros_like(tot[0]))

    def per_row(xs):          # (B, H, K) per sub-chunk -> (B, R, H, K)
        return torch.cat([x[:, None].expand(B, SUB, H, K) for x in xs], 1)

    # The state kernel: W_c = sum_t (r_t e^Lsh_t) dout_t^T, D_c = e^L_last.
    Wc = torch.einsum("bthk,bthv->bhkv", rb * ex(p + per_row(off)), db)
    Dc = ex(last)

    A = torch.einsum("bthv,bshv->bhts", db, vb)                 # dout_t . v_s
    Ad = torch.diagonal(A, dim1=2, dim2=3).permute(0, 2, 1)[..., None]   # (B, R, H, 1)
    c0s = Dc * (G * S).sum(-1)
    # The dk side: the state part, then the gated sum (off-diagonal
    # sub-chunks chained from the last down, then the diagonal walk).
    dks = ex(q + per_row(suf)) * torch.einsum("bshv,bhkv->bshk", vb, G)
    Rh, Kh = rb * ex(p), kb * ex(q)
    dkin = torch.zeros_like(kb)
    for J in range(NS):
        acc = torch.zeros_like(kb[:, seg[J]])
        for Jt in reversed(range(J + 1, NS)):
            acc = acc * ex(tot[Jt])[:, None] + torch.einsum(
                "bhts,bthk->bshk", A[:, :, seg[Jt], seg[J]], Rh[:, seg[Jt]])
        dkin[:, seg[J]] = ex(q[:, seg[J]]) * acc
    # The dr side likewise, chained from the first sub-chunk up.
    dr1 = ex(p + per_row(off)) * torch.einsum("bthv,bhkv->bthk", db, S)
    drin = torch.zeros_like(rb)
    for J in range(NS):
        acc = torch.zeros_like(rb[:, seg[J]])
        for Js in range(J):
            acc = acc * ex(tot[Js])[:, None] + torch.einsum(
                "bhts,bshk->bthk", A[:, :, seg[J], seg[Js]], Kh[:, seg[Js]])
        drin[:, seg[J]] = ex(p[:, seg[J]]) * acc
    # The diagonal blocks: a thread per (J, k) walks s from t - 1 down,
    # the exponent summed over s < j < t as it goes; P's diagonal block
    # (summed over k) from the same gates.
    P = torch.zeros((B, H, R, R), dtype=rb.dtype)
    for J in range(NS):
        for t in range(J * SUB, (J + 1) * SUB):
            acc = torch.zeros_like(lw[:, 0])
            for s in range(t - 1, J * SUB - 1, -1):
                g = ex(acc)
                a = A[:, :, t, s][..., None]
                drin[:, t] = drin[:, t] + a * kb[:, s] * g
                dkin[:, s] = dkin[:, s] + a * rb[:, t] * g
                P[:, :, t, s] = (rb[:, t] * kb[:, s] * g).sum(-1)
                acc = acc + lw[:, s]
            P[:, :, t, t] = (rb[:, t] * u * kb[:, t]).sum(-1)
    # P's off-diagonal blocks: r e^p . F k e^q over k.
    for Jt in range(NS):
        for Js in range(Jt):
            F = ex(sum(tot[Js + 1:Jt], torch.zeros_like(tot[0])))
            P[:, :, seg[Jt], seg[Js]] = torch.einsum(
                "bthk,bhk,bshk->bhts", Rh[:, seg[Jt]], F, Kh[:, seg[Js]])
    drg = dr1 + drin
    dr = drg + Ad * u * kb
    dk = dkin + dks + Ad * u * rb
    khat = Kh * ex(per_row(suf))
    dv = torch.einsum("bhts,bthv->bshv", P, db) + torch.einsum("bshk,bhkv->bshv", khat, G)
    du = torch.einsum("bthk->hk", Ad * rb * kb)
    kst, kin, rg = kb * dks, kb * dkin, rb * drg
    zero = torch.zeros_like(kst[:, :1])
    pre = torch.cat([zero, kst.cumsum(1)[:, :-1]], 1)
    after = (rg - kin).flip(1).cumsum(1).flip(1)
    sufs = torch.cat([after[:, 1:], zero], 1)
    dlw = c0s[:, None] + pre + sufs - kin
    return dr, dk, dv, dlw, du, Wc, Dc


def wkv6_bwd_factored(r, k, v, w, u, states, dout, dstate, chunk, ex, SUB=8):
    """The kernel's algebra for :func:`ref.wkv6_chunked_bwd_ref`'s
    arguments and results, float32, sub-chunks of SUB rows: W_c and D_c a
    chunk, the reverse pass over the chunk-start states, each chunk's
    gradients from G_c+1, du summed over rows, then chunks."""
    B, T, H, K = r.shape
    C = int(chunk)
    nc = -(-T // C)
    R = -(-C // SUB) * SUB
    f32 = torch.float32
    rf, kf, vf, wf, do = (a.to(f32) for a in (r, k, v, w, dout))
    lw = torch.log(torch.clamp(wf, min=1e-12))
    chunks = []
    for c in range(nc):
        n = min(C, T - c * C)

        def rows(x, n=n, c=c):
            out = torch.zeros((B, R) + x.shape[2:], dtype=f32)
            out[:, :n] = x[:, c * C:c * C + n]
            return out
        chunks.append([rows(x) for x in (rf, kf, vf, lw, do)])
    G = torch.zeros_like(states[:, :, 0]) if dstate is None else dstate.to(f32)
    outs, dus = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        # The pass kernel folds W_c and D_c; the chunk kernel reads G_c+1.
        res = _chunk_bwd(*chunks[c], u.to(f32), states[:, :, c].to(f32), G, ex, SUB)
        outs[c], dus[c] = res[:4], res[4]
        G = res[6][..., None] * G + res[5]
    du = sum(dus, torch.zeros((H, K), dtype=f32))
    dr, dk, dv, dlw = (torch.cat([o[i][:, :min(C, T - c * C)] for c, o in enumerate(outs)], 1)
                       for i in range(4))
    dw = torch.where(wf > 1e-12, dlw / wf, torch.zeros(()))
    return dr, dk, dv, dw, du, G


# (B, T, H, K, V, chunk, least decay, carried state and dstate)
CASES = {
    "decays 1e-6 to 1": (1, 64, 2, 8, 8, 64, 1e-6, True),
    "T no multiple of the chunk": (2, 100, 2, 8, 12, 64, 1e-2, False),
    "carried state and dstate_out": (1, 150, 1, 8, 8, 64, 1e-2, True),
}


@pytest.mark.parametrize("sub", [8, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_factored_wkv6_backward_matches_the_plain_version(case, sub):
    """The factored walk (sub-chunks of 8, the kernel's, and of 16)
    against ``ref.wkv6_chunked_bwd_ref`` within TOL of max |g| for dr, dk,
    dv, w·dw, du and dstate_in; every exponent it forms is <= 0."""
    B, T, H, K, V, C, wlo, carried = CASES[case]
    rng = np.random.default_rng(31)
    r, k = (torch.from_numpy(rng.standard_normal((B, T, H, K)).astype(np.float32))
            for _ in range(2))
    v, do = (torch.from_numpy(rng.standard_normal((B, T, H, V)).astype(np.float32))
             for _ in range(2))
    w = torch.from_numpy(np.exp(rng.uniform(np.log(wlo), 0.0, (B, T, H, K))).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((H, K)) * 0.5).astype(np.float32))
    s0, ds = (torch.from_numpy(rng.standard_normal((B, H, K, V)).astype(np.float32))
              if carried else None for _ in range(2))
    s0 = torch.zeros((B, H, K, V)) if s0 is None else s0
    _, _, states = ref.wkv6_chunked_ref(r, k, v, w, u, s0, C, return_states=True)
    want = list(ref.wkv6_chunked_bwd_ref(r, k, v, w, u, states, do, ds, C))
    ex = Exps()
    got = list(wkv6_bwd_factored(r, k, v, w, u, states, do, ds, C, ex, sub))
    got[3], want[3] = got[3] * w, want[3] * w
    for name, a, b in zip(("dr", "dk", "dv", "dlogw", "du", "dstate"), got, want):
        err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        assert err <= TOL, (name, err)
    assert ex.most <= 0.0


@pytest.mark.parametrize("B,sms,want", [(8, 132, (64, 4)), (2, 132, (64, 8)),
                                        (1, 132, (32, 8)), (4, 132, (64, 4)),
                                        (1, 64, (64, 8)), (16, 132, (64, 4))])
def test_rglru_bwd_plan_fills_the_card(B, sms, want):
    """``rglru.plan_bwd``: 64-channel tiles where their blocks fill at
    least 15/16 of the SMs, else 32; 4 gate and 4 output warps where two
    blocks share an SM, else 8 each. Every plan is one the kernel
    instantiates."""
    got = rglru.plan_bwd(B, 4096, sms)
    assert got == want and got in rglru.BWD_PLANS


def test_rglru_bwd_needs_16_byte_rows():
    """The backward's tensor copies take W a multiple of 8, as the
    forward's do."""
    with pytest.raises(ValueError, match="multiple of 8"):
        rglru.plan_bwd(2, 4100, 132)
