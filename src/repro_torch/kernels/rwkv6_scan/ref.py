"""Plain PyTorch versions of the chunked WKV6 kernel (port of
``repro.kernels.rwkv6_scan.ref`` and of the chunked body of
``repro.models.rwkv6.wkv_chunked``).

``wkv6_ref`` is the sequential oracle; ``wkv_chunked_ref`` is the chunked
evaluation the kernel computes, what the reference's ``ops.wkv6`` runs off
a TPU. Both take r, k, v, w (B, S, H, K) (the value dim equals K), u
(H, K) and an optional carried state0 (B, H, K, K), and return (out in
r's type, final state (B, H, K, K) float32).
"""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, state0=None):
    """o_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t);  S_t = diag(w_t) S_{t-1} +
    k_t ⊗ v_t, one step at a time, in float32."""
    B, S, H, K = r.shape
    state = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(S):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, state + uf * kv))
        state = wt[..., None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def wkv_chunked_ref(r, k, v, w, u, chunk: int, state0=None):
    """The chunked evaluation, chunk by chunk in float32. Within a chunk of
    length c, with cum the inclusive cumulative log-decay and cum_excl
    = cum - log w: the inter-chunk readout (r ⊙ exp(cum_excl)) @ S, the
    intra-chunk pair term with PAIRWISE decays exp(cum_excl_t − cum_s) for
    s < t (exponent ≤ 0 under the mask, so it cannot overflow where the
    factored exp(cum_excl)·exp(−cum) does), the bonus (Σ_k r u k) v, and
    the update S' = exp(cum_end) ⊙ S + (k ⊙ exp(cum_end − cum))ᵀ v."""
    B, S, H, K = r.shape
    if chunk <= 0 or S % chunk:
        raise ValueError(f"wkv6: S={S} is not a multiple of chunk={chunk}")
    n = S // chunk
    rc, kc, vc = (a.reshape(B, n, chunk, H, K) for a in (r, k, v))
    logw = torch.log(torch.clamp(w.float(), 1e-12, 1.0)).reshape(
        B, n, chunk, H, K)
    cum = torch.cumsum(logw, dim=2)               # inclusive
    state = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    uf = u.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    outs = []
    for i in range(n):
        rf, kf, vf = rc[:, i].float(), kc[:, i].float(), vc[:, i].float()
        cum_, logw_ = cum[:, i], logw[:, i]       # (B, c, H, K)
        cum_excl = cum_ - logw_
        o_inter = torch.einsum("bthk,bhkv->bthv", rf * torch.exp(cum_excl),
                               state)
        dec = cum_excl[:, :, None] - cum_[:, None, :, :]   # (B, t, s, H, K)
        dec = dec.masked_fill(~mask[None, :, :, None, None], float("-inf"))
        att = torch.einsum("bthk,bshk,btshk->bhts", rf, kf, torch.exp(dec))
        o_intra = torch.einsum("bhts,bshv->bthv", att, vf)
        o_bonus = torch.einsum("bthk,hk,bthk->bth", rf, uf, kf)[..., None] * vf
        cum_end = cum_[:, -1:]
        k_dec = kf * torch.exp(cum_end - cum_)
        state = (torch.exp(cum_end[:, 0])[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_dec, vf))
        outs.append(o_inter + o_intra + o_bonus)
    out = torch.stack(outs, dim=1).reshape(B, S, H, K)
    return out.to(r.dtype), state
