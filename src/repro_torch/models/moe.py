"""Mixture-of-Experts layer: top-k router + sort-based capacity dispatch
(port of ``repro.models.moe``).

The grouped expert FFN runs through ``kernels.moe_gmm.ops.grouped_ffn``
(the CUDA kernel on CUDA tensors) with ``use_kernel``, else as plain
einsums. Routing follows the reference exactly:

* ``lax.top_k`` puts the lower expert index first among equal
  probabilities; a stable descending sort does the same (router logits are
  rounded to the activation type, so ties among 64 experts are common in
  bfloat16);
* the dispatch sorts slots by expert with a stable argsort, finds each
  expert's first slot with ``searchsorted``, keeps the first C of each
  expert and sends the rest to the drop row E·C;
* the combine adds each token's top_k weighted rows in ascending expert
  order, the order in which the reference's scatter-add meets them, one
  rounded add at a time, without atomics: the result does not depend on
  the run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ref import activation
from repro_torch.models.layers import _dense_init
from repro_torch.parallel import model_split as MS


def init_moe(cfg: ModelConfig) -> dict:
    m = cfg.moe
    return {
        "router": _dense_init((cfg.d_model, m.n_experts), scale=0.02),
        "w_gate": _dense_init((m.n_experts, cfg.d_model, m.d_ff_expert)),
        "w_up": _dense_init((m.n_experts, cfg.d_model, m.d_ff_expert)),
        "w_down": _dense_init((m.n_experts, m.d_ff_expert, cfg.d_model)),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for lane alignment


def route(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """Router for (N, D) tokens -> (gate_vals (N, k) float32, expert_idx
    (N, k) int64), experts in descending probability, ties to the lower
    index, gates renormalised over the k picked."""
    k = cfg.moe.top_k
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :k], idx[:, :k]
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_idx


def dispatch(expert_idx: torch.Tensor, C: int, n_experts: int):
    """Sort-based dispatch of the (N, k) picks into E·C capacity slots.

    Returns (order, keep, dest): ``order`` sorts the flat slots by expert
    (stable), ``keep[s]`` says sorted slot s fits its expert's capacity and
    ``dest[s]`` is its row in the (E·C + 1, D) buffer (E·C: dropped)."""
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # each expert's first sorted slot (a shape-static search, so the
    # dispatch also runs on meta tensors for the dry run)
    starts = torch.searchsorted(se, torch.arange(n_experts, device=se.device))
    pos_in_e = torch.arange(se.numel(), device=se.device) - starts[se]
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, n_experts * C)
    return order, keep, dest


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              use_kernel: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Experts split over ``model``
    (``model_split.Blocks``): the router and the dispatch run once;
    position j runs its experts' rows of the dispatch buffer and combines
    each token's rows that they hold (in ascending expert order, zeros
    for the rows of other positions' experts), and the positions' partial
    outputs are summed in position order. Positions hold contiguous,
    ascending expert ranges, so a token's rows keep their order; the sum
    is exact where no later position holds two or more of a token's
    rows (top-k of 2: always)."""
    m = cfg.moe
    B, S, D = x.shape
    N, E, k = B * S, m.n_experts, m.top_k
    xt = x.reshape(N, D)
    gate_vals, expert_idx = route(p, xt, cfg)

    # ---- sort-based dispatch with capacity dropping
    C = capacity(N, cfg)
    order, keep, dest = dispatch(expert_idx, C, E)
    sg = gate_vals.reshape(-1).to(x.dtype)[order]
    stok = torch.div(order, k, rounding_mode="floor")  # token of each slot
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[dest] = xt[stok] * keep[:, None].to(x.dtype)   # row E·C is dropped
    eb = buf[:-1].view(E, C, D)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    per_tok = rank.view(N, k).sort(dim=1).values       # ascending expert

    def rows_of(q, lo: int, n_e: int, slots, eb, sg):
        # ---- grouped expert FFN (hot spot) over experts lo .. lo + n_e
        eb_q = eb if n_e == E else eb[lo:lo + n_e]
        if use_kernel:
            h = gmm_ops.grouped_ffn(eb_q, q["w_gate"], q["w_up"],
                                    q["w_down"], mlp=cfg.mlp)
        else:
            g = activation(cfg.mlp)(torch.einsum("ecd,edf->ecf", eb_q,
                                                 q["w_gate"]))
            u = torch.einsum("ecd,edf->ecf", eb_q, q["w_up"])
            h = torch.einsum("ecf,efd->ecd", g * u, q["w_down"])
        # ---- combine: each token's k weighted rows, in ascending expert
        # order (row n_e·C, zeros, for the rows this call does not hold)
        rows = torch.cat([h.reshape(n_e * C, D),
                          torch.zeros((1, D), dtype=x.dtype,
                                      device=x.device)])
        contrib = rows[slots] * sg[:, None]            # (N·k, D), sorted
        out = contrib[per_tok[:, 0]]
        for j in range(1, k):
            out = out + contrib[per_tok[:, j]]
        return out

    n = MS.positions(p["w_gate"])
    if n == 1:
        return rows_of(p, 0, E, dest, eb, sg).reshape(B, S, D)

    def share(j, q, eb, sg):
        q = MS.at(q, j)
        n_e = q["w_gate"].shape[0]
        local = dest - j * n_e * C
        slots = torch.where((local >= 0) & (local < n_e * C), local,
                            n_e * C)
        return rows_of(q, j * n_e, n_e, slots, eb, sg)

    experts = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
    return MS.psum(MS.shares(n, share, experts, eb, sg)).reshape(B, S, D)


def aux_load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                          n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style auxiliary loss: logits (N, E) router logits,
    expert_idx (N, k) the picks."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = torch.mean(probs, dim=0)
    one_hot = F.one_hot(expert_idx.long(), n_experts).float().sum(dim=1)
    ce = torch.mean(one_hot, dim=0) / top_k
    return n_experts * torch.sum(me * ce)
