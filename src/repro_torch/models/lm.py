"""What every language-model family of the port shares: the activation
type, the padded vocabulary, the parameter tree's layout helpers
(stacking per-layer specs, flattening to ``{"a/b/c": leaf}`` paths and
back, filling specs from a seed, taking layer ``i``), and the final norm
with the unembedding.

Parameters are nested dicts laid out as the reference's: per-layer
leaves are STACKED on a leading L axis under ``"layers"``, and a Python
loop over layers takes the place of ``maybe_scan`` (``layer(stacked,
i)`` is a dict of views). ``remat_layer`` wraps a training forward's
layer body in the reference's activation-checkpoint policies. ``xent``
is the cross-entropy every family's training loss takes, over the whole
vocabulary or, split over ``model``, over its blocks.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.parallel import model_split as MS

VOCAB_PAD_MULTIPLE = 256
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return -(-v // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation type of ``cfg`` (``cfg.dtype`` as a torch dtype)."""
    return DTYPES[cfg.dtype]


def stacked(tree: dict, n: int) -> dict:
    """Per-layer ``Leaf`` specs with a leading axis of ``n`` layers."""
    return {k: stacked(v, n) if isinstance(v, dict)
            else v._replace(shape=(n, *v.shape)) for k, v in tree.items()}


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts to ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: dict) -> dict:
    """``{"a/b/c": x}`` back to nested dicts."""
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def fill_specs(specs: dict, cfg: ModelConfig, *, seed: int,
               device: str | torch.device) -> dict:
    """Nested parameters from flat ``{"a/b/c": Leaf}`` specs, from a
    ``torch.Generator`` seeded with ``seed``, on ``device``: a drawn leaf
    (``scale``) is normal × its scale, a filled one (``fill``) a constant;
    a leaf is kept in float32 if its spec says so, else in the activation
    type. Leaves under ``layers/`` are drawn one layer at a time, so no
    float32 copy of the whole model is made."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = act_dtype(cfg)
    flat = {}
    for path, leaf in specs.items():
        t = torch.empty(leaf.shape, device=dev,
                        dtype=torch.float32 if leaf.f32 else dtype)
        if leaf.scale:
            per_layer = path.startswith("layers/")
            for part in (t.unbind(0) if per_layer else (t,)):
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=dev).mul_(leaf.scale))
        else:
            t.fill_(leaf.fill)
        flat[path] = t
    return unflatten(flat)


# The weight products of a layer: what the reference's "dots" policy
# (``checkpoint_dots_with_no_batch_dims``) saves. Every ``x @ w`` of the
# port's layers (projections, MLPs, the router, RWKV-6's mixes and decay
# LoRA) reaches the dispatcher as ``aten.mm`` on a folded view; the
# products with batch dims (attention's scores and values, the MoE's
# expert einsums, the WKV scan's einsums) reach it as ``aten.bmm`` and
# are recomputed, as the reference recomputes its dot_generals with batch
# dims.
NO_BATCH_DOTS = frozenset({torch.ops.aten.mm.default,
                           torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in NO_BATCH_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(body, remat: str):
    """``body(lp, x) -> x`` under an activation-checkpoint policy, as the
    reference's ``remat``: "none" keeps every activation; "full" saves the
    layer's inputs only and recomputes the layer in the backward
    (``torch.utils.checkpoint``, non-reentrant); "dots" also saves the
    outputs of the weight products (``NO_BATCH_DOTS``) and recomputes the
    rest (selective checkpointing). No policy changes a value: the
    recomputation runs the same operations on the same inputs. Without
    autograd the body runs as it is."""
    if remat == "none":
        return body
    if remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got {remat!r}")
    kw = ({"context_fn": partial(ckpt.create_selective_checkpoint_contexts,
                                 _dots_policy)} if remat == "dots" else {})

    def run(lp, x):
        if not torch.is_grad_enabled():
            return body(lp, x)
        # the layer's tensors go in as arguments, which the checkpoint
        # saves as tensors (so saved-tensor hooks see them: see
        # ``parallel.sharding.gathers_not_saved``), not inside a dict
        names, leaves = zip(*flatten(lp).items())

        def layer_body(x, *leaves):
            return body(unflatten(dict(zip(names, leaves))), x)

        return ckpt.checkpoint(layer_body, x, *leaves, use_reentrant=False,
                               **kw)

    return run


def layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked per-layer parameters, as views (a leaf
    that a training step splits over a mesh gathers layer ``i`` on
    ``[i]``, or hands out its ``model`` positions' blocks:
    ``parallel.sharding.SplitAtUse``)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The final norm (``cfg.norm``) and the unembedding (the tied table
    or ``lm_head``) -> logits (..., V_padded), the padding masked. A head
    split over its vocabulary (``model_split.Blocks``) gives each
    position's block of the logits, a list in position order, the
    padding masked at the position that holds it (``xent`` reads
    either)."""
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.norm)
    head = (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"])
    if isinstance(head, MS.Blocks):
        return MS.shares(head.n, lambda j: head_logits(
            x, head.block(j), cfg, j))
    return head_logits(x, head, cfg, 0)


def head_logits(x: torch.Tensor, head: torch.Tensor, cfg: ModelConfig,
                j: int) -> torch.Tensor:
    """``x``'s logits over block ``j`` of the vocabulary that ``head``
    holds (the tied table's rows or ``lm_head``'s columns; block 0 the
    whole), the ids past ``cfg.vocab_size`` (the padding) masked."""
    logits = x @ head.T if cfg.tie_embeddings else x @ head
    v = logits.shape[-1]
    pad = cfg.vocab_size - j * v
    # mask vocab padding so the softmax ignores it
    if pad < v:
        logits[..., max(pad, 0):] = -1e30
    return logits


def xent(logits, labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of ``labels`` from the float32 log-softmax
    of ``logits`` (``unembed``'s; over a vocabulary split over ``model``,
    ``model_split.vocab_xent`` on its blocks)."""
    if isinstance(logits, list):
        return MS.vocab_xent(logits, labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)
