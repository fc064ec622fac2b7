"""Family-dispatched loss and train step (port of ``repro.train.step``).

``make_train_step(cfg)`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``; the gradients come from torch autograd through the
plain route (``sdpa``, einsum expert FFNs, the plain chunked WKV and SSD
scans), which is the reference's training route: its kernels have no
backward, and on CUDA tensors the port's kernel wrappers refuse autograd,
so ``use_flash=True`` there raises instead of training. Microbatch
accumulation (``accum``) is a Python loop with float32 gradient sums
where the reference has a ``lax.scan``. The step reads nothing back to
the host.

Parameters may be stored in float32, as the reference's are, or in the
activation type, as the port's ``init_lm`` makes them for serving: the
loss casts each leaf to the type the layers use it in
(``params_at_use``), as the reference's ``.astype(x.dtype)`` at use, and
AdamW updates in float32 and stores back in the leaf's own type.

Parameters may also be split over a (data, model) mesh
(``parallel.sharding.ShardedTensor`` leaves), the port's stand-in for
the reference's step under its mesh: one process drives every position,
as the reference's ``jit`` drives every device of its host. The batch is
taken in as many contiguous microbatches as the mesh has data rows
(``sharding.data_rows``). A split leaf is read through
``sharding.SplitAtUse``: gathered where it is used, cast to the type the
layers use it in, a stacked leaf one layer at a time (``lm.layer``, as
the reference's ``lax.scan`` over layers gathers a layer an iteration),
and under ``sharding.gathers_not_saved`` autograd keeps how to gather a
layer again rather than the gathered layer, under every ``remat``
policy. A leaf whose spec splits a compute dimension over ``model``
(heads, d_ff, experts, d_inner, the vocabulary) reaches the layers as
``model_split.Blocks``: each layer computes each ``model`` position's
share from that position's block, gathered over the FSDP axes only when
the share is computed, and the positions' partial outputs are summed in
position order (``parallel.model_split``), as the reference's SPMD step
splits every compute dimension over ``model``. The gather's backward
hands each block its part of the gradient (the reduce-scatter), which is
summed, rows in order, into float32 accumulators of the block's shape;
no split leaf's gradient is held whole, and AdamW updates each shard in
place from its block's. So a step over a (k, 1) mesh is bitwise this
step with ``accum=k``; over a (k, m) mesh with m > 1 it agrees with it to
float32 rounding (the row-parallel products add partial sums), and is
bitwise among itself across runs, restarts and ``remat`` policies.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm, lm_module
from repro_torch.parallel.sharding import (ShardedTensor, SplitAtUse,
                                           data_rows, flatten_with_path,
                                           gathers_not_saved, path_str,
                                           taken_by_layer)
from repro_torch.train import optimizer as OPT


def params_at_use(params: dict, cfg: ModelConfig) -> dict:
    """Each leaf in the type the layers use it in: float32 for the leaves
    the reference keeps in float32 (norm scales and biases, RWKV-6's mix
    factors, decay, bonus and group-norm scale, Zamba2's ``A_log``,
    ``dt_bias``, ``D_skip`` and out-norm scale), the activation type for
    every other. The cast is differentiable and a no-op for a leaf that
    already has its type."""
    use = use_dtypes(cfg)
    return lm.unflatten({path: x.to(use[path])
                         for path, x in lm.flatten(params).items()})


def use_dtypes(cfg: ModelConfig) -> dict:
    """``{path: the dtype the layers use that leaf in}`` (see
    ``params_at_use``)."""
    act = lm.act_dtype(cfg)
    return {path: torch.float32 if spec.f32 else act
            for path, spec in lm_module(cfg).flat_specs(cfg).items()}


def model_loss(params, batch: dict, cfg: ModelConfig, *, remat: str = "dots",
               use_flash: bool = False, use_moe_kernel: bool = False,
               use_kernel: bool = False,
               vocab_parallel: bool = False) -> torch.Tensor:
    """The mean next-token cross-entropy of ``batch`` ({"tokens",
    "labels"}, and "frames" for the ``audio`` family, "patch_embeds"
    for the ``vlm`` family, whose prefix rows carry no label).
    ``use_flash``/``use_moe_kernel`` reach the transformer's attention and
    expert FFNs (``use_flash`` also Zamba2's shared attention and every
    attention of the encoder–decoder), ``use_kernel`` RWKV-6's WKV scan:
    the kernels on CUDA tensors (no autograd there), their plain versions
    on CPU tensors."""
    fam = cfg.family
    p = params_at_use(params, cfg)   # an unknown family raises here
    if fam == "audio":
        from repro_torch.models import encdec as E
        logits = E.forward(p, batch["tokens"], batch["frames"], cfg,
                           remat=remat, use_flash=use_flash)
        return lm.xent(logits, batch["labels"])
    if fam == "hybrid":
        from repro_torch.models import zamba2 as Z
        logits = Z.forward(p, batch["tokens"], cfg, remat=remat,
                           use_flash=use_flash)
        return lm.xent(logits, batch["labels"])
    if fam == "ssm":
        from repro_torch.models import rwkv6 as R
        logits = R.forward(p, batch["tokens"], cfg, remat=remat,
                           use_kernel=use_kernel)
        return lm.xent(logits, batch["labels"])
    from repro_torch.models import transformer as T
    if fam == "vlm":
        return T.loss_fn(p, batch["tokens"], batch["labels"], cfg,
                         prefix_embeds=batch["patch_embeds"],
                         use_flash=use_flash, remat=remat,
                         use_moe_kernel=use_moe_kernel)
    if vocab_parallel:
        hidden = T.forward(p, batch["tokens"], cfg, use_flash=use_flash,
                           remat=remat, return_hidden=True,
                           use_moe_kernel=use_moe_kernel)
        return T.vocab_parallel_xent(hidden, p, batch["labels"], cfg)
    return T.loss_fn(p, batch["tokens"], batch["labels"], cfg,
                     use_flash=use_flash, remat=remat,
                     use_moe_kernel=use_moe_kernel)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """The family's ``init_lm`` (``models.lm_module``): random parameters
    from a ``torch.Generator`` seeded with ``seed``, matrices in the
    activation type."""
    return lm_module(cfg).init_lm(cfg, seed=seed, device=device)


def make_train_step(cfg: ModelConfig, *, accum: int = 1,
                    remat: str = "dots", use_flash: bool = False,
                    vocab_parallel: bool = False) -> Callable:
    """The step. Where a parameter is split over a mesh, ``accum`` is the
    split leaves' mesh's data rows (see the module docstring)."""
    loss = partial(model_loss, cfg=cfg, remat=remat, use_flash=use_flash,
                   vocab_parallel=vocab_parallel)
    use = use_dtypes(cfg)

    def value_and_grad(params, batch):
        """-> (loss, a gradient a leaf in ``OPT.leaves`` order): the
        leaf's, in its dtype; for a split leaf, (slot, gradient) pairs of
        its ``SplitAtUse`` inputs, each rounded to the leaf's dtype."""
        ps = OPT.leaves(params)
        at_use = {}
        for path, x in flatten_with_path(params):
            name = path_str(path)
            at_use[name] = (SplitAtUse(x, use[name], taken_by_layer(name))
                            if isinstance(x, ShardedTensor)
                            else x.detach().requires_grad_())
        split = any(isinstance(u, SplitAtUse) for u in at_use.values())
        xs = [a for u in at_use.values()
              for a in (u.inputs if isinstance(u, SplitAtUse) else (u,))]
        with torch.enable_grad(), (gathers_not_saved() if split
                                   else nullcontext()):
            l = loss(lm.unflatten({
                name: u.top() if isinstance(u, SplitAtUse)
                and not taken_by_layer(name) else u
                for name, u in at_use.items()}), batch)
            gs = iter(torch.autograd.grad(l, xs, allow_unused=True))
        grads = []
        for p, u in zip(ps, at_use.values()):
            if isinstance(u, SplitAtUse):
                grads.append([(slot, next(gs)) for slot in u.slots])
            else:
                g = next(gs)
                grads.append(torch.zeros(p.shape, dtype=p.dtype,
                                         device=u.device)
                             if g is None else g.to(p.dtype))
        return l.detach(), grads

    def train_step(params, opt_state, batch):
        n = accum
        ps = OPT.leaves(params)
        split = [x for x in ps if isinstance(x, ShardedTensor)]
        if split:
            if accum != 1:
                raise ValueError("a step over a mesh accumulates over its "
                                 "data rows; accum must be 1")
            n = data_rows(split[0].sharding.mesh,
                          next(iter(batch.values())).shape[0])
        if n == 1 and not split:
            l, grads = value_and_grad(params, batch)
        else:
            # microbatches: batch dims reshaped (n, b/n, ...). A split
            # leaf's gradients are summed in float32 accumulators of its
            # blocks, made when its first row's gradient comes; each
            # row's gradient of a leaf is let go once it is added
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                  for k, v in batch.items()}
            l = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            grads = [None if isinstance(p, ShardedTensor)
                     else torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device) for p in ps]
            for i in range(n):
                li, gi = value_and_grad(params,
                                        {k: v[i] for k, v in mb.items()})
                l = l + li
                for k, p in enumerate(ps):
                    if not isinstance(p, ShardedTensor):
                        grads[k].add_(gi[k])
                    else:
                        if grads[k] is None:
                            grads[k] = p.block_zeros(torch.float32)
                        _add_blocks(grads[k].blocks(), gi[k])
                    gi[k] = None
            l = l / n
            grads = [_div_blocks(g, n) if isinstance(g, ShardedTensor)
                     else g / n for g in grads]
        params, opt_state, gnorm = OPT.update(params, grads, opt_state)
        return params, opt_state, {"loss": l, "grad_norm": gnorm}

    return train_step


def _div_blocks(acc: ShardedTensor, n: int) -> ShardedTensor:
    for block in acc.blocks():
        block.div_(n)
    return acc


def _add_blocks(blocks: list, grads: list) -> None:
    """Adds a split leaf's gradients (``value_and_grad``'s (slot,
    gradient) pairs) into its block accumulators."""
    for (b, j), g in grads:
        if g is not None:
            (blocks[b] if j is None else blocks[b][j]).add_(g)
