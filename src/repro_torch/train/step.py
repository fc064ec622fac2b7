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
as the reference's ``jit`` drives every device of its host. Each split
leaf is gathered at use, its shards cast to the type the layers use it
in, and the batch is taken in as many contiguous microbatches as the
mesh has data rows (``sharding.data_rows``); AdamW splits each gradient
back to its leaf's shards and updates them in place. So a step over a
(k, m) mesh is bitwise this step with ``accum=k``. The ``model`` axis
splits storage only: the whole model is computed at once and the gather
holds the whole tree (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm, lm_module
from repro_torch.parallel.sharding import ShardedTensor, data_rows
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
        return _xent(logits, batch["labels"], cfg)
    if fam == "hybrid":
        from repro_torch.models import zamba2 as Z
        logits = Z.forward(p, batch["tokens"], cfg, remat=remat,
                           use_flash=use_flash)
        return _xent(logits, batch["labels"], cfg)
    if fam == "ssm":
        from repro_torch.models import rwkv6 as R
        logits = R.forward(p, batch["tokens"], cfg, remat=remat,
                           use_kernel=use_kernel)
        return _xent(logits, batch["labels"], cfg)
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


def _xent(logits, labels, cfg) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


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
        ps = OPT.leaves(params)
        if any(isinstance(x, ShardedTensor) for x in ps):
            with torch.no_grad():
                params = lm.unflatten({
                    path: x.gather(dtype=use[path])
                    if isinstance(x, ShardedTensor) else x
                    for path, x in lm.flatten(params).items()})
        alias = OPT.tree_map(lambda p: p.detach().requires_grad_(), params)
        xs = OPT.leaves(alias)
        with torch.enable_grad():
            l = loss(alias, batch)
            gs = torch.autograd.grad(l, xs, allow_unused=True)
        return l.detach(), [torch.zeros(p.shape, dtype=p.dtype,
                                        device=x.device)
                            if g is None else g.to(p.dtype)
                            for p, x, g in zip(ps, xs, gs)]

    def train_step(params, opt_state, batch):
        n = accum
        split = [x for x in OPT.leaves(params)
                 if isinstance(x, ShardedTensor)]
        if split:
            if accum != 1:
                raise ValueError("a step over a mesh accumulates over its "
                                 "data rows; accum must be 1")
            n = data_rows(split[0].sharding.mesh,
                          next(iter(batch.values())).shape[0])
        if n == 1:
            l, grads = value_and_grad(params, batch)
        else:
            # microbatches: batch dims reshaped (n, b/n, ...)
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                  for k, v in batch.items()}
            ps = OPT.leaves(params)
            l = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in ps]
            for i in range(n):
                li, gi = value_and_grad(params,
                                        {k: v[i] for k, v in mb.items()})
                l = l + li
                for acc, g in zip(grads, gi):
                    acc.add_(g)
            l = l / n
            grads = [g / n for g in grads]
        params, opt_state, gnorm = OPT.update(params, grads, opt_state)
        return params, opt_state, {"loss": l, "grad_norm": gnorm}

    return train_step
