"""Carry state across from the reference package.

The reference keeps its states as pytrees of arrays (NamedTuples).
``scenario_state``, ``asa_state``, ``trace_buffer`` and ``serve_state``
take such a tree whose leaves are numpy arrays (or anything
``numpy.asarray`` accepts) and return the port's tensors, field by field
and dtype for dtype: float32 stays
float32, int32 stays int32, bool stays bool, and uint32 PRNG keys become
the port's int64 keys with the same values. ``lm_params`` takes the
reference's language-model parameter tree (``init_params``) and returns
the port's; ``policy_params`` the learned policy head's. Nothing here
imports the reference: it reads fields by name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.asa import ASAState
from repro_torch.device import resolve_device
from repro_torch.models import lm, lm_module
from repro_torch.obs.trace import TraceBuffer
from repro_torch.rl.policy import PolicyParams
from repro_torch.xsim.state import ScenarioState

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool,
           np.dtype(np.uint32): torch.int64}


def tensor(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """One array leaf as a tensor of the matching dtype."""
    a = np.asarray(x)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected leaf dtype {a.dtype}")
    dtype = _DTYPES[a.dtype]
    return torch.as_tensor(a.astype(np.int64) if dtype == torch.int64
                           else a.copy(), dtype=dtype, device=device)


def asa_state(ref, device: str | torch.device = "cpu") -> ASAState:
    """An ``ASAState`` (batched or not) from the reference's."""
    dev = resolve_device(device)
    return ASAState(*(tensor(getattr(ref, f), dev) for f in ASAState._fields))


def serve_state(tree, device: str | torch.device = "cpu") -> dict:
    """The port's ASA-server state tree from a reference server's
    (``ASAServer._state_tree()``: ``table``, ``tenant_ids``,
    ``admissions``, ``dirty``): the table as an ``ASAState`` on
    ``device``, the host bookkeeping as the port's server keeps it
    (int32 tenant ids, a bool dirty mask, an int32 admissions count)."""
    return {"table": asa_state(tree["table"], device),
            "tenant_ids": np.array(tree["tenant_ids"], np.int32),
            "admissions": np.int32(tree["admissions"]),
            "dirty": np.array(tree["dirty"], bool)}


def trace_buffer(ref, device: str | torch.device = "cpu") -> TraceBuffer:
    """A batched ``TraceBuffer`` from the reference's vmapped one (its
    ``(B, C, NF)`` data and ``(B,)`` head are the port's layout)."""
    dev = resolve_device(device)
    return TraceBuffer(*(tensor(getattr(ref, f), dev)
                         for f in TraceBuffer._fields))


def scenario_state(ref, device: str | torch.device = "cpu"
                   ) -> ScenarioState:
    """A batched ``ScenarioState`` from the reference's, as
    ``grid.ScenarioGrid.build`` returns it, its event ring included when
    it carries one."""
    dev = resolve_device(device)
    fields = {}
    for f in ScenarioState._fields:
        v = getattr(ref, f)
        if f == "est":
            fields[f] = asa_state(v, dev)
        elif f == "trace":
            fields[f] = None if v is None else trace_buffer(v, dev)
        else:
            fields[f] = tensor(v, dev)
    return ScenarioState(**fields)


def to_numpy(state) -> dict[str, np.ndarray]:
    """Flatten a port state (``ScenarioState`` or ``ASAState``) to
    ``{field: numpy array}``, ``est`` and ``trace`` fields as
    ``est.<name>`` and ``trace.<name>``."""
    out = {}
    for f, v in state._asdict().items():
        if v is None:
            continue
        if isinstance(v, (ASAState, TraceBuffer)):
            for g, w in v._asdict().items():
                out[f"{f}.{g}"] = w.cpu().numpy()
        else:
            out[f] = v.cpu().numpy()
    return out


def lm_params(tree, cfg, device: str | torch.device = "cpu",
              dtype: torch.dtype | None = None) -> dict:
    """The port's language-model parameters from the reference's
    ``init_params(key, cfg)`` tree (nested dicts, numpy or jax leaves,
    per-layer leaves stacked on a leading L axis), for the ``dense`` and
    ``moe`` transformers, the ``ssm`` family (RWKV-6) and the ``hybrid``
    family (Zamba2, its ``shared_*`` leaves at the top).

    The port keeps the reference's layout (``param_specs`` of the family's
    module, ``models.lm_module``), so each leaf goes to the same path.
    Matrices, embeddings and the attention and MLP biases are stored in
    ``dtype`` (default: ``cfg.dtype``), the type the reference casts them
    to at use, which is exact and halves the memory of a bfloat16 model;
    the leaves the reference uses in float32 stay float32: norm scales and
    biases, RWKV-6's mix factors, decay base and LoRA, bonus and group-
    norm scale, and Zamba2's ``A_log``, ``dt_bias``, ``D_skip`` and
    out-norm scale. Raises on a leaf of ``tree`` the port has no place
    for, on a port leaf missing from ``tree``, and on a shape that
    differs."""
    dev = resolve_device(device)
    dtype = dtype or lm.act_dtype(cfg)
    flat = lm.flatten(tree)
    specs = lm_module(cfg).flat_specs(cfg)
    extra = sorted(flat.keys() - specs.keys())
    missing = sorted(specs.keys() - flat.keys())
    if extra or missing:
        raise ValueError(f"lm_params: leaves left over {extra}, missing "
                         f"{missing}")
    out = {}
    for path, leaf in specs.items():
        a = np.asarray(flat[path], dtype=np.float32)
        if a.shape != leaf.shape:
            raise ValueError(f"lm_params: {path} has shape {a.shape}, the "
                             f"port wants {leaf.shape}")
        out[path] = torch.from_numpy(a.copy()).to(
            device=dev, dtype=torch.float32 if leaf.f32 else dtype)
    return lm.unflatten(out)


def policy_params(tree, device: str | torch.device = "cpu") -> PolicyParams:
    """The port's ``rl.policy.PolicyParams`` from the reference's (its
    fields ``w1``, ``b1``, ``w2``, ``b2`` read by name, numpy or jax
    leaves), float32 on ``device``. Raises unless the leaves are float32
    with the head's shapes: ``w1 (F, H)``, ``b1 (H,)``, ``w2 (H, m)``,
    ``b2 (m,)``."""
    dev = resolve_device(device)
    leaves = {f: np.asarray(getattr(tree, f)) for f in PolicyParams._fields}
    w1, w2 = leaves["w1"], leaves["w2"]
    if w1.ndim != 2 or w2.ndim != 2:
        raise ValueError(f"policy_params: w1 {w1.shape} and w2 {w2.shape} "
                         f"must be matrices")
    (f_in, hidden), m = w1.shape, w2.shape[1]
    want = {"w1": (f_in, hidden), "b1": (hidden,), "w2": (hidden, m),
            "b2": (m,)}
    for f, a in leaves.items():
        if a.dtype != np.float32 or a.shape != want[f]:
            raise ValueError(f"policy_params: {f} is {a.dtype} {a.shape}, "
                             f"the head wants float32 {want[f]}")
    return PolicyParams(*(tensor(leaves[f], dev)
                          for f in PolicyParams._fields))
