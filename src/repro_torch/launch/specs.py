"""Meta-tensor input stand-ins and their shardings for every dry-run cell
(port of ``repro.launch.specs``).

Where the reference builds ``jax.ShapeDtypeStruct``s, the port builds
tensors on the ``meta`` device: shapes and dtypes without storage, which
the model code runs on unchanged. Shapes, dtypes and ``PartitionSpec``s
are the reference's, family by family.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.lm import act_dtype
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec as P,
                                           ShardingRules)

I32 = torch.int32
META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((B, S), I32), "labels": _sds((B, S), I32)}
    dt = act_dtype(cfg)
    if cfg.family == "audio":
        batch["frames"] = _sds((B, cfg.encoder.n_frames, cfg.d_model), dt)
    if cfg.family == "vlm":
        batch["patch_embeds"] = _sds((B, cfg.encoder.n_frames, cfg.d_model),
                                     dt)
    return batch


def batch_shardings(batch: dict, rules: ShardingRules, mesh) -> dict:
    return {k: NamedSharding(mesh, rules.batch_spec(v.shape[0], v.dim()))
            for k, v in batch.items()}


def prefill_args(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    B, S = shape.global_batch, shape.seq_len
    args = [_sds((B, S), I32)]
    if cfg.family in ("audio", "vlm"):
        args.append(_sds((B, cfg.encoder.n_frames, cfg.d_model),
                         act_dtype(cfg)))
    return tuple(args)


def decode_args(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """(token, caches/state[, index]) stand-ins for one decode step with a
    seq_len-deep cache; the index is a 0-d int32, as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    dt = act_dtype(cfg)
    token = _sds((B, 1), I32)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        return (token, {"k": _sds(kv, dt), "v": _sds(kv, dt)},
                _sds((), I32))
    if fam == "audio":
        kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        xk = (cfg.n_layers, B, cfg.encoder.n_frames, cfg.n_kv_heads, cfg.hd)
        caches = {"k": _sds(kv, dt), "v": _sds(kv, dt),
                  "xk": _sds(xk, dt), "xv": _sds(xk, dt)}
        return (token, caches, _sds((), I32))
    if fam == "ssm":
        from repro_torch.models.rwkv6 import n_heads
        H, K = n_heads(cfg), cfg.rwkv.head_dim
        state = {
            "tm_shift": _sds((cfg.n_layers, B, 1, cfg.d_model), dt),
            "cm_shift": _sds((cfg.n_layers, B, 1, cfg.d_model), dt),
            "wkv": _sds((cfg.n_layers, B, H, K, K), torch.float32),
        }
        return (token, state)
    if fam == "hybrid":
        from repro_torch.models.zamba2 import dims
        d_inner, H, Pd, N = dims(cfg)
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
        cache_len = min(cfg.sliding_window or S, S)
        kv = (max(n_attn, 1), B, cache_len, cfg.n_kv_heads, cfg.hd)
        state = {
            "conv": _sds((cfg.n_layers, B, cfg.ssm.conv_width - 1, d_inner),
                         dt),
            "ssm": _sds((cfg.n_layers, B, H, N, Pd), torch.float32),
            "attn_k": _sds(kv, dt),
            "attn_v": _sds(kv, dt),
        }
        return (token, state, _sds((), I32))
    raise ValueError(fam)


def decode_shardings(cfg: ModelConfig, shape: ShapeSpec,
                     rules: ShardingRules, mesh, *,
                     kv_seq_shard: bool = False) -> tuple:
    B = shape.global_batch
    fam = cfg.family
    tok = NamedSharding(mesh, rules.batch_spec(B, 2))
    b_ax = rules.fsdp if (rules.fsdp and B % rules.n_fsdp == 0) else None
    if kv_seq_shard and fam in ("dense", "moe", "vlm", "audio"):
        # the cache's sequence over the model axis (flash-decoding style)
        kv_spec = NamedSharding(mesh, P(None, b_ax, "model", None, None))
    else:
        kv_spec = NamedSharding(
            mesh, rules.kv_cache_spec(B, cfg.n_kv_heads, stacked=True))
    if fam in ("dense", "moe", "vlm"):
        return (tok, {"k": kv_spec, "v": kv_spec}, NamedSharding(mesh, P()))
    if fam == "audio":
        return (tok, {k: kv_spec for k in ("k", "v", "xk", "xv")},
                NamedSharding(mesh, P()))
    if fam == "ssm":
        from repro_torch.models.rwkv6 import n_heads
        h_ax = "model" if n_heads(cfg) % rules.n_model == 0 else None
        shift = NamedSharding(mesh, P(None, b_ax, None, None))
        wkv = NamedSharding(mesh, P(None, b_ax, h_ax, None, None))
        return (tok, {"tm_shift": shift, "cm_shift": shift, "wkv": wkv})
    if fam == "hybrid":
        from repro_torch.models.zamba2 import dims
        d_inner, H, Pd, N = dims(cfg)
        h_ax = "model" if H % rules.n_model == 0 else None
        i_ax = "model" if d_inner % rules.n_model == 0 else None
        kvh_ax = "model" if cfg.n_kv_heads % rules.n_model == 0 else None
        attn = NamedSharding(mesh, P(None, b_ax, None, kvh_ax, None))
        return (tok, {
            "conv": NamedSharding(mesh, P(None, b_ax, None, i_ax)),
            "ssm": NamedSharding(mesh, P(None, b_ax, h_ax, None, None)),
            "attn_k": attn,
            "attn_v": attn,
        }, NamedSharding(mesh, P()))
    raise ValueError(fam)
