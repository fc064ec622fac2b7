"""Batched serving entry point: prefill a batch of prompts, decode greedily
(port of ``repro.launch.serve``, every family: ``dense``, ``moe``,
``vlm``, ``ssm``, ``hybrid`` and ``audio``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --device cuda --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --device cuda --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --device cuda --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --device cuda --batch 16 --prompt-len 64 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \\
      --device cuda --batch 4 --prompt-len 1024 --gen 32

On the card ``serve`` runs every hand-written CUDA kernel on its path
(``use_kernels=True``): for a transformer, prefill attention and every
MoE expert FFN of prefill and decode go through
``csrc/flash_attention.cu`` and ``csrc/moe_gmm.cu``; for RWKV-6, every
layer's WKV scan of prefill goes through ``csrc/wkv6.cu``; for Zamba2,
every shared-attention invocation of prefill goes through
``csrc/flash_attention.cu`` (its SSD scan is plain, as the reference's);
for the encoder–decoder, every attention of prefill (the encoder's, the
decoder's self-attention over the prompt and its cross attention over
the frames) goes through ``csrc/flash_attention.cu``; for the VLM prefix,
every layer's attention of prefill over the patches and the prompt goes
through ``csrc/flash_attention.cu``. This differs
from ``repro.launch.serve``, whose default route is XLA's (``sdpa``,
einsum expert FFNs, the jnp chunked scan): the reference reaches its
Pallas kernels only behind per-kernel flags and only on a TPU, and this
port exists to run the kernels. On CPU tensors (``--device cpu``) the
same switch runs the kernels' plain versions.

RWKV-6's prompt takes another route than the reference's. The reference
fills the state by stepping ``decode_step`` one prompt token at a time
(``repro/launch/serve.py``'s ``ssm`` branch), which never reaches the
kernel and on the card would cost one eager step per prompt token. Here
``rwkv6.prefill`` runs the prompt in two blocks with the same
``decode_step`` semantics: the longest prefix that is a multiple of
``cfg.rwkv.chunk``, chunk by chunk, then the rest from the carried shift
and WKV state. The recurrence is the same, so the state after the prompt,
the logits and the greedy tokens are the reference's up to summation
order (``tests/test_torch_rwkv6.py`` holds them to it); decode then steps
one token at a time, as the reference does. Zamba2's prompt takes the
same kind of route (``zamba2.prefill``): the longest prefix that is a
multiple of ``cfg.ssm.chunk`` and fits the shared attention's KV ring as
one block, then the rest one token at a time from the carried state
(``tests/test_torch_zamba2.py``).

The encoder–decoder follows the reference's audio route
(``repro/launch/serve.py``'s ``audio`` branch): prefill is the decoder
over the prompt (its last position's logits); decode starts from a
zero-filled self-attention cache of S + gen positions into which the
prompt's keys and values are never written, and writes position S + i,
so each decode step also attends over S zero keys (the decode mask lets
every position up to the current one in). The reference encodes the
frames twice (once in prefill, once for the cross K/V of decode); here
they are encoded once and one set of cross K/V feeds both, the same
float work (``tests/test_torch_encdec.py`` holds it to the reference's
two calls).

The VLM prefix follows the reference's ``vlm`` route too: 8 patch
embeddings a request drawn from the seed, prefill is ``forward`` over the
patches and the prompt (its last row's logits), and decode starts from a
zero-filled KV cache of S + gen positions, written at S + i: neither the
patches' nor the prompt's keys and values are ever written into it, and
it has no room for the patches.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm_module
from repro_torch.models.lm import act_dtype
from repro_torch.models.transformer import init_kv_caches
from repro_torch.serve.step import (greedy_sample, make_decode_step,
                                    make_prefill_step)

VLM_PATCHES = 8   # patch embeddings a request, as the reference's route


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: dict, prompts: torch.Tensor, cfg, gen: int, *,
             use_kernels: bool = False,
             frames: torch.Tensor | None = None,
             patches: torch.Tensor | None = None) -> dict:
    """Prefill ``prompts`` (B, S), then decode greedily: ``gen`` decode
    steps, as the reference's loop does (the last step's token is not
    kept). A transformer's prefill keys and values fill a (S + gen)-long
    KV cache; RWKV-6's decode carries the state its prefill leaves, and
    so does Zamba2's, its rings sized for S + gen tokens. The
    encoder–decoder takes ``frames`` (B, n_frames, D): its decode starts
    from an empty (S + gen)-long self-attention cache and the cross K/V
    of prefill (see the module's docstring). The VLM takes ``patches``
    (B, P, D), and its decode starts from an empty (S + gen)-long KV
    cache, as the reference's. ``use_kernels`` runs every
    hand-written kernel on the path (``serve.step``).

    Returns ``tokens`` (B, gen), ``prefill_logits`` (B, 1, V_padded), the
    first decode step's ``decode_logits`` (None if gen is 0), and the host
    times ``prefill_s`` (prefill and cache fill) and ``decode_s``, each
    ending in a device synchronise."""
    B, S = prompts.shape
    dev = prompts.device
    fam = cfg.family
    prefill = make_prefill_step(cfg, use_kernels=use_kernels)
    decode = make_decode_step(cfg, use_kernels=use_kernels)
    _sync(dev)
    t0 = time.perf_counter()
    if fam == "hybrid":
        logits, pf = prefill(params, prompts, max_seq=S + gen)
    elif fam == "audio":
        if frames is None:
            raise ValueError("the audio family serves frames: pass frames=")
        logits, pf = prefill(params, prompts, frames)
    elif fam == "vlm":
        if patches is None:
            raise ValueError("the vlm family serves patch embeddings: pass "
                             "patches=")
        logits, pf = prefill(params, prompts, patches)
    else:
        logits, pf = prefill(params, prompts)
    if fam in ("ssm", "hybrid"):
        state = pf
    elif fam == "audio":
        caches = encdec.init_kv_caches(cfg, B, S + gen, device=dev)
        caches["xk"], caches["xv"] = pf["xk"], pf["xv"]
    else:
        caches = init_kv_caches(cfg, B, S + gen, device=dev)
        if fam != "vlm":   # the VLM's decode starts from the empty cache
            caches["k"][:, :, :S] = pf["k"]
            caches["v"][:, :, :S] = pf["v"]
    del pf
    _sync(dev)
    t1 = time.perf_counter()
    prefill_logits, first = logits, None
    token = greedy_sample(logits)
    generated = []
    for i in range(gen):
        generated.append(token)
        if fam == "ssm":
            logits, state = decode(params, token, state)
        elif fam == "hybrid":
            logits, state = decode(params, token, state, S + i)
        else:
            logits, caches = decode(params, token, caches, S + i)
        if i == 0:
            first = logits
        token = greedy_sample(logits)
    _sync(dev)
    t2 = time.perf_counter()
    tokens = (torch.cat(generated, dim=1) if generated
              else torch.empty((B, 0), dtype=torch.int64, device=dev))
    return {"tokens": tokens, "prefill_logits": prefill_logits,
            "decode_logits": first, "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0,
          device: str | torch.device = "cuda") -> dict:
    """Serve ``batch`` random prompts of ``arch`` with random weights (both
    from ``seed``; for the encoder–decoder random frames too, for the VLM
    8 random patch embeddings a request, normal in the activation type)
    through the kernels; returns ``generate``'s results plus
    ``elapsed_s``, ``tok_per_s``, the ``cfg``, and the ``params``,
    ``prompts``, ``frames`` and ``patches`` (None but for their family)
    it served, so a caller can replay them on another route."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    params = lm_module(cfg).init_lm(cfg, seed=seed, device=dev)
    draws = torch.Generator(device=dev).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            device=dev, generator=draws)
    frames = patches = None
    if cfg.family == "audio":
        frames = torch.randn((batch, cfg.encoder.n_frames, cfg.d_model),
                             device=dev, generator=draws).to(act_dtype(cfg))
    if cfg.family == "vlm":
        patches = torch.randn((batch, VLM_PATCHES, cfg.d_model), device=dev,
                              generator=draws).to(act_dtype(cfg))
    res = generate(params, prompts, cfg, gen, use_kernels=True,
                   frames=frames, patches=patches)
    dt = res["prefill_s"] + res["decode_s"]
    res.update(elapsed_s=dt, tok_per_s=(batch * gen) / dt if gen else 0.0,
               cfg=cfg, params=params, prompts=prompts, frames=frames,
               patches=patches)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    print(f"generated {tuple(res['tokens'].shape)} in "
          f"{res['elapsed_s']:.1f}s ({res['tok_per_s']:.1f} tok/s; prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['decode_s'] * 1e3 / max(args.gen, 1):.1f} ms/step)")


if __name__ == "__main__":
    main()
