"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every hand-written kernel of the port from the sources in the
checkout, holds each kernel against its plain PyTorch version on the
card, drives the port's main paths (the fleet simulator's Table-1 sweep,
and model serving of a dense and an MoE transformer and of RWKV-6), and
checks the results. Phases:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each kernel against its plain version at the shapes its path uses
   (``freed_scan`` bitwise; ``flash_attention``, ``grouped_matmul`` and
   ``wkv6`` within the tolerances of the reference's own kernel tests
   and within limits relative to the output, row by row), with its
   time, the plain version's time, one library call's time and its bound;
   flash attention, the grouped matmul and ``wkv6`` in the design their
   type and shape pick (``wgmma`` or, for ``wkv6``, ``mma``: the tensor
   cores, at every bfloat16 serve shape) and, at those shapes, their
   CUDA-core design (``simt``) too, held and timed as a yardstick; the
   final ``wkv6`` state of every bfloat16 case bitwise equal to the
   CUDA-core design's;
3. the Table-1 path at the repository's own benchmark setting
   (``benchmarks/run.py``'s xsim leg: 1/64-size centers, policies 0-2,
   warmed fleet), once through the kernel and once through the plain
   reservation scan: the final states must be bitwise identical;
4. the sweep at full size: both centers at their real core counts,
   their three paper scales, three workflows, policies 0-2, two seeds
   (108 scenarios of 2313 job slots), through the user-facing entry
   points; the kernel's launches in this run are counted;
5. serving ``qwen2-0.5b`` at full size (24 layers, d896; batch 8, prompt
   2048, 32 new tokens) through ``repro_torch.launch.serve.serve``, whose
   prefill runs the flash-attention kernel, all 24 launches on the tensor
   cores (``wgmma``); then the same params and
   prompts through the "twin" route (each kernel swapped for its plain
   version) and the plain route (``sdpa``): logits within stated
   bfloat16 tolerances, the share of greedy tokens that agree, times,
   peak memory and a profiled prefill and decode;
6. the same for ``moonshot-v1-16b-a3b`` at full width and depth (48
   layers, d2048, 64 experts top-6; batch 4, prompt 1024, 16 new tokens),
   whose MoE layers run the grouped-matmul kernel in prefill and decode,
   every one of its 2448 launches (3 a layer in prefill and in each of
   16 decode steps) on the tensor cores (``wgmma``), as are the 48 flash
   launches of its prefill.
   Its end-to-end logits are reported, not checked (see ``LAYER_TOL``):
   each layer is checked against the other routes on the same input;
7. moonshot end to end where routing is not chaotic: full width, depth
   cut to 4 layers, float32, the kernel route's logits and greedy tokens
   held against the twin and plain routes, its grouped matmuls and flash
   attention all on the CUDA cores (``simt``: exact float32); bfloat16 at
   4 layers and at 48 from another seed printed beside it;
8. serving ``rwkv6-3b`` at full width and depth (32 layers, d2560, 40
   heads of 64; batch 8, prompt 2048, 32 new tokens) through
   ``launch.serve.serve``, whose prefill runs the ``wkv6`` kernel in
   every layer, all 32 launches on the tensor cores (``mma``), against
   the twin route (the kernel swapped for its plain
   version, which is also the reference's default route): the bfloat16
   logits reported beside a witness that runs no kernel, each layer held
   on the kernel route's own inputs, and the logits held end to end in
   float32 at full depth; times, peak memory and a profiled prefill and
   decode;
9. RWKV-6 against the reference's own serving route: full width, depth
   cut to 4 layers, a ragged prompt (500 = 3 × 128 + 116, so the tail
   block runs the kernel from a carried state), the kernel route's
   ``generate`` against the token-by-token prompt loop of the
   reference's serve (``decode_step`` one token at a time, no kernel):
   in float32 greedy tokens equal and logits and the state after the
   prompt within limits, in bfloat16 logits within limits; every float32
   ``wkv6`` launch on the CUDA cores (``simt``), every bfloat16 one on
   the tensor cores (``mma``).

Matrix products of the plain versions run in full float32 where their
inputs are float32: TF32 is switched off for matmuls and cuDNN.

The second-to-last line is a JSON object with one entry per ported
kernel; the last line is ``{"ok": true, "device": {...}}``. Any failure
raises and ends the script with a non-zero exit code; without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12    # bfloat16 tensor cores, dense

# the port's kernels: name -> source, the TPU kernel it replaces
KERNELS = {
    "freed_scan": dict(route="cuda",
                       source="src/repro_torch/csrc/freed_scan.cu",
                       replaces="src/repro/xsim/backfill.py:124"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:82"),
    "grouped_matmul": dict(
        route="cuda", source="src/repro_torch/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm/kernel.py:39"),
    "wkv6": dict(
        route="cuda", source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6_scan/kernel.py:70"),
}

# the tolerances of the reference's own kernel tests (tests/test_kernels.py)
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
GMM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (0.0, 3e-2)}
# ... and, since an absolute tolerance holds only the rows whose outputs
# are near 1 (a causal row over n keys of unit-normal v has outputs of
# std about sqrt(e/n): 0.05 at row 1024), limits relative to the output:
# (largest ||Δ|| / ||want|| over output rows, rms(Δ) / rms(want)); see
# ``rel_errs``. Kernel and plain version both sum in float32 and differ
# in order only (flash's tensor-core design also keeps p to about 16 bits
# for p·v, as p_hi + p_lo in bfloat16), so in bfloat16 the outputs differ
# by at most one rounding step (2^-8 to 2^-7 of |x|) where they differ at
# all. Measured on an H100 at these shapes: flash bf16 worst row 0.0026,
# rel_rms 3.6e-5 (CUDA cores), 0.0033 and 9.1e-5 (tensor cores), f32
# 1.2e-6 and 3.4e-7; grouped matmul bf16 6.8e-4 and 1.0e-4, f32 bitwise.
# Each limit was set at about ten times its reading on the CUDA cores
# (the bf16 row limit, one step).
FLASH_REL = {torch.float32: (1e-5, 3e-6), torch.bfloat16: (8e-3, 4e-4)}
GMM_REL = {torch.float32: (1e-5, 2e-6), torch.bfloat16: (5e-3, 1e-3)}

# phase 2 flash shapes (B, S, H, hd, window, dtype), all causal: the serve
# shapes of phases 5 (qwen2) and 6 (moonshot), a ragged S, a window, f32
FLASH_SHAPES = ((8, 2048, 14, 64, 0, torch.bfloat16),
                (4, 1024, 16, 128, 0, torch.bfloat16),
                (2, 1000, 4, 64, 0, torch.bfloat16),
                (2, 1000, 4, 128, 256, torch.float32),
                (2, 1024, 16, 128, 0, torch.float32))
# ... the two serve shapes, where the CUDA-core design is held and timed
# beside the tensor-core one
FLASH_SERVE_KEYS = ("8x2048x14x64", "4x1024x16x128")
# phase 2 gmm shapes (E, C, D, F, dtype): moonshot's gate/up and down
# projections at prefill (C = capacity of 4096 tokens) and decode (C = 8),
# and a ragged f32 one
GMM_SHAPES = ((64, 480, 2048, 1408, torch.bfloat16),
              (64, 480, 1408, 2048, torch.bfloat16),
              (64, 8, 2048, 1408, torch.bfloat16),
              (64, 8, 1408, 2048, torch.bfloat16),
              (8, 250, 600, 1000, torch.float32))

# phase 2 wkv6 cases (B, S, H, K, chunk, dtype, w range, state0, held
# against the sequential wkv6_ref too): rwkv6-3b's prefill at the serve
# shape, a ragged prompt's tail block from a carried state, strong decay
# in bfloat16 and float32 (w down to 1e-6: a 128-step chunk's cum falls
# hundreds below -88, to -1770 were every w 1e-6, where exp(-cum)
# overflows and only the pairwise or boundary-factored decays stay
# finite), and a small case drawn as the reference's kernel tests draw
# theirs. w = exp(-exp(z)), z uniform so that w spans the range; r, k, v
# ~ N(0, 1); u ~ N(0, 0.5); state0 ~ N(0, 0.3). The bfloat16 cases at
# K = 64 run the tensor-core design (``mma``).
WKV_SHAPES = ((8, 2048, 40, 64, 128, torch.bfloat16, (1e-4, 0.999), False,
               False),
              (8, 116, 40, 64, 116, torch.bfloat16, (1e-4, 0.999), True,
               False),
              (4, 512, 40, 64, 128, torch.bfloat16, (1e-6, 0.999), True,
               False),
              (4, 512, 40, 64, 128, torch.float32, (1e-6, 0.999), True,
               False),
              (2, 256, 4, 64, 64, torch.float32, (0.45, 0.95), True, True))
# wkv6 against its plain chunked version, (largest ||Δ|| / ||want|| over
# output rows, rms(Δ)/rms(want)), out by the type of r and the final
# state (float32 in both); both sum in float32 in other orders. The
# sequential wkv6_ref is another algorithm (a product of decays where the
# chunked form takes exp of a sum): WKV_SEQ_REL. The small case also
# within the reference's kernel-test tolerances (out 2e-4, state 2e-5).
# Measured on an H100 (all passed the provisional limits 1e-2 / 5e-3 bf16
# and 1e-4 / 1e-5 f32): bf16 out worst row 0.0027, rel_rms 2.6e-5; f32
# out 9.8e-7 and 1.5e-7; the state bitwise equal to the plain version's;
# against the sequential oracle 2.6e-6 and 6.2e-7. Each limit is about
# ten times its reading (the bf16 row limit: one bfloat16 step; the
# state's: a few float32 roundings). The tensor-core design keeps the
# state's arithmetic (bitwise) and splits each float32 operand of its
# products into two TF32 values, within the same limits.
WKV_SERVE_KEY = "8x2048x40x64c128"
WKV_REL = {torch.float32: (1e-5, 2e-6), torch.bfloat16: (8e-3, 3e-4)}
WKV_STATE_REL = (1e-6, 1e-7)
WKV_SEQ_REL = (3e-5, 6e-6)
WKV_ATOL = (2e-4, 2e-5)

# phases 5, 6 and 8: arch, batch, prompt, new tokens
SERVE = {"dense": ("qwen2-0.5b", 8, 2048, 32),
         "moe": ("moonshot-v1-16b-a3b", 4, 1024, 16),
         "ssm": ("rwkv6-3b", 8, 2048, 32)}
# Route comparisons of phases 5 and 6, all in bfloat16. "twin": the same
# route with each kernel swapped for its plain version (only float32
# summation order differs, so outputs differ by single bfloat16 steps).
# "plain": the reference's default route (sdpa and einsum expert FFNs),
# which rounds attention scores and weights to bfloat16 where the flash
# kernel keeps float32. A wrong mask, head or expert moves a value by its
# whole scale (rel_rms about 1.4 between unrelated values).
# Dense: the logits at the end of 24 layers, (largest |Δ|, rms(Δ)/rms).
SERVE_TOL = {"twin": (0.125, 0.02), "plain": (0.25, 0.05)}
# MoE: the end-to-end logits are reported, not checked. Router logits are
# rounded to bfloat16 before top-k, so a change in the last bit of a
# token's hidden state can send it to another expert; with the reference's
# init (expert weights of std 1/sqrt(n_experts) = 0.125) an expert's output
# is large against the residual, and over 48 layers every row of every
# route ends on another trajectory: the twin and the plain route too,
# which run no kernel (phase 7 prints them). Instead each layer of the
# kernel route is held against the same layer of the other route on the
# kernel route's own input, over the tokens the two routed alike (the
# same experts, kept or dropped alike; see ``recording_routes``): (largest
# |Δ| over the largest |output|, rms(Δ)/rms(output)): a few bfloat16
# steps against the twin, twice that against the plain route, which
# rounds at three more places in attention. At least 90% of tokens must route alike in every
# layer (measured on an H100: 99.95% against the twin, 95.6% against the
# plain route).
LAYER_TOL = {"twin": (0.02, 0.01), "plain": (0.04, 0.02)}
LAYER_MIN_ALIKE = 0.9
# MoE end to end where routing is not chaotic: moonshot at full width with
# its depth cut to MOE_SHORT_LAYERS, in float32 (router logits no longer
# rounded to bfloat16, so routing ties are rare and the routes differ in
# summation order only): the kernel route's logits against the twin's and
# the plain route's, (largest |Δ|, rms(Δ)/rms), and greedy tokens equal.
# Measured on an H100: largest |Δ| 2.8e-5, rel_rms 5e-6 against both;
# bfloat16 at the same depth already parts at rel_rms 0.13-0.18, the twin
# against the plain route (no kernel on either side) included.
MOE_SHORT_LAYERS = 4
MOE_F32_TOL = {"twin": (3e-4, 5e-5), "plain": (3e-4, 5e-5)}
# RWKV-6, phase 8. The kernel and twin routes differ in float32 summation
# order inside the scan only (the plain route is the twin route here: the
# reference's default route is the plain chunked scan). In bfloat16 their
# logits at the end of 32 layers part by rel_rms 0.039 on an H100, with
# the scan's outputs within one bfloat16 step of each other, and so does
# a witness that runs no kernel (the plain scan at chunk 64 against chunk
# 128: 0.041): the random-weight model amplifies rounding over depth. So
# the end-to-end bf16 logits are reported, and held instead layer by
# layer on the kernel route's own inputs (SSM_LAYER_TOL: largest |Δ| over
# the largest |output| and rms(Δ)/rms of each layer's output, rms(Δ)/rms
# of its WKV state) and end to end in float32 at full depth (SSM_F32_TOL:
# largest |Δ| and rms(Δ)/rms of the logits, and the share of greedy
# tokens that agree). Measured on an H100: layers 0.0065, 1.1e-3 and
# 5.9e-8; float32 logits 5.1e-5 and 9.6e-6, tokens all equal. Each limit
# is about ten times its reading; the token share lets one row of the 8
# part at a near-tie of its top logits (0.875 would be one row's 8
# tokens).
SSM_LAYER_TOL = (0.05, 0.01, 1e-6)
SSM_F32_TOL = (5e-4, 1e-4, 0.85)
SSM_F32_GEN = 8
# phase 9: arch, batch, prompt, new tokens, depth. 500 = 3 × 128 + 116.
SSM_E2E = ("rwkv6-3b", 4, 500, 8, 4)
# ... the kernel route's serve against the reference's token-by-token
# route: logits (largest |Δ|, rms(Δ)/rms) and the state after the prompt
# (rms(Δ)/rms of the WKV state, largest |Δ| of the shifts), and in
# float32 greedy tokens equal. Measured on an H100: float32 logits 2.0e-5
# and 4.1e-6, state 1.6e-6, shifts 1.8e-5; the float32 limits are about
# ten times that. bfloat16 logits 0.072 and 0.013, state 0.0030, shifts
# 0.0625 (one bfloat16 step at 8-16), greedy agreement 0.875: rounding
# amplified over 4 layers, as in phase 8; its limits are about four times
# the reading (the shifts', four steps).
SSM_E2E_TOL = {"float32": dict(logits=(2e-4, 4e-5), wkv=2e-5, shift=2e-4),
               "bfloat16": dict(logits=(0.25, 0.05), wkv=0.015, shift=0.25)}

# phase 2 shapes: (B, N) of the repository's grids — the throughput grid
# (53 slots), the run.py Table-1 grid (73), the default config (153) and
# the full-size grid of phase 4 (2313)
CHECK_SHAPES = ((1026, 53), (1026, 73), (1026, 153), (108, 2313))

FULL_CUTS = (
    "background arrivals stop after 1024 slots (about 4.8 h of HPC2N "
    "traffic, about 26 h of UPPMAX traffic)",
    "two seeds per cell",
    "policies 0-2 only (bigjob, per_stage, asa)",
    "cold estimators (no warm_fleet rounds before the full-size sweep)",
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(ops: float, nbytes: float, dtype=torch.float32
           ) -> tuple[float, str]:
    """The larger of ``nbytes`` over the memory rate and ``ops`` over the
    peak rate for ``dtype`` (bf16 tensor cores, else float32), in ms."""
    peak = (H100_BF16_OPS_PER_S if dtype == torch.bfloat16
            else H100_F32_OPS_PER_S)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def freed_bound_ms(b: int, n: int) -> tuple[float, str]:
    """Least time for ``freed_matrix`` on a (b, n) table: read ends and
    cores (f32) and the running mask (bool) once, write freed (f32) once;
    the sort and scan do about n·(log2 n + 3) float32 operations a row."""
    return _bound(b * n * (math.ceil(math.log2(max(n, 2))) + 3),
                  b * n * (4 + 4 + 1 + 4))


def flash_bound_ms(b, s, h, hd, window, dtype) -> tuple[float, str]:
    """Least time for causal attention over (b, s, h, hd): read q, k, v
    once and write o once; 4·hd operations (q·k and p·v) for each visible
    (query, key) pair."""
    q = torch.arange(s, dtype=torch.float64)
    pairs = float((q + 1).clamp(max=window).sum()) if window else \
        s * (s + 1) / 2
    size = torch.finfo(dtype).bits // 8
    return _bound(4.0 * b * h * hd * pairs, 4.0 * b * s * h * hd * size,
                  dtype)


def gmm_bound_ms(e, c, d, f, dtype) -> tuple[float, str]:
    """Least time for (e, c, d) @ (e, d, f): read x and w once, write the
    output once; 2·c·d·f operations an expert."""
    size = torch.finfo(dtype).bits // 8
    return _bound(2.0 * e * c * d * f,
                  (e * c * d + e * d * f + e * c * f) * size, dtype)


def wkv_bound_ms(b, s, h, k, chunk, dtype, state0: bool
                 ) -> tuple[float, str]:
    """Least time for the chunked WKV6 over (b, s, h, k): read r, k, v (in
    ``dtype``), w (float32) and state0 once, write out (in ``dtype``) and
    the final state (float32) once. Operations per head and chunk of c
    steps: for each pair s < t and channel, 5 for the pair term (the
    exponent, its exp, two products, the sum) and 2 for its product with
    v; for each (t, channel), 2 for r ⊙ exp(cum_excl), 2·k for its
    product with the state and 5 for the bonus; for the update, 2 for
    each (s, channel) decay, 2·k for each (s, channel) outer product and
    2 for each state entry."""
    size = torch.finfo(dtype).bits // 8
    n = b * s * h * k
    nbytes = n * (3 * size + 4 + size) + b * h * k * k * 4 * (1 + state0)
    c = chunk
    pairs = c * (c - 1) // 2
    per_chunk = (pairs * k * 7 + c * k * (2 + 2 * k + 5)
                 + c * k * (2 + 2 * k) + 2 * k * k)
    return _bound(float(b * h * (s // c) * per_chunk), nbytes, dtype)


def rel_errs(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(largest ||Δ|| / ||want|| over the rows of the last axis,
    rms(Δ) / rms(want)): errors relative to the output, row by row, so a
    row whose outputs are small is held as tightly as one near 1."""
    d, w = got.float() - want.float(), want.float()
    row = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return float(row.max()), float(d.pow(2).mean().sqrt()
                                    / w.pow(2).mean().sqrt())


def random_tables(b: int, n: int, gen: torch.Generator, dev):
    """Tables from a seed: forced end-time ties, a mix of running and
    non-running rows, one all-idle row, integer core counts."""
    ends = torch.rand(b, n, generator=gen) * 1e4
    ends[:, ::4] = 5000.0
    cores = torch.randint(1, 64, (b, n), generator=gen).float()
    running = torch.rand(b, n, generator=gen) < 0.6
    running[0] = False
    return ends.to(dev), cores.to(dev), running.to(dev)


def kernel_vs_plain(backfill, dev) -> dict:
    """Phase 2: freed_matrix (sort + freed_scan kernel) against the plain
    ``_freed_sorted`` at every shape; returns the per-shape results."""
    gen = torch.Generator().manual_seed(11)
    rows = {}
    for b, n in CHECK_SHAPES:
        e, c, r = random_tables(b, n, gen, dev)
        got = backfill.freed_vector(e, c, r, mode="kernel")
        want = backfill._freed_sorted(e, c, r)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"freed_scan != _freed_sorted at {(b, n)} (max err {err})")
        ms = cuda_ms(lambda: backfill.freed_vector(e, c, r, mode="kernel"))
        plain_ms = cuda_ms(lambda: backfill._freed_sorted(e, c, r))
        bound, by = freed_bound_ms(b, n)
        # the kernel alone on pre-sorted rows: 20 B a slot (sorted ends and
        # cores, the int64 order, freed)
        em, cm = backfill._masked(e, c, r)
        e_s, order = torch.sort(em, dim=1, stable=True)
        c_s = torch.gather(cm, 1, order)
        scan_ms = cuda_ms(lambda: backfill.freed_scan(e_s, c_s, order))
        scan_bound = b * n * 20 / H100_BYTES_PER_S * 1e3
        rows[(b, n)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, scan_ms=scan_ms,
                            scan_bound_ms=scan_bound)
        print(f"kernel/freed_scan B={b} N={n}: bitwise=True "
              f"ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound:.6f} "
              f"({by}) scan_only_ms={scan_ms:.6f} "
              f"scan_bound_ms={scan_bound:.6f}")
    return rows


def flash_check(tag: str, got, want, dtype) -> tuple[float, float, float]:
    """Hold a flash-attention output against ``attention_ref``'s within
    ``FLASH_ATOL`` and ``FLASH_REL``; returns (max err, worst row,
    rel_rms)."""
    err = float((got.float() - want.float()).abs().max())
    row, rms = rel_errs(got, want)
    lim_row, lim_rms = FLASH_REL[dtype]
    check(err <= FLASH_ATOL[dtype] and row <= lim_row and rms <= lim_rms,
          f"flash_attention {tag}: max err {err} (atol {FLASH_ATOL[dtype]}), "
          f"worst row {row} ({lim_row}), rel_rms {rms} ({lim_rms})")
    return err, row, rms


def flash_vs_plain(dev) -> dict:
    """Phase 2: the flash-attention kernel, in the design ``flash_design``
    picks, against ``attention_ref`` (and, for the serve shapes,
    ``F.scaled_dot_product_attention`` timed as a yardstick) at
    ``FLASH_SHAPES``; at the bfloat16 serve shapes, which the tensor-core
    design serves, the CUDA-core design too, called by name
    (``flash_attention_simt``) and held to the same limits."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(12)
    rows = {}
    for b, s, h, hd, window, dtype in FLASH_SHAPES:
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        design = ops.flash_design(dtype, hd)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        key = f"{b}x{s}x{h}x{hd}" + (f"w{window}" if window else "") + \
            ("-f32" if dtype == torch.float32 else "")
        err, row, rms = flash_check(f"{key} {design}", got, want, dtype)
        lim_row, lim_rms = FLASH_REL[dtype]
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                 window=window), reps=10)
        plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True,
                                                     window=window), reps=10)
        lib_ms = None
        if not window:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), reps=10)
        bound, by = flash_bound_ms(b, s, h, hd, window, dtype)
        rows[key] = dict(design=design, max_abs_err=err, rel_row_err=row,
                         rel_rms=rms, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        simt = ""
        if key in FLASH_SERVE_KEYS:
            got = ops.flash_attention_simt(q, k, v, causal=True)
            torch.cuda.synchronize()
            s_err, s_row, s_rms = flash_check(f"{key} simt", got, want,
                                              dtype)
            s_ms = cuda_ms(lambda: ops.flash_attention_simt(q, k, v,
                                                            causal=True),
                           reps=5)
            rows[key].update(simt_ms=s_ms, simt_max_abs_err=s_err,
                             simt_rel_row_err=s_row, simt_rel_rms=s_rms)
            simt = (f" simt_ms={s_ms:.6f} (simt max_abs_err={s_err:.6g} "
                    f"worst_row_rel={s_row:.6g} rel_rms={s_rms:.6g})")
        print(f"kernel/flash_attention {key}: design={design} "
              f"max_abs_err={err:.6g} "
              f"(atol {FLASH_ATOL[dtype]}) worst_row_rel={row:.6g} "
              f"rel_rms={rms:.6g} (limits {lim_row}, {lim_rms}) ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={lib_ms} "
              f"bound_ms={bound:.6f} ({by}){simt}")
        del q, k, v, got, want
    return rows


def wkv_vs_plain(dev) -> dict:
    """Phase 2: the wkv6 kernel, in the design ``wkv6_design`` picks,
    against its plain chunked version at ``WKV_SHAPES`` (out and final
    state), the small case against the sequential ``wkv6_ref`` too; at
    every bfloat16 case the CUDA-core design too, called by name
    (``wkv6_simt``): its output within the same limits, and the final
    state of the design that ran bitwise equal to its. At the serve shape
    the CUDA-core design is timed as a yardstick. Every case is read
    before any is checked."""
    from repro_torch.kernels.rwkv6_scan import ops, ref

    gen = torch.Generator(device=dev).manual_seed(14)
    rows, failed = {}, []
    for b, s, h, k, chunk, dtype, (w_lo, w_hi), with_state, seq in \
            WKV_SHAPES:
        shape = (b, s, h, k)
        r, kk, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                    for _ in range(3))
        z_lo, z_hi = math.log(-math.log(w_hi)), math.log(-math.log(w_lo))
        w = torch.exp(-torch.exp(z_lo + (z_hi - z_lo) * torch.rand(
            shape, generator=gen, device=dev)))
        u = torch.randn((h, k), generator=gen, device=dev) * 0.5
        s0 = (torch.randn((b, h, k, k), generator=gen, device=dev) * 0.3
              if with_state else None)
        design = ops.wkv6_design(dtype, k, chunk)
        got_o, got_s = ops.wkv6(r, kk, v, w, u, chunk=chunk, state0=s0)
        want_o, want_s = ref.wkv_chunked_ref(r, kk, v, w, u, chunk=chunk,
                                             state0=s0)
        torch.cuda.synchronize()
        key = f"{b}x{s}x{h}x{k}c{chunk}" + ("-state0" if with_state else "") \
            + ("-f32" if dtype == torch.float32 else "") \
            + (f"-wmin{w_lo:g}" if w_lo < 1e-5 else "")
        finite = bool(torch.isfinite(got_o.float()).all()
                      and torch.isfinite(got_s).all())
        err = float((got_o.float() - want_o.float()).abs().max())
        serr = float((got_s - want_s).abs().max())
        row, rms = rel_errs(got_o, want_o)
        srow, srms = rel_errs(got_s, want_s)
        lim, slim = WKV_REL[dtype], WKV_STATE_REL
        ok = (finite and row <= lim[0] and rms <= lim[1]
              and srow <= slim[0] and srms <= slim[1])
        extra = ""
        if seq:
            ok = ok and err <= WKV_ATOL[0] and serr <= WKV_ATOL[1]
            seq_o, seq_s = ref.wkv6_ref(r, kk, v, w, u, state0=s0)
            q_row, q_rms = rel_errs(got_o, seq_o)
            qs_row, qs_rms = rel_errs(got_s, seq_s)
            ok = ok and max(q_row, qs_row) <= WKV_SEQ_REL[0] \
                and max(q_rms, qs_rms) <= WKV_SEQ_REL[1]
            extra = (f" vs_sequential: out worst_row_rel={q_row:.6g} "
                     f"rel_rms={q_rms:.6g} state worst_row_rel={qs_row:.6g}"
                     f" rel_rms={qs_rms:.6g} (limits {WKV_SEQ_REL}); "
                     f"atol {WKV_ATOL}")
        simt = {}
        if dtype == torch.bfloat16:
            simt_o, simt_s = ops.wkv6_simt(r, kk, v, w, u, chunk=chunk,
                                           state0=s0)
            torch.cuda.synchronize()
            s_row, s_rms = rel_errs(simt_o, want_o)
            simt = dict(state_bitwise_simt=bool(torch.equal(got_s, simt_s)),
                        simt_rel_row_err=s_row, simt_rel_rms=s_rms)
            ok = ok and simt["state_bitwise_simt"] and s_row <= lim[0] \
                and s_rms <= lim[1]
            extra += (f" simt: out worst_row_rel={s_row:.6g} rel_rms="
                      f"{s_rms:.6g}, state bitwise equal to simt="
                      f"{simt['state_bitwise_simt']}")
            del simt_o, simt_s
        if not ok:
            failed.append(key)
        ms = cuda_ms(lambda: ops.wkv6(r, kk, v, w, u, chunk=chunk,
                                      state0=s0), reps=10)
        if key == WKV_SERVE_KEY:
            simt["simt_ms"] = cuda_ms(lambda: ops.wkv6_simt(
                r, kk, v, w, u, chunk=chunk, state0=s0), reps=5)
            extra += f" simt_ms={simt['simt_ms']:.6f}"
        plain_ms = cuda_ms(lambda: ref.wkv_chunked_ref(
            r, kk, v, w, u, chunk=chunk, state0=s0), reps=3, warmup=1)
        bound, by = wkv_bound_ms(b, s, h, k, chunk, dtype, with_state)
        rows[key] = dict(design=design, max_abs_err=err,
                         state_max_abs_err=serr, rel_row_err=row,
                         rel_rms=rms, state_rel_row_err=srow,
                         state_rel_rms=srms, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound, bound_by=by, **simt)
        print(f"kernel/wkv6 {key}: design={design} finite={finite} "
              f"out max_abs_err={err:.6g}"
              f" worst_row_rel={row:.6g} rel_rms={rms:.6g} (limits {lim}) "
              f"state max_abs_err={serr:.6g} worst_row_rel={srow:.6g} "
              f"rel_rms={srms:.6g} (limits {slim}){extra} ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms=None bound_ms="
              f"{bound:.6f} ({by})")
        del r, kk, v, w, u, s0, got_o, got_s, want_o, want_s
    check(not failed, f"wkv6 beyond its limits at {failed}")
    return rows


def gmm_check(tag: str, got, want, dtype) -> tuple[float, float, float]:
    """Hold a grouped-matmul output against the plain version's within
    ``GMM_TOL`` and ``GMM_REL``; returns (max err, worst row, rel_rms)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rtol, atol = GMM_TOL[dtype]
    row, rms = rel_errs(got, want)
    lim_row, lim_rms = GMM_REL[dtype]
    check(bool((diff <= atol + rtol * want.float().abs()).all())
          and row <= lim_row and rms <= lim_rms,
          f"grouped_matmul {tag}: max err {err} (rtol {rtol} atol {atol}), "
          f"worst row {row} ({lim_row}), rel_rms {rms} ({lim_rms})")
    return err, row, rms


def gmm_vs_plain(dev) -> dict:
    """Phase 2: the grouped-matmul kernel, in the design ``gmm_design``
    picks, against ``grouped_matmul_ref`` at ``GMM_SHAPES``, with
    ``torch.bmm`` timed as a yardstick; at the bfloat16 shapes, which the
    tensor-core design serves, the CUDA-core design too, called by name
    (``grouped_matmul_simt``) and held to the same limits. bfloat16 inputs
    are scaled as activations and fan-in-scaled weights, so outputs stay
    below 4, where one bfloat16 step is at most 0.0156."""
    from repro_torch.kernels.moe_gmm import ops, ref

    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for e, c, d, f, dtype in GMM_SHAPES:
        bf = dtype == torch.bfloat16
        x = (torch.randn((e, c, d), generator=gen, device=dev)
             * (0.5 if bf else 1.0)).to(dtype)
        w = (torch.randn((e, d, f), generator=gen, device=dev)
             * (d ** -0.5 if bf else 1.0)).to(dtype)
        key = f"{e}x{c}x{d}x{f}" + ("" if bf else "-f32")
        design = ops.gmm_design(dtype, d, f)
        want = ref.grouped_matmul_ref(x, w)
        got = ops.grouped_matmul(x, w)
        torch.cuda.synchronize()
        err, row, rms = gmm_check(f"{key} {design}", got, want, dtype)
        ms = cuda_ms(lambda: ops.grouped_matmul(x, w), reps=10)
        plain_ms = cuda_ms(lambda: ref.grouped_matmul_ref(x, w), reps=10)
        lib_ms = cuda_ms(lambda: torch.bmm(x, w), reps=10)
        bound, by = gmm_bound_ms(e, c, d, f, dtype)
        rows[key] = dict(design=design, max_abs_err=err, rel_row_err=row,
                         rel_rms=rms, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        simt = ""
        if design != "simt":
            got = ops.grouped_matmul_simt(x, w)
            torch.cuda.synchronize()
            s_err, s_row, s_rms = gmm_check(f"{key} simt", got, want, dtype)
            s_ms = cuda_ms(lambda: ops.grouped_matmul_simt(x, w), reps=5)
            rows[key].update(simt_ms=s_ms, simt_max_abs_err=s_err,
                             simt_rel_row_err=s_row, simt_rel_rms=s_rms)
            simt = (f" simt_ms={s_ms:.6f} (simt max_abs_err={s_err:.6g} "
                    f"worst_row_rel={s_row:.6g} rel_rms={s_rms:.6g})")
        print(f"kernel/grouped_matmul {key}: design={design} "
              f"max_abs_err={err:.6g} worst_row_rel={row:.6g} "
              f"rel_rms={rms:.6g} ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms={lib_ms:.6f} bound_ms={bound:.6f} ({by}){simt}")
        del x, w, got, want
    return rows


@contextlib.contextmanager
def patched(*swaps):
    """Within the block, each ``(module, name, fn)`` has ``module.name``
    set to ``fn``; the originals come back after it."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_kernels():
    """The "twin" route: the kernel wrappers run their plain versions on
    CUDA tensors too."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm import ref as gmm_ref
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    return patched((flash_ops, "flash_attention", flash_ref.attention_ref),
                   (gmm_ops, "grouped_matmul", gmm_ref.grouped_matmul_ref),
                   (wkv_ops, "wkv6", wkv_ref.wkv_chunked_ref))


def recording_routes(log: list):
    """Append, for each MoE dispatch, an (N, E) int8 table of each token's
    routing to ``log``: 0 for an expert not picked, 1 for a pick dropped
    by the capacity limit, 2 for a pick kept. A token's output follows
    from its table smoothly; a change in the table changes it wholesale
    (and a flip of one token can push another past an expert's
    capacity)."""
    from repro_torch.models import moe

    dispatch = moe.dispatch

    def spy(expert_idx, C, n_experts):
        order, keep, dest = dispatch(expert_idx, C, n_experts)
        kept = torch.empty_like(keep)
        kept[order] = keep
        table = torch.zeros((expert_idx.shape[0], n_experts),
                            dtype=torch.int8, device=expert_idx.device)
        table.scatter_(1, expert_idx,
                       1 + kept.view(expert_idx.shape).to(torch.int8))
        log.append(table)
        return order, keep, dest
    return patched((moe, "dispatch", spy))


def _compare(res, other, v: int) -> dict:
    """Largest and relative-rms logit differences of two routes: prefill
    logits over all rows, first-decode logits over the rows whose first
    greedy token agreed; and the share of greedy tokens that agree."""
    same = (res["tokens"][:, 0] == other["tokens"][:, 0])
    out = dict(token_agreement=float((res["tokens"] == other["tokens"])
                                     .float().mean()))
    for name, key, rows in (("prefill", "prefill_logits", None),
                            ("decode", "decode_logits", same)):
        a, b = (r[key].float()[..., :v] for r in (res, other))
        if rows is not None:
            a, b = a[rows], b[rows]
        d = a - b
        out[f"{name}_rows"] = a.shape[0]
        out[f"{name}_max"] = float(d.abs().max()) if a.numel() else 0.0
        out[f"{name}_rel"] = float(d.pow(2).mean().sqrt()
                                   / b.pow(2).mean().sqrt()) \
            if a.numel() else 0.0
    return out


def print_compare(tag: str, c: dict, batch: int, note: str = "") -> None:
    print(f"{tag}: prefill_logits max_abs_diff={c['prefill_max']:.6f} "
          f"rel_rms={c['prefill_rel']:.6f} over {c['prefill_rows']} rows; "
          f"first_decode_logits max_abs_diff={c['decode_max']:.6f} "
          f"rel_rms={c['decode_rel']:.6f} over {c['decode_rows']} of "
          f"{batch} rows (same first token); greedy_token_agreement="
          f"{c['token_agreement']:.6f} {note}".rstrip())


def moe_end_to_end(dev) -> None:
    """Phase 7: moonshot's end-to-end logits at full width, the kernel,
    twin and plain routes pairwise. Held: float32 with the depth cut to
    ``MOE_SHORT_LAYERS`` (``MOE_F32_TOL``, greedy tokens equal). Printed
    as witnesses of the bfloat16 divergence that leaves phase 6's logits
    unchecked: bfloat16 at that depth, and at full depth from another
    seed (the twin against the plain route runs no kernel on either
    side)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_lm

    arch, batch, prompt_len, gen = SERVE["moe"]
    base = get_arch(arch)
    failed = []
    for n_layers, dtype, seed in ((MOE_SHORT_LAYERS, "float32", 0),
                                  (MOE_SHORT_LAYERS, "bfloat16", 0),
                                  (base.n_layers, "bfloat16", 1)):
        cfg = dataclasses.replace(base, n_layers=n_layers, dtype=dtype)
        params = init_lm(cfg, seed=seed, device=dev)
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len), device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed))
        for cnt in (gmm_ops.DESIGN_LAUNCHES, flash_ops.DESIGN_LAUNCHES):
            for k in cnt:
                cnt[k] = 0
        routes = {"kernel": launch_serve.generate(params, prompts, cfg, gen,
                                                  use_kernels=True)}
        # float32 stays on the CUDA cores, bfloat16 goes to the tensor cores
        designs = dict(gmm_ops.DESIGN_LAUNCHES)
        flash_designs = dict(flash_ops.DESIGN_LAUNCHES)
        want = "simt" if dtype == "float32" else "wgmma"
        print(f"serve/moe/e2e_{dtype}_L{n_layers}_seed{seed}: "
              f"grouped_matmul_designs={designs} "
              f"flash_attention_designs={flash_designs}")
        for name, got in (("grouped_matmul", designs),
                          ("flash_attention", flash_designs)):
            check(got[want] > 0 and sum(got.values()) == got[want],
                  f"moonshot {dtype} ran {name} designs {got}, want all "
                  f"{want}")
        with plain_kernels():
            routes["twin"] = launch_serve.generate(params, prompts, cfg, gen,
                                                   use_kernels=True)
        routes["plain"] = launch_serve.generate(params, prompts, cfg, gen)
        held = dtype == "float32"
        tag = f"serve/moe/e2e_{dtype}_L{n_layers}_seed{seed}"
        for a, b in (("kernel", "twin"), ("kernel", "plain"),
                     ("twin", "plain")):
            c = _compare(routes[a], routes[b], cfg.vocab_size)
            tol = MOE_F32_TOL[b] if held and a == "kernel" else None
            print_compare(f"{tag}/{a}_vs_{b}", c, batch,
                          f"(tolerance: max {tol[0]}, rel_rms {tol[1]}, "
                          f"tokens equal)" if tol else "(not checked)")
            if tol and not (c["token_agreement"] == 1.0 and all(
                    c[f"{n}_max"] <= tol[0] and c[f"{n}_rel"] <= tol[1]
                    for n in ("prefill", "decode"))):
                failed.append(f"{tag}/{a}_vs_{b}")
        del params, prompts, routes
        torch.cuda.empty_cache()
    check(not failed, f"MoE end to end beyond tolerance: {failed}")


def layer_check(tag: str, params, prompts, cfg) -> None:
    """MoE: each layer of the kernel route (prefill, then the first decode
    step) against the same layer of the twin and the plain route, on the
    kernel route's own layer inputs, over the tokens the two routed alike
    (see ``LAYER_TOL``)."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as T

    block, calls, picks = T._block, [], []

    def spy(lp, x, cfg_, **kw):
        out, kv = block(lp, x, cfg_, **kw)
        calls.append((lp, x, kw, out))
        return out, kv

    with patched((T, "_block", spy)), recording_routes(picks):
        launch_serve.generate(params, prompts, cfg, 1, use_kernels=True)
    failed = []
    for route in ("twin", "plain"):
        worst_max = worst_rel = 0.0
        min_alike, at = 1.0, {}
        for i, ((lp, x, kw, out), mine) in enumerate(zip(calls, picks)):
            theirs = []
            if route == "twin":
                ctx, flags = plain_kernels(), {}
            else:
                ctx = contextlib.nullcontext()
                flags = dict(use_flash=False, use_moe_kernel=False)
            with ctx, recording_routes(theirs):
                other, _ = block(lp, x, cfg, **dict(kw, **flags))
            alike = (mine == theirs[0]).all(dim=1)
            a = out.reshape(alike.numel(), -1)[alike].float()
            b = other.reshape(alike.numel(), -1)[alike].float()
            d = a - b
            ratio = float(d.abs().max() / b.abs().max())
            rel = float(d.pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
            share = float(alike.float().mean())
            if ratio > worst_max:
                worst_max, at["max"] = ratio, i
            if rel > worst_rel:
                worst_rel, at["rel"] = rel, i
            if share < min_alike:
                min_alike, at["alike"] = share, i
        tol_max, tol_rel = LAYER_TOL[route]
        print(f"{tag}/layers_vs_{route}: {len(calls)} layer calls "
              f"(prefill and first decode step) worst max_abs_diff/max_abs="
              f"{worst_max:.6f} worst rel_rms={worst_rel:.6f} "
              f"least share routed alike={min_alike:.6f} (at layer calls "
              f"{at}; tolerance: {tol_max}, {tol_rel}, share >= "
              f"{LAYER_MIN_ALIKE})")
        if not (worst_max <= tol_max and worst_rel <= tol_rel
                and min_alike >= LAYER_MIN_ALIKE):
            failed.append(route)
    check(not failed, f"{tag}: layers of the kernel route differ from the "
          f"{failed} route(s) beyond tolerance")


def ssm_layer_check(tag: str, params, prompts, cfg) -> None:
    """RWKV-6: each layer of the kernel route (prefill, then the first
    decode step) against the same layer of the twin route, on the kernel
    route's own layer inputs and carried state (``SSM_LAYER_TOL``)."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import rwkv6 as R

    block, calls = R._block, []

    def spy(lp, x, cfg_, **kw):
        # the carried state is a view the caller overwrites after the call
        kw = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
        out = block(lp, x, cfg_, **kw)
        calls.append((lp, x, kw, out))
        return out

    with patched((R, "_block", spy)):
        launch_serve.generate(params, prompts, cfg, 1, use_kernels=True)
    worst, at = [0.0, 0.0, 0.0], [0, 0, 0]
    with plain_kernels():
        for i, (lp, x, kw, out) in enumerate(calls):
            other = block(lp, x, cfg, **kw)
            a, b = out[0].float(), other[0].float()
            d = a - b
            errs = (float(d.abs().max() / b.abs().max()),
                    float(d.pow(2).mean().sqrt() / b.pow(2).mean().sqrt()),
                    rel_errs(out[1][2], other[1][2])[1])
            for j, e in enumerate(errs):
                if e > worst[j]:
                    worst[j], at[j] = e, i
    print(f"{tag}/layers_vs_twin: {len(calls)} layer calls (prefill and "
          f"first decode step) worst max_abs_diff/max_abs={worst[0]:.6g} "
          f"worst rel_rms={worst[1]:.6g} worst wkv state rel_rms="
          f"{worst[2]:.6g} (at layer calls {at}; tolerance: "
          f"{SSM_LAYER_TOL})")
    check(all(w <= t for w, t in zip(worst, SSM_LAYER_TOL)),
          f"{tag}: layers of the kernel route differ from the twin route "
          f"beyond tolerance")


def ssm_float32_full_depth(dev) -> None:
    """RWKV-6 end to end in float32 at full width and depth (the bfloat16
    model's weights, unrounded): the kernel route against the twin route
    (``SSM_F32_TOL``)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import rwkv6 as R

    arch, batch, prompt_len, _ = SERVE["ssm"]
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    params = R.init_lm(cfg, seed=0, device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    before = dict(wkv_ops.DESIGN_LAUNCHES)
    kern = launch_serve.generate(params, prompts, cfg, SSM_F32_GEN,
                                 use_kernels=True)
    designs = {d: wkv_ops.DESIGN_LAUNCHES[d] - before[d] for d in before}
    # float32 stays on the CUDA cores
    check(designs == {"mma": 0, "simt": cfg.n_layers},
          f"rwkv6-3b float32 ran wkv6 designs {designs}, want all "
          f"{cfg.n_layers} through simt")
    with plain_kernels():
        twin = launch_serve.generate(params, prompts, cfg, SSM_F32_GEN,
                                     use_kernels=True)
    c = _compare(kern, twin, cfg.vocab_size)
    tol_max, tol_rel, tol_agree = SSM_F32_TOL
    tag = f"serve/ssm/e2e_float32_L{cfg.n_layers}"
    print_compare(f"{tag}/kernel_vs_twin", c, batch,
                  f"(tolerance: max {tol_max}, rel_rms {tol_rel}, "
                  f"agreement >= {tol_agree})")
    print(f"{tag}: logits prefill max_abs_diff={c['prefill_max']:.6g} "
          f"rel_rms={c['prefill_rel']:.6g}, first decode "
          f"{c['decode_max']:.6g} and {c['decode_rel']:.6g}; prefill_ms "
          f"kernel={kern['prefill_s'] * 1e3:.3f} twin="
          f"{twin['prefill_s'] * 1e3:.3f}; wkv6_designs={designs}")
    del params, prompts, kern, twin
    torch.cuda.empty_cache()
    check(c["token_agreement"] >= tol_agree and all(
        c[f"{n}_max"] <= tol_max and c[f"{n}_rel"] <= tol_rel
        for n in ("prefill", "decode")),
        f"{tag}: the kernel route differs from the twin route beyond "
        f"tolerance")


def profile_serve(tag: str, params, prompts, cfg, steps: int = 4) -> None:
    """Where the kernel route's time goes: one profiled prefill, then
    ``steps`` profiled decode steps (RWKV-6's carry the prefill's state
    on, in place, from one call of the window to the next)."""
    from repro_torch.models.transformer import init_kv_caches
    from repro_torch.serve.step import (greedy_sample, make_decode_step,
                                        make_prefill_step)

    prefill = make_prefill_step(cfg, use_kernels=True)
    decode = make_decode_step(cfg, use_kernels=True)
    ssm = cfg.family == "ssm"
    names = (("wkv6_kernel", "wkv6_state_kernel", "wkv6_out_kernel") if ssm
             else
             ("flash_wgmma_kernel", "flash_kernel", "gmm_wgmma_kernel",
              "gmm_kernel"))
    device_profile(f"{tag}/profile_prefill",
                   lambda: prefill(params, prompts), 1, "prefill", names)
    b, s = prompts.shape
    logits, pf = prefill(params, prompts)
    if not ssm:
        caches = init_kv_caches(cfg, b, s + steps, device=prompts.device)
        caches["k"][:, :, :s] = pf["k"]
        caches["v"][:, :, :s] = pf["v"]
        del pf
    first = greedy_sample(logits)

    def run():
        tok = first
        for i in range(steps):
            out, _ = (decode(params, tok, pf) if ssm
                      else decode(params, tok, caches, s + i))
            tok = greedy_sample(out)
    device_profile(f"{tag}/profile_decode", run, steps, "decode steps",
                   names)


def serve_phase(family: str, dev) -> dict:
    """Phases 5, 6 and 8: ``launch.serve.serve`` at full size through the
    kernels (the main path; the counts are reset just before it and read
    just after), then the same params and prompts through the kernel route
    again (steady times), the twin route and, for a transformer, the plain
    route (no kernel may launch in either), compared; for the MoE model
    layer by layer too; then a profiled prefill and decode."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.lm import flatten, padded_vocab

    counters = (flash_ops.KERNEL_LAUNCHES, gmm_ops.KERNEL_LAUNCHES,
                wkv_ops.KERNEL_LAUNCHES)

    def reset():
        for cnt in counters + (gmm_ops.DESIGN_LAUNCHES,
                               flash_ops.DESIGN_LAUNCHES,
                               wkv_ops.DESIGN_LAUNCHES):
            for k in cnt:
                cnt[k] = 0

    def read():
        return {k: v for cnt in counters for k, v in cnt.items()}

    arch, batch, prompt_len, gen = SERVE[family]
    tag = f"serve/{family}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    res = launch_serve.serve(arch, reduced=False, batch=batch,
                             prompt_len=prompt_len, gen=gen, seed=0,
                             device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read()
    designs = dict(gmm_ops.DESIGN_LAUNCHES)
    flash_designs = dict(flash_ops.DESIGN_LAUNCHES)
    wkv_designs = dict(wkv_ops.DESIGN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    leaves = flatten(params).values()
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{tag}: arch={arch} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={n_params} weight_bytes={weight_bytes} batch={batch} "
          f"prompt_len={prompt_len} gen={gen}")
    if family != "dense":
        print(f"{tag}/cut: none (all {cfg.n_layers} layers at full width)")

    v = cfg.vocab_size
    pf = res["prefill_logits"].float()
    check(pf.shape == (batch, 1, padded_vocab(cfg))
          and bool(torch.isfinite(pf[..., :v]).all()),
          f"{tag}: prefill logits not finite of shape ({batch}, 1, V)")
    toks = res["tokens"]
    check(toks.shape == (batch, gen) and int(toks.min()) >= 0
          and int(toks.max()) < v, f"{tag}: tokens out of range")

    routes = {"kernel": res}
    routes["kernel_steady"] = launch_serve.generate(params, prompts, cfg,
                                                    gen, use_kernels=True)
    check(torch.equal(toks, routes["kernel_steady"]["tokens"]),
          f"{tag}: the kernel route is not repeatable")
    reset()
    with plain_kernels():
        routes["twin"] = launch_serve.generate(params, prompts, cfg, gen,
                                               use_kernels=True)
    if family == "ssm":
        # the witness: the plain scan in chunks of half the length, the
        # same recurrence in another summation order, no kernel
        half = dataclasses.replace(cfg, rwkv=dataclasses.replace(
            cfg.rwkv, chunk=cfg.rwkv.chunk // 2))
        routes["plain_half_chunk"] = launch_serve.generate(params, prompts,
                                                           half, gen)
    else:
        routes["plain"] = launch_serve.generate(params, prompts, cfg, gen)
    check(not any(read().values()),
          f"{tag}: the twin or plain route launched kernels: {read()}")

    for route, r in routes.items():
        total = r["prefill_s"] + r["decode_s"]
        print(f"{tag}/{route}: prefill_ms={r['prefill_s'] * 1e3:.3f} "
              f"prefill_tok_per_s={batch * prompt_len / r['prefill_s']:.1f} "
              f"decode_ms_per_step={r['decode_s'] * 1e3 / gen:.3f} "
              f"tok_per_s={batch * gen / total:.3f}")
    print(f"{tag}: serve_wall_s={wall_s:.3f} (init and prompts included) "
          f"peak_mem_bytes={peak} launches={launches} "
          f"grouped_matmul_designs={designs} "
          f"flash_attention_designs={flash_designs} "
          f"wkv6_designs={wkv_designs}")
    if family == "ssm":
        # every bfloat16 wkv6 launch of the serve path on the tensor
        # cores: one a layer, in prefill
        want = cfg.n_layers
        check(wkv_designs == {"mma": want, "simt": 0}
              and launches["wkv6"] == want,
              f"{tag}: wkv6 launches by design {wkv_designs}, want all "
              f"{want} through mma")
    if family != "ssm":
        # every bfloat16 flash launch of the serve path on the tensor
        # cores: one a layer, in prefill
        want = cfg.n_layers
        check(flash_designs == {"wgmma": want, "simt": 0}
              and launches["flash_attention"] == want,
              f"{tag}: flash_attention launches by design {flash_designs}, "
              f"want all {want} through wgmma")
    if family == "moe":
        # every bfloat16 launch of the serve path on the tensor cores: 3 a
        # layer (gate, up, down) in prefill and in each decode step
        want = 3 * cfg.n_layers * (1 + gen)
        check(designs == {"wgmma": want, "simt": 0}
              and launches["grouped_matmul"] == want,
              f"{tag}: grouped_matmul launches by design {designs}, want "
              f"all {want} through wgmma")
    failed = []
    for other, (tol_max, tol_rel) in SERVE_TOL.items():
        if other not in routes:
            continue
        c = _compare(res, routes[other], v)
        checked = family == "dense"
        print_compare(f"{tag}/vs_{other}", c, batch, (
            f"(tolerance: max {tol_max}, rel_rms {tol_rel})" if checked
            else "(not checked: MoE routing, see the layer check and "
            "phase 7)" if family == "moe" else "(not checked: bfloat16 "
            "over 32 layers, see the witness, the layer check and the "
            "float32 run)"))
        if checked and not (c["decode_rows"] > 0 and all(
                c[f"{n}_max"] <= tol_max and c[f"{n}_rel"] <= tol_rel
                for n in ("prefill", "decode"))):
            failed.append(other)
    check(not failed, f"{tag}: the kernel route differs from the "
          f"{failed} route(s) beyond tolerance")
    # no kernel on either side: how far the routes part without the kernels
    for other in ("plain", "plain_half_chunk"):
        if other in routes:
            print_compare(f"{tag}/twin_vs_{other}", _compare(
                routes["twin"], routes[other], v), batch)
    del routes, res
    if family == "moe":
        layer_check(tag, params, prompts, cfg)
    if family == "ssm":
        ssm_layer_check(tag, params, prompts, cfg)
    profile_serve(tag, params, prompts, cfg)
    del params, prompts
    torch.cuda.empty_cache()
    return dict(launches=launches, designs=designs,
                flash_designs=flash_designs, wkv_designs=wkv_designs)


def stepwise_generate(params, prompts, cfg, gen: int) -> dict:
    """The reference's serving route for RWKV-6 (``repro/launch/serve.py``,
    its ``ssm`` branch): ``decode_step`` over the prompt one token at a
    time from ``init_decode_state`` (the one-step recurrence, no kernel),
    then greedy decode. Returns ``generate``'s keys but the times, and
    ``state``, a copy of the state after the prompt."""
    from repro_torch.models import rwkv6 as R
    from repro_torch.serve.step import greedy_sample

    b, s = prompts.shape
    state = R.init_decode_state(cfg, b, device=prompts.device)
    for t in range(s):
        logits, state = R.decode_step(params, prompts[:, t:t + 1], state, cfg)
    after = {k: v.clone() for k, v in state.items()}
    out = dict(prefill_logits=logits, decode_logits=None, state=after)
    token, generated = greedy_sample(logits), []
    for i in range(gen):
        generated.append(token)
        logits, state = R.decode_step(params, token, state, cfg)
        if i == 0:
            out["decode_logits"] = logits
        token = greedy_sample(logits)
    out["tokens"] = torch.cat(generated, dim=1)
    return out


def ssm_end_to_end(dev) -> None:
    """Phase 9: rwkv6-3b at full width, depth cut (``SSM_E2E``), a ragged
    prompt: the kernel route's ``generate`` (and the state its prefill
    leaves) against the reference's token-by-token route, in float32 and
    bfloat16 (``SSM_E2E_TOL``); float32 greedy tokens must be equal."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import rwkv6 as R

    arch, batch, prompt_len, gen, n_layers = SSM_E2E
    base = get_arch(arch)
    chunk = base.rwkv.chunk
    failed = []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, n_layers=n_layers, dtype=dtype)
        params = R.init_lm(cfg, seed=0, device=dev)
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len), device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        before = wkv_ops.KERNEL_LAUNCHES["wkv6"]
        before_d = dict(wkv_ops.DESIGN_LAUNCHES)
        res = launch_serve.generate(params, prompts, cfg, gen,
                                    use_kernels=True)
        launches = wkv_ops.KERNEL_LAUNCHES["wkv6"] - before
        designs = {d: wkv_ops.DESIGN_LAUNCHES[d] - before_d[d]
                   for d in before_d}
        # float32 on the CUDA cores, bfloat16 (the 116-step tail block
        # too) on the tensor cores
        want_design = "simt" if dtype == "float32" else "mma"
        _, state = R.prefill(params, prompts, cfg, use_kernel=True)
        ref = stepwise_generate(params, prompts, cfg, gen)
        c = _compare(res, ref, cfg.vocab_size)
        wkv_rel = rel_errs(state["wkv"], ref["state"]["wkv"])[1]
        shift = max(float((state[k].float() - ref["state"][k].float())
                          .abs().max()) for k in ("tm_shift", "cm_shift"))
        tol = SSM_E2E_TOL[dtype]
        tag = f"serve/ssm/e2e_{dtype}_L{n_layers}"
        print_compare(f"{tag}/kernel_vs_stepwise", c, batch,
                      f"(tolerance: max {tol['logits'][0]}, rel_rms "
                      f"{tol['logits'][1]}" + (", tokens equal)"
                                               if dtype == "float32" else ")"))
        print(f"{tag}: prompt {prompt_len} = {prompt_len // chunk} x {chunk} "
              f"+ {prompt_len % chunk}; logits prefill max_abs_diff="
              f"{c['prefill_max']:.6g} rel_rms={c['prefill_rel']:.6g}, first "
              f"decode {c['decode_max']:.6g} and {c['decode_rel']:.6g}; "
              f"wkv6 launches={launches} designs={designs} "
              f"state_after_prompt wkv rel_rms={wkv_rel:.6g} (limit "
              f"{tol['wkv']}) shift max_abs_diff={shift:.6g} (limit "
              f"{tol['shift']})")
        ok = (launches == 2 * n_layers and designs[want_design] == launches
              and wkv_rel <= tol["wkv"]
              and shift <= tol["shift"] and all(
                  c[f"{n}_max"] <= tol["logits"][0]
                  and c[f"{n}_rel"] <= tol["logits"][1]
                  for n in ("prefill", "decode")))
        if dtype == "float32":
            ok = ok and c["token_agreement"] == 1.0
        if not ok:
            failed.append(tag)
        del params, prompts, res, state, ref
        torch.cuda.empty_cache()
    check(not failed, f"RWKV-6 against the token-by-token route beyond "
          f"tolerance: {failed}")


def strategy_rows(grid, m: dict) -> None:
    by: dict[str, list[int]] = {}
    for i, lab in enumerate(grid.labels):
        by.setdefault(lab["strategy"], []).append(i)
    for strat, idx in sorted(by.items()):
        vals = {k: float(np.mean(m[k][idx])) for k in
                ("twt_s", "makespan_s", "core_hours", "oh_hours")}
        print(f"table1/{strat}: n={len(idx)} " + " ".join(
            f"{k}={v:.6f}" for k, v in vals.items()))
    frac = float(m["wf_done"].sum() / m["wf_total"].sum())
    print(f"table1/wf_done_frac={frac:.6f}")


def states_equal(a, b) -> bool:
    from repro_torch import convert

    x, y = convert.to_numpy(a), convert.to_numpy(b)
    return x.keys() == y.keys() and all(
        np.array_equal(x[k], y[k]) for k in x)


def table1_setting(grid_mod, policies, backfill, dev) -> None:
    """Phase 3: ``benchmarks/run.py``'s xsim leg on the port, kernel path
    and plain path, bitwise; the kernel path must launch the kernel and
    the plain path must not."""
    cfg = grid_mod.XSimConfig(n_warm=24, n_backlog=16, n_arrivals=24,
                              max_stages=9, t0=3600.0)
    grid = grid_mod.make_grid(cfg, n_seeds=4, shrink=1 / 64.0,
                              policy_ids=(0, 1, 2), device=dev)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    t0 = time.perf_counter()
    fleet = grid_mod.warm_fleet(fleet, grid, rounds=3, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    backfill.KERNEL_LAUNCHES["freed_scan"] = 0
    t0 = time.perf_counter()
    fin_k, m_k = grid_mod.run_grid(grid, fleet, pred_seed=7, device=dev)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    kern_launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    backfill.KERNEL_LAUNCHES["freed_scan"] = 0
    t0 = time.perf_counter()
    fin_r, _ = grid_mod.run_grid(grid, fleet, pred_seed=7, freed_mode="ref",
                                 device=dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    check(kern_launches > 0 and backfill.KERNEL_LAUNCHES["freed_scan"] == 0,
          f"Table-1 launches: kernel path {kern_launches}, plain path "
          f"{backfill.KERNEL_LAUNCHES['freed_scan']}")
    check(states_equal(fin_k, fin_r),
          "Table-1 sweep: kernel path and plain path differ")
    m = {k: v.cpu().numpy() for k, v in m_k.items()}
    for k in ("twt_s", "makespan_s", "core_hours"):
        check(m[k].shape == (grid.n,) and bool(np.all(np.isfinite(m[k]))),
              f"Table-1 metric {k} not finite of shape ({grid.n},)")
    print(f"table1: B={grid.n} N={cfg.max_jobs} n_steps={cfg.n_steps} "
          f"warm_fleet_s={warm_s:.3f} kernel_path_s={kern_s:.3f} "
          f"plain_path_s={ref_s:.3f} bitwise_equal=True "
          f"freed_scan_launches={kern_launches}")
    strategy_rows(grid, m)


def full_size(grid_mod, policies, backfill, dev, RUNNING) -> dict:
    """Phase 4: the main path at full size; returns its numbers and the
    kernel launch counts of its first run."""
    cfg = grid_mod.XSimConfig(n_warm=512, n_backlog=768, n_arrivals=1024,
                              max_stages=9)
    grid = grid_mod.make_grid(cfg, shrink=1.0, policy_ids=(0, 1, 2),
                              n_seeds=2, device=dev)
    check(grid.n == 108 and cfg.max_jobs == 2313,
          f"full-size grid is {grid.n} x {cfg.max_jobs}")
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    # the kernel's inputs at the sweep's first scheduling pass
    s0 = grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=dev), 1))
    first_inputs = (s0.end, s0.cores, s0.status == RUNNING)

    torch.cuda.reset_peak_memory_stats()
    for k in backfill.KERNEL_LAUNCHES:
        backfill.KERNEL_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    final, m = grid_mod.run_grid(grid, fleet, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(backfill.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    final2, _ = grid_mod.run_grid(grid, fleet, device=dev)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    check(states_equal(final, final2), "full-size sweep is not repeatable")

    m = {k: v.cpu().numpy() for k, v in m.items()}
    steps = final.steps.cpu().numpy()
    frac = float(m["wf_done"].sum() / m["wf_total"].sum())
    for k in ("twt_s", "makespan_s", "core_hours"):
        fin = np.isfinite(m[k])
        check(m[k].shape == (grid.n,), f"full-size metric {k} shape")
        check(bool(np.all(fin | (m["wf_done"] < m["wf_total"]))),
              f"full-size metric {k} not finite for a finished scenario")
    total_cores = sorted({float(x) for x in
                          grid.centers.total_cores.cpu().numpy()})
    print(f"full: B={grid.n} N={cfg.max_jobs} centers_cores={total_cores} "
          f"n_steps_budget={cfg.n_steps} steps_max={int(steps.max())} "
          f"steps_mean={float(steps.mean()):.3f} "
          f"first_run_s={first_s:.6f} steady_s={steady_s:.6f} "
          f"scenarios_per_s={grid.n / steady_s:.6f} "
          f"wf_done_frac={frac:.6f} "
          f"freed_scan_launches={launches['freed_scan']} "
          f"peak_mem_bytes={peak}")
    for cut in FULL_CUTS:
        print(f"full/cut: {cut}")
    strategy_rows(grid, m)
    check(launches["freed_scan"] > 0,
          "the main path never launched freed_scan")
    return dict(launches=launches, inputs=first_inputs, state=s0)


def device_profile(tag: str, run, n_steps: int, what: str,
                   kernels: tuple[str, ...]) -> None:
    """Device busy and idle share over one call of ``run`` (after one
    warm-up call), the kernels that took the device's time, and the share
    of each named kernel (torch.profiler; prints "not measured" if the
    trace holds no device time). The profiler's own host cost inflates the
    wall time, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the CPU-side aten rows
    # carry their kernels' time too and would count it twice
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"{tag}: {n_steps} {what} wall_us={wall_us:.3f} device "
              f"time not measured (the trace holds no device events)")
        return
    launches = sum(r[2] for r in rows)
    print(f"{tag}: {n_steps} {what} wall_us={wall_us:.3f} "
          f"device_busy_us={busy_us:.3f} "
          f"idle_share={1.0 - busy_us / wall_us:.6f} "
          f"device_launches={launches} "
          f"launches_per_step={launches / n_steps:.1f}")
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        print(f"{tag}/top: {dev:.3f} us x{count} {key[:90]}")
    for name in kernels:
        mine = [r for r in rows if name in r[1]]
        us = sum(r[0] for r in mine)
        print(f"{tag}/{name}: {us:.3f} us x{sum(r[2] for r in mine)} "
              f"= {us / busy_us:.6f} of device busy time")


def profile_window(events_mod, state, n_steps: int = 16) -> None:
    """Where a full-size event step's time goes (16 steps from t=0)."""
    device_profile("profile", lambda: events_mod.simulate(
        state, n_steps=n_steps, chunk_steps=0, pred_mode="greedy"),
        n_steps, "full-size steps", ("freed_scan",))


class Phases:
    """Prints each phase's seconds, from the end of the previous one."""

    def __init__(self):
        self.t0 = self.start = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase/{name}: {now - self.t0:.3f} s (total "
              f"{now - self.start:.3f} s)")
        self.t0 = now


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no port package under {SRC}: run from a checkout")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch import cuda_build
    from repro_torch.xsim import backfill, policies
    from repro_torch.xsim import grid as grid_mod
    from repro_torch.xsim.state import RUNNING

    phases = Phases()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 1: build every kernel, one nvcc per source, in parallel
    sources = [Path(k["source"]).stem for k in KERNELS.values()]
    t0 = time.perf_counter()
    cuda_build.build(sources)
    print(f"build: {sorted(sources)} in {time.perf_counter() - t0:.3f} s")
    for name in sources:   # ptxas -v: registers and spills per kernel
        log = cuda_build.BUILD_INFO[name]["log"]
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spill = max(map(int, re.findall(r"(\d+) bytes spill", log)),
                    default=0)
        print(f"build/{name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, largest "
              f"spill {spill} bytes")
        for line in log.splitlines():   # e.g. wgmma serialised by ptxas
            if "warning" in line.lower():
                print(f"build/{name}/warning: {line.strip()[:200]}")
    phases.done("1_build")

    # phase 2: kernels against their plain versions
    checks = kernel_vs_plain(backfill, dev)
    flash_rows = flash_vs_plain(dev)
    gmm_rows = gmm_vs_plain(dev)
    wkv_rows = wkv_vs_plain(dev)
    phases.done("2_kernels")

    # phase 3: the repository's Table-1 setting, kernel vs plain path
    table1_setting(grid_mod, policies, backfill, dev)
    phases.done("3_table1")

    # phase 4: the main path at full size (counts reset just before it)
    full = full_size(grid_mod, policies, backfill, dev, RUNNING)

    # where a full-size step's time goes (a short profiled window)
    from repro_torch.xsim import events as events_mod
    profile_window(events_mod, full["state"])

    # the kernel at the main path's own inputs (its first pass)
    e, c, r = full["inputs"]
    got = backfill.freed_vector(e, c, r, mode="kernel")
    want = backfill._freed_sorted(e, c, r)
    check(torch.equal(got, want), "freed_scan differs on the sweep's input")
    b, n = e.shape
    ms = cuda_ms(lambda: backfill.freed_vector(e, c, r, mode="kernel"))
    plain_ms = cuda_ms(lambda: backfill._freed_sorted(e, c, r))
    bound, by = freed_bound_ms(b, n)
    err = max([float((got - want).abs().max())]
              + [v["max_abs_err"] for v in checks.values()])
    print(f"kernel/freed_scan main-path input B={b} N={n} "
          f"running={int(r.sum())}: ms={ms:.6f} plain_ms={plain_ms:.6f} "
          f"bound_ms={bound:.6f} ({by})")
    entry = dict(name="freed_scan", **KERNELS["freed_scan"],
                 launches=full["launches"]["freed_scan"], max_abs_err=err,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 library_ms=None, max_abs_diff_vs_plain=err, kernel_ms=ms,
                 shapes={f"{bb}x{nn}": v for (bb, nn), v in checks.items()})
    phases.done("4_full_size")

    # phases 5, 6 and 8: model serving (counts reset inside, per path);
    # phase 7 (moonshot end to end, held in float32 at a cut depth) after
    # phase 6, phase 9 (RWKV-6 against the reference's route) after 8
    served = {}
    for fam, number in (("dense", 5), ("moe", 6), ("ssm", 8)):
        served[fam] = serve_phase(fam, dev)
        if fam == "ssm":
            ssm_float32_full_depth(dev)
        phases.done(f"{number}_serve_{fam}")
        if fam == "moe":
            moe_end_to_end(dev)
            phases.done("7_moe_end_to_end")
    ssm_end_to_end(dev)
    phases.done("9_ssm_end_to_end")
    by_path = {name: {f"serve/{fam}": r["launches"][name]
                      for fam, r in served.items()}
               for name in ("flash_attention", "grouped_matmul", "wkv6")}
    check(by_path["flash_attention"]["serve/dense"] > 0
          and by_path["flash_attention"]["serve/moe"] > 0,
          f"serving never launched flash_attention: {by_path}")
    check(by_path["grouped_matmul"]["serve/moe"] > 0,
          f"MoE serving never launched grouped_matmul: {by_path}")
    from repro_torch.configs import get_arch
    ssm_layers = get_arch(SERVE["ssm"][0]).n_layers
    check(by_path["wkv6"]["serve/ssm"] == ssm_layers,
          f"RWKV-6 serving did not launch wkv6 once per layer of its "
          f"prefill ({ssm_layers}): {by_path}")

    entries = [entry]
    # each kernel's numbers at its first serve path's own shape
    for name, rows, key in (("flash_attention", flash_rows, "8x2048x14x64"),
                            ("grouped_matmul", gmm_rows,
                             "64x480x2048x1408"),
                            ("wkv6", wkv_rows, WKV_SERVE_KEY)):
        r = rows[key]
        entries.append(dict(
            name=name, **KERNELS[name],
            launches=sum(by_path[name].values()),
            launches_by_path=by_path[name],
            max_abs_err=max(v["max_abs_err"] for v in rows.values()),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], shape=key,
            shapes=rows))
    # the grouped matmul: its design and launches by design on serve/moe,
    # and its decode shape's row beside the prefill one
    gmm_entry = next(x for x in entries if x["name"] == "grouped_matmul")
    gmm_entry.update(design=gmm_rows["64x480x2048x1408"]["design"],
                     launches_by_design=served["moe"]["designs"],
                     decode_shape="64x8x2048x1408",
                     decode=gmm_rows["64x8x2048x1408"])
    # flash attention: its design and launches by design over both serve
    # paths, and moonshot's shape's row beside qwen2's
    # wkv6: its design and launches by design on serve/ssm, and the
    # CUDA-core design's time at the serve shape
    wkv_entry = next(x for x in entries if x["name"] == "wkv6")
    wkv_entry.update(design=wkv_rows[WKV_SERVE_KEY]["design"],
                     launches_by_design=served["ssm"]["wkv_designs"],
                     simt_ms=wkv_rows[WKV_SERVE_KEY]["simt_ms"])
    flash_entry = next(x for x in entries if x["name"] == "flash_attention")
    flash_entry.update(
        design=flash_rows["8x2048x14x64"]["design"],
        launches_by_design={d: sum(served[f]["flash_designs"][d]
                                   for f in ("dense", "moe"))
                            for d in ("wgmma", "simt")},
        moe_shape="4x1024x16x128", moe=flash_rows["4x1024x16x128"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
