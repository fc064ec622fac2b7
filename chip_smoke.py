"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every hand-written kernel of the port from the sources in the
checkout, holds each kernel against its plain PyTorch version on the
card, drives the port's main paths (the fleet simulator's Table-1 sweep,
untraced and traced, model serving of a dense and an MoE transformer and
of RWKV-6, the paper's Table-1 and Table-2 runners, the ASA decision
service and the learned submission policy's training, the sharded
paths over blocks on the card and the ASA campaign scheduler,
training with checkpoint/restart, and serving and training the hybrid
and audio families), and checks the results. Phases:

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
   CUDA-core design's; ``freed_scan`` in its one-launch design
   (``fused``, every shape the sweeps give it) and in its earlier design
   (``presorted``, by name), each with its CUDA-event mean a call and its
   device time a call by the profiler; flash attention also at zamba2's
   prefill shape (8, 2048, 32, 64), window 4096;
3. the Table-1 path at the repository's own benchmark setting
   (``benchmarks/run.py``'s xsim leg: 1/64-size centers, policies 0-2,
   warmed fleet), once through the kernel and once through the plain
   reservation scan: the final states must be bitwise identical, and
   every kernel launch ``fused``;
4. the sweep at full size: both centers at their real core counts,
   their three paper scales, three workflows, policies 0-2, two seeds
   (108 scenarios of 2313 job slots), through the user-facing entry
   points; the kernel's launches in this run are counted, and all must
   take the ``fused`` design; one run (phase 13(b) sweeps 4 of its
   lanes again and holds them bitwise to this run), so
   ``scenarios_per_s`` is over the first run; then a profiled window
   of 16 steps and ``freed_scan`` at
   the sweep's own first input (its running slots a row, both designs'
   times);
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
10. the Table-1 setting of phase 3 with ASA-Naive (policies 0-3, 288
   scenarios of 73 slots; a fleet warmed one round on the first family's
   grid, shared by the four families) under each robustness family
   (``clean``, ``faulty``, ``elastic``, ``preempt``), kernel path against
   plain path (run in a worker process on the card while phases 10
   and 11 run, held after phase 11), bitwise, every launch ``fused``;
   per family the strategy rows (twt, makespan, core-hours, OH hours,
   misses, restarts) and the checks: every workflow done under the step
   budget, misses and over-allocation on some ASA-Naive row, kills under
   ``faulty`` and ``preempt``, and at the end ``free == total``,
   ``cap_debt >= 0`` and every fault event consumed on every lane;
11. that naive-and-faults program at full size: phase 4's geometry under
   the ``faulty`` family, policies 2-3 (72 scenarios of 2313 slots), one
   timed run with the same checks and the counts of misses, cancels,
   kills and hook-drain iterations;
12. the paper's tables on the card: (a) the QueueSim differentials of the
   reference's cross-validation tests (6 BigJob, 9 Per-Stage, 12 ASA and
   ASA-Naive, 6 pilot cases and the cancel/resubmit check), each a port
   ``QueueSim`` snapshot frozen by ``xsim.freeze`` into one of two batches
   (27 lanes; 9 with ``naive=True``), swept through the kernel and
   through the plain scan: bitwise equal, every launch ``fused``, each
   lane within the reference's tolerances of the port's ``run_*`` on the
   same simulator; (b) ``sched.runner.run_table1`` at full size for
   HPC2N (three scales, three workflows, ASA-Naive and the pilot; both
   centers until phase 21 took the model split) with the estimators on
   the card and on the CPU in one process: every run equal; the
   normalized averages beside the paper's row, the wall seconds and the
   estimator's share; (c) ``run_table2(n_submissions=5,
   n_warmup=5)`` on the card (the benchmark's 30 submissions and the
   runner's 20 warm-up runs a row cut to 5 each for the smoke's time):
   its 18 rows checked and printed;
13. traced sweeps (``obs``): (a) phase 10's ``faulty`` run traced at
   the default capacity (``XSimConfig.with_trace()``): kernel path
   against plain path bitwise with the event rings, phase 10's untraced
   state and scan launches bit for bit once the ring is removed, no ring
   overflowed, all six event kinds, ``sweep_summary``'s per-kind
   counters summing to its ``trace_events``, the chain waits replayed
   from each ASA and ASA-Naive lane's ring equal to ``twt_s`` bit for
   bit, a Chrome trace and JSONL written and validated; (b) phase 4's
   full-size grid traced, one timed run of the 4 lanes phase 4 drained
   first (all 108 until phase 21 took the model split, then 12): the state
   without its ring bitwise phase 4's same lanes, the scan launches
   phase 4's loop runs over them, ``sweep_summary`` on the
   card equal to the same summary on the CPU (its peak memory printed),
   ``trace_meta``; then 4 profiled steps untraced and traced (16 until
   phase 17 came);
14. the ASA decision service (``serve.loop.ASAServer``) at the setting of
   ``benchmarks/serve_latency.py``: (a) its load generator on the port, a
   traced ``clean`` sweep of ASA at 1/64 size with 57 seeds a cell (1026
   tenants, at least 1000 required) through the kernel and through the
   plain scan, bitwise, every launch ``fused``, turned into the request
   stream (each tenant's stage-0 query, then its observed stage waits in
   simulated-time order); (b) a 1536-slot table, batches of 256: a
   warm-up replay, 3 open-loop replays, a closed-loop replay at 64 in
   flight (decisions/s, p50/p99/max ms, pad fraction, defer rate), 8
   profiled decision steps (launches a step, idle share) and paired
   spans-off/on replays in turns (the observability overhead); (c) save,
   restore, every tenant probed on both servers: bitwise, the codec
   printed; (d) a ``ServeSupervisor`` under chaos (a step exception, a
   burst, a crash): every future resolves with a Decision or a typed
   error, and the restored incarnation answers every tenant bitwise as
   the uninterrupted server; (e) the whole stream through ``step_once``
   on the card and on the CPU route: tenant ids and keys equal, log_p
   and the decisions within stated tolerances, MAP flips counted; (f)
   the merged Chrome trace (rings and server spans, no pid collision)
   validated, and one scrape of ``/metrics`` and ``/metrics.json``;
15. the learned submission policy (``rl``, policy id 4): (a) the full
   recipe's geometry (``rl.train.TrainConfig()``: both centers at 1/64,
   three scales, three workflows, 8 seeds; B=144, N=73): a warmed fleet,
   one sampled rollout (``rl.rollout.collect``) through the kernel and
   through the plain scan (in the worker process of phase 10's plain
   paths), bitwise with the recorded observations and
   actions, every launch ``fused``, every workflow done under the step
   budget; the same rollout on the CPU route from the card-built state
   (lanes that part at a near-tie counted and printed with their gaps);
   one ``reinforce_step`` on the card against the CPU; 4 profiled RL
   steps (16 until phase 17 came); the seconds of a rollout, a
   REINFORCE step and an iteration, and the estimated seconds of the
   30-iteration recipe; (b)
   ``benchmarks/rl_train.py``'s ``SMOKE`` recipe (3 iterations, tiny
   tables) trained and evaluated on the card at its held-out seed 1234,
   held to the reference's contract: the trained head's reward above the
   init head's, its twt no worse than Per-Stage's and within 15% of
   ASA's, no OH for ASA and Per-Stage; the reward curve, the entropies
   and the wall seconds printed;
16. the sharded paths and the campaign: (a) phase 10's ``faulty`` run
   (its grid, warmed fleet and ``pred_seed``) through
   ``run_grid(n_shards=1)`` and over a ``ScenariosMesh`` of 5 blocks on
   the card (288 scenarios padded to 290), each bitwise phase 10's final
   state and metrics,
   ``sharded_sweep_summary``'s counters equal to ``sweep_summary``'s,
   every launch ``fused`` (and over every card where the host has more
   than one); (b) phase 15(a)'s rollout over 2 blocks, bitwise with
   ``rl_obs``/``rl_act`` and the trajectory; (c) phase 14's stream through
   ``step_once`` on a server of ``ServeConfig(n_shards=1)`` and on one over
   4 blocks: decisions, slots and every table replica bitwise, the
   sharded server restored from its checkpoint bitwise, decisions/s
   printed; (d) ``examples/campaign_schedule.py``'s five stages and four
   strategies on the port (estimator seed 1, sims 41 and 42), the
   estimator on the card against the same campaign on the CPU: every
   outcome equal; the example's table printed;
17. training (``repro_torch.launch.train``): (a) qwen2-0.5b at its
   published width (d896, vocab 151936; float32 parameters, m and v,
   bfloat16 activations), its depth cut to 4 layers (the checkpoint's
   size: 24 layers made a 5.4 GB save), batch 4, sequence 1024: 3 steps
   checkpointed at step 2 (``save_async``, the reference's format), a run
   of 5 steps resumed from it, and an uninterrupted 5-step run: every
   loss bitwise equal; the runs' seconds, the checkpoint's bytes and the
   peak memory; (b) for qwen2 (published size), moonshot-v1-16b-a3b
   (published width, 2 layers) and rwkv6-3b (published width, 4 layers):
   training steps on the card (qwen2's timed, seconds a step after the
   first, and one profiled step: idle share), then one batch's loss under
   ``no_grad`` through every kernel of the family (flash attention on the
   tensor cores; the grouped matmul; ``wkv6``) against the plain route,
   within half a bfloat16 step, the launches counted; (c) a
   ``make_train_step(use_flash=True)`` step on the card raises (the
   kernel has no backward) and writes nothing;
18. the hybrid family (``zamba2-1.2b``: 38 Mamba2 layers, d2048, 64 SSD
   heads of 64, a shared attention block of 32 heads every 6 layers,
   vocab 32000): (a) served at its published size in bfloat16 (batch 8,
   prompt 2048, 32 new tokens) through ``launch.serve.serve``, whose
   block prefill runs the flash kernel in each of the 6 shared-block
   invocations, all on the tensor cores (``wgmma``); times, peak memory,
   a profiled prefill and decode (launches a decode step); (b) against
   the twin route: the bfloat16 logits reported, each shared-attention
   call held on the kernel route's own q, k, v and each shared block's
   output on its own input, and the logits and greedy tokens held end
   to end in float32, depth cut to 12 layers (flash on the CUDA cores;
   38 until phase 21 counted launches); (c) the
   block prefill against the reference's token-by-token serving route,
   in float32, depth cut to 12 layers (two shared invocations at the
   published period), a ragged prompt (244 = 128 + 116): logits,
   conv carries, SSD states and KV rings within limits, greedy tokens
   equal; (d) training at published size (float32 parameters, batch 2,
   sequence 1024): seconds a step after the first, peak memory, data
   seconds a batch, the loss through the flash kernel against the plain
   route, a step through the kernel refused; (e) the threefry counter
   past flat index 2^32: ``prng.bits`` and a block of
   ``categorical(shape=)`` rows straddling it, on the card against the
   CPU route, bitwise;
19. the audio family (``whisper-tiny``: 4 encoder and 4 decoder layers,
   d384, 6 heads of 64, 1500 frames, vocab 51865): flash attention at
   its three prefill shapes (the encoder's, the decoder's causal
   self-attention, its cross attention over the frames) against the
   plain version, timed beside SDPA; (a) served at its published size in
   bfloat16 (batch 16, prompt 64, 64 new tokens) through
   ``launch.serve.serve``, whose prefill runs the flash kernel in every
   attention (12 launches, all ``wgmma``); times, peak memory, a profiled
   prefill and decode; (b) against the twin route: the bfloat16 logits
   reported, each flash call held on its own q, k, v, and the logits and
   every greedy token held in float32 at full depth (flash on the CUDA
   cores); (c) training at published size (float32 parameters, batch 4,
   sequence 1024): seconds a step, peak memory, data seconds a batch,
   the loss through the flash kernel against the plain route, a step
   through the kernel refused (its ``launch.train`` restart went when
   phase 21 took the model split: phase 17(a) restarts ``launch.train``
   on the card); (d) the batches'
   frames on the card against the CPU route, bitwise, in bfloat16 and
   float32;
20. the VLM prefix (``pixtral-12b``: mistral-nemo's decoder, 40 layers,
   d5120, 32 heads of 128 over 8 KV heads, d_ff 14336, vocab 131072; its
   "ViT" a stub of precomputed patch embeddings): (a) served at its
   published size in bfloat16 (batch 4, prompt 1024, the route's 8
   patches a request, 32 new tokens) through ``launch.serve.serve``, whose
   prefill runs the flash kernel in every layer over the 1032 rows (40
   launches, all ``wgmma``); times, peak memory, a profiled prefill and
   decode; (b) the prefill step at the config's 1024 patches and a
   1024-token prompt (flash at (4, 2048, 32, 128), row 2e: timed beside
   its plain version and SDPA, with its bound), its flash launches by
   design; (c) against the twin route: the bfloat16 logits reported, each
   flash call held on its own q, k, v, and in float32 at a depth cut to 4
   layers the logits and every greedy token; (d) training at published
   width cut to 4 layers (float32 parameters, batch 2, 1024 patches and
   1024 tokens): seconds a step, peak memory, the loss through the flash
   kernel against the plain route, a step through it refused (its
   restart went when phase 21 took the model split: a 16 GB checkpoint;
   phase 17(a) restarts ``launch.train``); (e) the batches'
   patch embeddings on the card against the CPU route, bitwise; (f)
   ``core.xla_f32``'s exp, log and logsumexp over
   10^7 inputs on the card against the CPU, bitwise; (g) the dry run's
   plan of qwen2-0.5b's ``train_4k`` on a one-card mesh at a reduced
   batch: its argument bytes against the bytes the card holds once
   ``launch.train``'s parameters, optimizer state and batch are placed
   (the requested bytes equal, the allocated blocks within the
   allocator's rounding);
21. training with parameters split over a (data, model) mesh whose
   positions all repeat the card: (a) XLA's float32 ``log1p``, a
   ``normal`` and an ``exponential`` draw on the card against the CPU,
   bitwise; (b) qwen2-0.5b at published size on (2, 2), each layer's
   compute split over ``model`` (``parallel.model_split``), 3 steps
   against ``accum=2``: losses and grad norms within half a bfloat16
   step, the parameter, m and v differences printed, the split route's
   peak held to the other route's plus its repeated shards and gathers,
   two timed rounds and a profiled step of the ``accum`` and the split
   route; (c) (1, 2) against the unsplit step likewise; (d)-(e)
   ``launch.train`` one step on (2, 2) in this process, (g) the same on
   four processes, one a mesh position, all on the card and joined by
   ``parallel.dist`` (``gloo``, host-staged): its losses and checkpoint
   bitwise (d)'s, its seconds, collectives and peaks printed; its
   checkpoint resumed onto (4, 1) and (1, 1) for one more step, bitwise
   the ``accum`` steps, and ``apply_resize`` (2, 2) → (4, 1) bitwise; (f)
   (2, 1), no compute split, at 4 layers: bitwise ``accum=2``.

Matrix products of the plain versions run in full float32 where their
inputs are float32: TF32 is switched off for matmuls and cuDNN.

The second-to-last line is a JSON object with one entry per ported
kernel (``freed_scan``'s launches summed over phases 3, 4 and 10-16, by
path beside; the model kernels' over phases 5, 6, 8, 17(b), 18(a),
18(d), 19(a), 19(c), 20(a) and 20(d)'s loss); the last
line is ``{"ok": true, "device": {...}}``. Any
failure raises and ends the script with a non-zero exit code; without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import atexit
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
                       replaces="src/repro/xsim/backfill.py:125"),
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
# shapes of phases 5 (qwen2), 6 (moonshot) and 18 (zamba2's shared
# attention: window 4096, which a 2048-token prompt does not reach, so
# SDPA's causal call computes the same function), a ragged S, a window,
# f32
FLASH_SHAPES = ((8, 2048, 14, 64, 0, torch.bfloat16),
                (4, 1024, 16, 128, 0, torch.bfloat16),
                (8, 2048, 32, 64, 4096, torch.bfloat16),
                (2, 1000, 4, 64, 0, torch.bfloat16),
                (2, 1000, 4, 128, 256, torch.float32),
                (2, 1024, 16, 128, 0, torch.float32))
# ... the two serve shapes, where the CUDA-core design is held and timed
# beside the tensor-core one
FLASH_SERVE_KEYS = ("8x2048x14x64", "4x1024x16x128")
FLASH_HYBRID_KEY = "8x2048x32x64w4096"
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

# phases 5, 6, 8, 18(a), 19(a) and 20(a): arch, batch, prompt, new tokens
SERVE = {"dense": ("qwen2-0.5b", 8, 2048, 32),
         "moe": ("moonshot-v1-16b-a3b", 4, 1024, 16),
         "ssm": ("rwkv6-3b", 8, 2048, 32),
         "hybrid": ("zamba2-1.2b", 8, 2048, 32),
         "audio": ("whisper-tiny", 16, 64, 64),
         "vlm": ("pixtral-12b", 4, 1024, 32)}
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

# phase 11: the full-size grid under the faulty family with ASA-Naive
# phase 10's estimators: one warm_fleet round on the first family's grid,
# shared by the four families (three rounds a family until the VLM phase
# came: the smoke's time; the checks hold the runs that follow)
WARM_ROUNDS = 1
# phase 10's setting (benchmarks/run.py's xsim leg with ASA-Naive) and its
# grids' cells
NAIVE_CFG = dict(n_warm=24, n_backlog=16, n_arrivals=24, max_stages=9,
                 t0=3600.0)
NAIVE_GRID = dict(n_seeds=4, shrink=1 / 64.0, policy_ids=(0, 1, 2, 3))
FAULTY_SEEDS = 2
FULL_FAULTY_CUTS = (
    "background arrivals stop after 1024 slots (as phase 4)",
    f"{FAULTY_SEEDS} seeds per cell",
    "policies 2-3 only (asa, asa_naive)",
    "cold estimators (no warm_fleet rounds before the sweep)",
)

# phase 12: the paper's tables. (a) the QueueSim differentials of the
# reference's cross-validation tests (tests/test_xsim.py): a warmed tiny
# center (8 nodes of 4 cores, no arrivals after the snapshot at 600 s),
# (kind, workflow, seed) as the reference parametrises them, each case's
# step budget as the reference's test gives it; the "cancel" lanes are its
# cancel/resubmit check (no QueueSim run). Tolerances are the reference's:
# twt and makespan within 2% or 5 s, OH within 1e-3 h, misses and the
# sampled predictions exact.
QS_TINY = dict(
    name="tiny", nodes=8, cores_per_node=4,
    bg_arrival_rate=1 / 200.0, bg_cores_mean=1.5, bg_cores_sigma=0.8,
    bg_duration_mean_s=7.0, bg_duration_sigma=0.8, bg_initial_backlog=12,
    bg_burst_mean=1.0, scales=(8,))
QS_DEPS = ([("bigjob", w, s) for w in ("blast", "statistics")
            for s in (0, 1, 2)]
           + [("per_stage", w, s) for w in ("blast", "statistics", "montage")
              for s in (0, 1, 2)]
           + [("asa", w, s) for w in ("statistics", "montage")
              for s in (0, 2, 3)]
           + [("pilot", w, s) for w in ("blast", "statistics")
              for s in (0, 1, 2)])
QS_NAIVE = ([("asa_naive", w, s) for w in ("statistics", "montage")
             for s in (0, 2, 3)]
            + [("cancel", "montage", s) for s in (0, 2, 3)])
QS_STEPS = {"bigjob": 160, "pilot": 160, "per_stage": 220, "asa": 300,
            "asa_naive": 300, "cancel": 300}
QS_REL, QS_ABS = 0.02, 5.0
# (b) and (c): run_table1 at full size, with ASA-Naive and the pilot, and
# run_table2 at the repository benchmark's own setting
# (benchmarks/table2_accuracy.py) but for its submissions a row
# cut from the benchmark's 30 (the smoke's time): to 10 when phase 15
# came, to 5 when phase 18 did; and each row's warm-up runs from
# run_table2's 20 to 5 (the warm-ups, probe jobs the host's QueueSim runs
# to their start, took about two thirds of the table's time)
TABLE2_SUBMISSIONS = 5
TABLE2_WARMUP = 5
# (b)'s center: the card's 45 runs held against the CPU's (both centers'
# 90 on the CPU until phase 19 came, on the card until the model split
# came: the smoke's time; the other center's were held to nothing but
# finite values)
TABLE1_CPU_CENTER = "hpc2n"

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


def flash_bound_ms(b, s, h, hd, window, dtype, *, sk: int | None = None,
                   causal: bool = True) -> tuple[float, str]:
    """Least time for attention of q (b, s, h, hd) over k, v (b, sk, h,
    hd; sk = s by default), positions from 0 on both: read q, k, v once
    and write o once; 4·hd operations (q·k and p·v) for each visible
    (query, key) pair: all s·sk without a mask, min(q + 1, window, sk)
    for query q under the causal mask."""
    sk = s if sk is None else sk
    q = torch.arange(s, dtype=torch.float64)
    pairs = (float((q + 1).clamp(max=min(window or sk, sk)).sum())
             if causal else float(s * sk))
    size = torch.finfo(dtype).bits // 8
    return _bound(4.0 * b * h * hd * pairs,
                  2.0 * b * h * hd * (s + sk) * size, dtype)


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


def profiled_us(fn, calls: int = 20, tries: int = 4
                ) -> tuple[float | None, float | None]:
    """(device us a call, launches a call) of ``fn()`` over ``calls`` calls
    (torch.profiler; after one warm-up call). CUDA-event means of a call
    this short measure how fast the host issues calls; this is the card's
    own time. The trace can lose some launches of a window (on an H100 it
    kept 0 to 20 of 20 short launches): a window that kept no whole number
    of launches a call is taken again, up to ``tries`` times, and the last
    is scaled (its mean a launch times the nearest whole number of
    launches a call). None if no window held device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    us = count = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(ev.self_device_time_total, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        us, count = sum(r[0] for r in rows), sum(r[1] for r in rows)
        if count and count % calls == 0:
            return us / calls, count / calls
    if not count:
        return None, None
    per_call = max(1, round(count / calls))
    return us / count * per_call, float(per_call)


def freed_readings(backfill, e, c, r) -> dict:
    """``freed_matrix`` in the design its row length picks ("fused" at every
    shape the sweeps give it) and the "presorted" design by name, each
    held bitwise against the plain ``_freed_sorted`` and timed: CUDA-event
    mean a call (host time included), profiled device us and launches a
    call; the plain version's event mean; the bound."""
    b, n = e.shape
    want = backfill._freed_sorted(e, c, r)
    got = backfill.freed_vector(e, c, r, mode="kernel")
    presorted = backfill.freed_presorted(e, c, r)
    torch.cuda.synchronize()
    err = max(float((got - want).abs().max()),
              float((presorted - want).abs().max()))
    check(torch.equal(got, want),
          f"freed_matrix ({backfill.freed_design(n)}) != _freed_sorted at "
          f"{(b, n)} (max err {err})")
    check(torch.equal(presorted, want),
          f"freed_presorted != _freed_sorted at {(b, n)} (max err {err})")
    fused = lambda: backfill.freed_vector(e, c, r, mode="kernel")  # noqa
    pre = lambda: backfill.freed_presorted(e, c, r)  # noqa: E731
    us, launches = profiled_us(fused)
    pre_us, pre_launches = profiled_us(pre)
    bound, by = freed_bound_ms(b, n)
    runs = r.sum(dim=1).float()
    return dict(max_abs_err=err, design=backfill.freed_design(n),
                ms=cuda_ms(fused), device_us=us, launches_per_call=launches,
                presorted_ms=cuda_ms(pre), presorted_device_us=pre_us,
                presorted_launches_per_call=pre_launches,
                plain_ms=cuda_ms(lambda: backfill._freed_sorted(e, c, r)),
                bound_ms=bound, bound_by=by, r_mean=float(runs.mean()),
                r_max=int(runs.max()))


def print_freed(tag: str, v: dict) -> None:
    def num(x, fmt: str) -> str:
        return "not_measured" if x is None else format(x, fmt)

    share = (None if v["device_us"] is None
             else v["bound_ms"] / (v["device_us"] * 1e-3))
    print(f"{tag}: bitwise=True design={v['design']} R_mean={v['r_mean']:.1f}"
          f" R_max={v['r_max']} ms={v['ms']:.6f} device_us="
          f"{num(v['device_us'], '.3f')} launches_per_call="
          f"{num(v['launches_per_call'], 'g')} presorted_ms="
          f"{v['presorted_ms']:.6f} presorted_device_us="
          f"{num(v['presorted_device_us'], '.3f')} "
          f"presorted_launches_per_call="
          f"{num(v['presorted_launches_per_call'], 'g')} plain_ms="
          f"{v['plain_ms']:.6f} bound_ms={v['bound_ms']:.6f} "
          f"({v['bound_by']}) share_of_bound={num(share, '.6f')}")


def kernel_vs_plain(backfill, dev) -> dict:
    """Phase 2: freed_matrix ("fused") and the "presorted" design against
    the plain ``_freed_sorted`` at every shape; returns the per-shape
    results."""
    gen = torch.Generator().manual_seed(11)
    rows = {}
    for b, n in CHECK_SHAPES:
        e, c, r = random_tables(b, n, gen, dev)
        v = freed_readings(backfill, e, c, r)
        # the "presorted" kernel alone on pre-sorted rows: 20 B a slot
        # (sorted ends and cores, the int64 order, freed)
        em, cm = backfill._masked(e, c, r)
        e_s, order = torch.sort(em, dim=1, stable=True)
        c_s = torch.gather(cm, 1, order)
        v["scan_ms"] = cuda_ms(lambda: backfill.freed_scan(e_s, c_s, order))
        v["scan_bound_ms"] = b * n * 20 / H100_BYTES_PER_S * 1e3
        rows[(b, n)] = v
        print_freed(f"kernel/freed_scan B={b} N={n}", v)
        print(f"kernel/freed_scan B={b} N={n}: presorted scan_only_ms="
              f"{v['scan_ms']:.6f} scan_bound_ms={v['scan_bound_ms']:.6f}")
    return rows


def flash_check(tag: str, got, want, dtype, atol: float | None = None
                ) -> tuple[float, float, float]:
    """Hold a flash-attention output against ``attention_ref``'s within
    ``FLASH_REL`` and an absolute ``atol`` (``FLASH_ATOL`` unless given);
    returns (max err, worst row, rel_rms)."""
    err = float((got.float() - want.float()).abs().max())
    row, rms = rel_errs(got, want)
    lim_row, lim_rms = FLASH_REL[dtype]
    atol = FLASH_ATOL[dtype] if atol is None else atol
    check(err <= atol and row <= lim_row and rms <= lim_rms,
          f"flash_attention {tag}: max err {err} (atol {atol}), "
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
        if not window or window >= s:
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


def profile_serve(tag: str, params, prompts, cfg, steps: int = 4,
                  extra: tuple = ()) -> None:
    """Where the kernel route's time goes: one profiled prefill, then
    ``steps`` profiled decode steps (RWKV-6's and Zamba2's carry the
    prefill's state on, in place, from one call of the window to the
    next). The encoder–decoder's prefill also takes its frames, the VLM's
    its patches (``extra``); the VLM's decode starts from an empty cache,
    as its served route's."""
    from repro_torch.models import encdec
    from repro_torch.models.transformer import init_kv_caches
    from repro_torch.serve.step import (greedy_sample, make_decode_step,
                                        make_prefill_step)

    prefill = make_prefill_step(cfg, use_kernels=True)
    decode = make_decode_step(cfg, use_kernels=True)
    ssm = cfg.family == "ssm"
    hybrid = cfg.family == "hybrid"
    names = (("wkv6_kernel", "wkv6_state_kernel", "wkv6_out_kernel") if ssm
             else
             ("flash_wgmma_kernel", "flash_kernel", "gmm_wgmma_kernel",
              "gmm_kernel"))
    b, s = prompts.shape
    pf_kw = dict(max_seq=s + steps) if hybrid else {}
    device_profile(f"{tag}/profile_prefill",
                   lambda: prefill(params, prompts, *extra, **pf_kw), 1,
                   "prefill", names)
    logits, pf = prefill(params, prompts, *extra, **pf_kw)
    if cfg.family == "audio":
        caches = encdec.init_kv_caches(cfg, b, s + steps,
                                       device=prompts.device)
        caches["xk"], caches["xv"] = pf["xk"], pf["xv"]
        del pf
    elif not (ssm or hybrid):
        caches = init_kv_caches(cfg, b, s + steps, device=prompts.device)
        if cfg.family != "vlm":   # the VLM's decode: the empty cache
            caches["k"][:, :, :s] = pf["k"]
            caches["v"][:, :, :s] = pf["v"]
        del pf
    first = greedy_sample(logits)

    def run():
        tok = first
        for i in range(steps):
            out, _ = (decode(params, tok, pf) if ssm
                      else decode(params, tok, pf, s + i) if hybrid
                      else decode(params, tok, caches, s + i))
            tok = greedy_sample(out)
    device_profile(f"{tag}/profile_decode", run, steps, "decode steps",
                   names)


def serve_phase(family: str, dev) -> dict:
    """Phases 5, 6, 8, 18(a)-(b), 19(a)-(b) and 20(a), (c):
    ``launch.serve.serve`` at full size through the kernels (the main
    path; the counts are reset just before it and read just after), then
    the same params and prompts (and frames or patches) through the
    kernel route again (steady times), the twin route and, but for
    RWKV-6, the plain route (no kernel may launch in either), compared;
    for the MoE model and RWKV-6 layer by layer too, for Zamba2 each
    shared attention call and block, for the encoder–decoder and the VLM
    each attention call; then a profiled prefill and decode."""
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
    extra = ({"frames": res["frames"]} if family == "audio" else
             {"patches": res["patches"]} if family == "vlm" else {})
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
    routes["kernel_steady"] = launch_serve.generate(
        params, prompts, cfg, gen, use_kernels=True, **extra)
    check(torch.equal(toks, routes["kernel_steady"]["tokens"]),
          f"{tag}: the kernel route is not repeatable")
    reset()
    with plain_kernels():
        routes["twin"] = launch_serve.generate(params, prompts, cfg, gen,
                                               use_kernels=True, **extra)
    if family == "ssm":
        # the witness: the plain scan in chunks of half the length, the
        # same recurrence in another summation order, no kernel
        half = dataclasses.replace(cfg, rwkv=dataclasses.replace(
            cfg.rwkv, chunk=cfg.rwkv.chunk // 2))
        routes["plain_half_chunk"] = launch_serve.generate(params, prompts,
                                                           half, gen)
    else:
        routes["plain"] = launch_serve.generate(params, prompts, cfg, gen,
                                                **extra)
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
        # cores: one an attention layer (Zamba2: a shared-block
        # invocation; the encoder–decoder: each encoder layer's, and each
        # decoder layer's self and cross attention), in prefill
        from repro_torch.models import zamba2 as Z
        want = (Z.n_attn(cfg) if family == "hybrid"
                else cfg.encoder.n_layers + 2 * cfg.n_layers
                if family == "audio" else cfg.n_layers)
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
            "over 38 layers, see the shared-attention check and the "
            "float32 run)" if family == "hybrid" else "(not checked: "
            "bfloat16, see the attention check and the float32 run)"
            if family in ("audio", "vlm") else "(not checked: "
            "bfloat16 over 32 layers, see the witness, the layer check and "
            "the float32 run)"))
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
    if family == "hybrid":
        hybrid_attention_check(tag, params, prompts, cfg)
    if family in ("audio", "vlm"):
        attention_check(tag, params, prompts, cfg, *extra.values())
    profile_serve(tag, params, prompts, cfg, extra=tuple(extra.values()))
    del params, prompts, extra
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


def strategy_rows(grid, m: dict, tag: str = "table1",
                  keys=("twt_s", "makespan_s", "core_hours", "oh_hours")
                  ) -> None:
    """Each strategy's means of ``keys`` over its scenarios."""
    by: dict[str, list[int]] = {}
    for i, lab in enumerate(grid.labels):
        by.setdefault(lab["strategy"], []).append(i)
    for strat, idx in sorted(by.items()):
        vals = {k: float(np.mean(m[k][idx])) for k in keys}
        print(f"{tag}/{strat}: n={len(idx)} " + " ".join(
            f"{k}={v:.6f}" for k, v in vals.items()))
    frac = float(m["wf_done"].sum() / m["wf_total"].sum())
    print(f"{tag}/wf_done_frac={frac:.6f}")


def states_equal(a, b) -> bool:
    from repro_torch import convert

    return numpy_equal(convert.to_numpy(a), convert.to_numpy(b))


def numpy_equal(x: dict, y: dict) -> bool:
    return x.keys() == y.keys() and all(
        np.array_equal(x[k], y[k]) for k in x)


# Phase 10's plain paths (each family's sweep through the reference scan,
# no kernel), phase 13(a)'s traced one, phase 15(a)'s plain rollout and
# phase 16(a)-(b)'s sharded runs on the one card run in a worker process
# on the card while the main process drives phases 10 and 11, after the
# last reading of phases 2-9 (kernel times, serving rates), so no second
# context shares the card under those: each program is the same on the
# same card, so the worker's states carry the main process's bits (in
# the main process, each in its phase, until the model split came: the
# smoke's time).
def side_runs(path: str, device: str = "cuda:0") -> None:
    """The worker: {run: (final state as numpy, seconds, scan launches,
    extra)} for each family, "faulty_traced" and "rl_rollout" (the plain
    paths), "sharded_n_shards=1", "sharded_blocks=SHARD_BLOCKS" (extra:
    the metrics as numpy) and "rollout_sharded" (extra: the trajectory),
    saved to ``path``."""
    sys.path.insert(0, str(SRC))
    from repro_torch import convert
    from repro_torch.launch.mesh import ScenariosMesh
    from repro_torch.rl import rollout
    from repro_torch.xsim import backfill, families, policies
    from repro_torch.xsim import grid as grid_mod

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = grid_mod.XSimConfig(**NAIVE_CFG)
    out, fleet = {}, None
    runs = [(f, cfg) for f in families.FAMILIES]
    runs.append(("faulty_traced", cfg.with_trace()))
    for name, c in runs:
        grid = families.family_grid(c, name.split("_")[0], **NAIVE_GRID,
                                    device=dev)
        if fleet is None:   # phase 10's one warm round, first family
            fleet = grid_mod.warm_fleet(
                policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                    device=dev), grid, rounds=WARM_ROUNDS,
                device=dev)
        reset_scan_counts(backfill)
        t0 = time.perf_counter()
        fin, _ = grid_mod.run_grid(grid, fleet, pred_seed=7,
                                   freed_mode="ref", device=dev)
        torch.cuda.synchronize()
        out[name] = (convert.to_numpy(fin), time.perf_counter() - t0,
                     backfill.KERNEL_LAUNCHES["freed_scan"], None)
    grid = families.family_grid(cfg, "faulty", **NAIVE_GRID, device=dev)
    for tag, kw in (("n_shards=1", dict(n_shards=1)),
                    (f"blocks={SHARD_BLOCKS}",
                     dict(mesh=ScenariosMesh([dev] * SHARD_BLOCKS)))):
        reset_scan_counts(backfill)
        t0 = time.perf_counter()
        fin, m = grid_mod.run_grid(grid, fleet, pred_seed=7, device=dev,
                                   **kw)
        torch.cuda.synchronize()
        out[f"sharded_{tag}"] = (
            convert.to_numpy(fin), time.perf_counter() - t0,
            dict(backfill.DESIGN_LAUNCHES),
            {k: v.cpu().numpy() for k, v in m.items()})
    grid, fleet, params = rl_setting(dev)
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    fin = rl_rollout(grid, params, fleet, dev, freed_mode="ref")[0]
    torch.cuda.synchronize()
    out["rl_rollout"] = (convert.to_numpy(fin), time.perf_counter() - t0,
                         backfill.KERNEL_LAUNCHES["freed_scan"], None)
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    fin, _, traj = rollout.collect(
        grid, params, fleet, pred_seed=1, rl_mode="sample",
        oh_weight=rl_train_oh_weight(),
        mesh=ScenariosMesh([dev] * ROLLOUT_SHARD_BLOCKS), device=dev)
    torch.cuda.synchronize()
    out["rollout_sharded"] = (convert.to_numpy(fin),
                              time.perf_counter() - t0,
                              dict(backfill.DESIGN_LAUNCHES),
                              [x.cpu() for x in traj])
    torch.save(out, path)


def rl_train_oh_weight() -> float:
    from repro_torch.rl import train as rl_train

    return rl_train.TrainConfig().oh_weight


def rl_setting(dev) -> tuple:
    """Phase 15(a)'s geometry (``rl.train.TrainConfig()``): (grid, warmed
    fleet, initial head)."""
    return (rl_grid(dev),) + rl_fleet_and_head(dev)


def rl_fleet_and_head(dev) -> tuple:
    from repro_torch.core import prng
    from repro_torch.rl import policy as rl_policy
    from repro_torch.rl import train as rl_train

    cfg = rl_train.TrainConfig()
    fleet = rl_train.warmed_fleet(cfg, grid_seed=cfg.seed, device=dev)
    return fleet, rl_policy.init_params(prng.PRNGKey(cfg.seed, dev),
                                        hidden=cfg.hidden, device=dev)


def rl_grid(dev):
    from repro_torch.rl import train as rl_train
    from repro_torch.xsim import families
    from repro_torch.xsim.state import RL

    cfg = rl_train.TrainConfig()
    return families.family_grid(
        cfg.sim, cfg.family, center_names=cfg.center_names,
        workflows=cfg.workflows, policy_ids=(RL,), n_seeds=cfg.n_seeds,
        shrink=cfg.shrink, seed=cfg.seed * 10_000 + 1, device=dev)


def rl_rollout(grid, params, fleet, dev, freed_mode: str = "auto"):
    """Phase 15(a)'s sampled rollout -> ``rollout.collect``'s (final
    state, metrics, trajectory)."""
    from repro_torch.rl import rollout

    return rollout.collect(grid, params, fleet, pred_seed=1,
                           rl_mode="sample", freed_mode=freed_mode,
                           oh_weight=rl_train_oh_weight(), device=dev)


def table1_setting(grid_mod, policies, backfill, dev) -> int:
    """Phase 3: ``benchmarks/run.py``'s xsim leg on the port, kernel path
    and plain path, bitwise; the kernel path must launch the kernel and
    the plain path must not. Returns the kernel path's launches."""
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
    for d in backfill.DESIGN_LAUNCHES:
        backfill.DESIGN_LAUNCHES[d] = 0
    t0 = time.perf_counter()
    fin_k, m_k = grid_mod.run_grid(grid, fleet, pred_seed=7, device=dev)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    kern_launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    designs = dict(backfill.DESIGN_LAUNCHES)
    check(designs["fused"] == kern_launches,
          f"Table-1 kernel path: not every launch took the fused design: "
          f"{designs} of {kern_launches}")
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
          f"freed_scan_launches={kern_launches} by_design={designs}")
    strategy_rows(grid, m)
    return kern_launches


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
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    final, m = grid_mod.run_grid(grid, fleet, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(backfill.KERNEL_LAUNCHES)
    designs = dict(backfill.DESIGN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # one run: phase 13(b) sweeps lanes of the same grid again and holds
    # their state bitwise to this one's, which checks repeatability

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
          f"first_run_s={first_s:.6f} "
          f"scenarios_per_s={grid.n / first_s:.6f} "
          f"scenarios_per_s_from=first_run_s "
          f"wf_done_frac={frac:.6f} "
          f"freed_scan_launches={launches['freed_scan']} "
          f"by_design={designs} peak_mem_bytes={peak}")
    for cut in FULL_CUTS:
        print(f"full/cut: {cut}")
    strategy_rows(grid, m)
    check(launches["freed_scan"] > 0,
          "the main path never launched freed_scan")
    check(designs["fused"] == launches["freed_scan"],
          f"the main path's launches did not all take the fused design: "
          f"{designs} of {launches['freed_scan']}")
    return dict(launches=launches, designs=designs, inputs=first_inputs,
                state=s0, final=final, fleet=fleet, grid=grid)


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


def profile_window(events_mod, state, n_steps: int = 4) -> None:
    """Where a full-size event step's time goes (4 steps from t=0; 16
    until the VLM phase came)."""
    device_profile("profile", lambda: events_mod.simulate(
        state, n_steps=n_steps, chunk_steps=0, pred_mode="greedy"),
        n_steps, "full-size steps", ("freed_scan",))


def reset_scan_counts(backfill) -> None:
    for counts in (backfill.KERNEL_LAUNCHES, backfill.DESIGN_LAUNCHES):
        for k in counts:
            counts[k] = 0


def check_naive_faults_run(tag: str, family: str, grid, final,
                           m: dict) -> dict:
    """The checks of phases 10 and 11 on a finished naive sweep: every
    workflow done under the step budget; a miss and over-allocation on
    some ASA-Naive row; kills under ``faulty`` and ``preempt``; at the
    end every lane holds its whole machine (``free == total``), owes no
    negative drain debt and has consumed its whole fault schedule.
    Returns the counts it read."""
    steps = final.steps.cpu().numpy()
    naive = np.array([lab["strategy"] == "asa_naive"
                      for lab in grid.labels])
    n_faults = grid.fault_t.shape[1]
    check(bool(np.all(m["wf_done"] == m["wf_total"])),
          f"{tag}: not every workflow finished")
    check(int(steps.max()) < grid.cfg.n_steps,
          f"{tag}: a scenario used its whole step budget")
    check(int(m["misses"][naive].sum()) > 0
          and bool(np.any(m["oh_hours"][naive] > 0.0)),
          f"{tag}: no ASA-Naive row missed or over-allocated")
    restarts = int(m["restarts"].sum())
    if family in ("faulty", "preempt"):
        check(restarts > 0, f"{tag}: no job was killed")
    check(bool(torch.equal(final.free, final.total)),
          f"{tag}: free != total at the end")
    check(bool((final.cap_debt >= 0.0).all()), f"{tag}: negative cap_debt")
    check(bool((final.fault_next == n_faults).all()),
          f"{tag}: a fault event was left unprocessed")
    for k in ("twt_s", "makespan_s", "core_hours", "oh_hours"):
        check(m[k].shape == (grid.n,) and bool(np.all(np.isfinite(m[k]))),
              f"{tag}: metric {k} not finite of shape ({grid.n},)")
    return dict(steps_max=int(steps.max()),
                steps_mean=float(steps.mean()),
                misses=int(m["misses"].sum()),
                stages_cancelled=int(torch.isfinite(final.canc_start)
                                     .sum()),
                restarts=restarts)


def table1_families(grid_mod, families, policies, backfill, dev
                    ) -> tuple[dict, dict, dict]:
    """Phase 10: ``benchmarks/run.py``'s xsim leg with ASA-Naive (policies
    0-3) under every robustness family; every launch ``fused``. Returns
    the kernel paths' launches by family, the ``faulty`` run (grid,
    warmed fleet, final state and metrics of its kernel path) that phase
    16(a) shards, and each family's final state as numpy, which
    ``table1_families_vs_plain`` holds against the plain path."""
    from repro_torch import convert

    cfg = grid_mod.XSimConfig(**NAIVE_CFG)
    launches, finals, warmed = {}, {}, None
    for family in families.FAMILIES:
        tag = f"table1_naive/{family}"
        grid = families.family_grid(cfg, family, **NAIVE_GRID, device=dev)
        t0 = time.perf_counter()
        if warmed is None:   # one warm round, on the first family's grid
            fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                        device=dev)
            warmed = grid_mod.warm_fleet(fleet, grid, rounds=WARM_ROUNDS,
                                         device=dev)
        check(int(grid.geo_idx.max()) + 1 == warmed.log_p.shape[0],
              f"{tag}: the families' grids have other geometries")
        fleet = warmed
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        reset_scan_counts(backfill)
        t0 = time.perf_counter()
        fin_k, m_k = grid_mod.run_grid(grid, fleet, pred_seed=7, device=dev)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        kern_launches = backfill.KERNEL_LAUNCHES["freed_scan"]
        designs = dict(backfill.DESIGN_LAUNCHES)
        check(kern_launches > 0 and designs["fused"] == kern_launches,
              f"{tag}: kernel path launches {kern_launches}, by design "
              f"{designs}")
        finals[family] = convert.to_numpy(fin_k)
        m = {k: v.cpu().numpy() for k, v in m_k.items()}
        counts = check_naive_faults_run(tag, family, grid, fin_k, m)
        print(f"{tag}: B={grid.n} N={grid.cfg.max_jobs} "
              f"n_faults={grid.fault_t.shape[1]} "
              f"n_steps_budget={grid.cfg.n_steps} "
              f"warm_fleet_s={warm_s:.3f} kernel_path_s={kern_s:.3f} "
              f"freed_scan_launches={kern_launches} by_design={designs} "
              + " ".join(f"{k}={v}" for k, v in counts.items()))
        strategy_rows(grid, m, tag=tag,
                      keys=("twt_s", "makespan_s", "core_hours", "oh_hours",
                            "misses", "restarts"))
        launches[family] = kern_launches
        print(f"{tag}/cut: the estimators warmed {WARM_ROUNDS} round on "
              f"the first family's grid and shared (3 rounds a family "
              f"before)")
        if family == "faulty":
            faulty = dict(grid=grid, fleet=fleet, final=fin_k, metrics=m_k,
                          pred_seed=7, launches=kern_launches)
    return launches, faulty, finals


def table1_families_vs_plain(finals: dict, plain: Worker) -> None:
    """Phase 10's kernel paths against the plain paths of ``side_runs``'
    worker, bitwise, once the worker is done (after phase 11)."""
    for family, fin_k in finals.items():
        tag = f"table1_naive/{family}"
        fin_r, ref_s, ref_launches, _ = plain.get(family)
        check(ref_launches == 0, f"{tag}: the plain path launched the kernel")
        check(numpy_equal(fin_k, fin_r),
              f"{tag}: kernel path and plain path differ")
        print(f"{tag}/plain: plain_path_s={ref_s:.3f} bitwise_equal=True")


def counting_drain(events_mod, counts: dict):
    """Count, on the device and without a host sync, the naive drain's
    iterations that ran a hook in some lane, the lane-iterations, and the
    cancels (a lane's start hook that set ``repass``), seven small
    launches an iteration; and, on the host, the steps run again with the
    whole drain because a step of their chunk needed more than
    ``events.SPEC_HOOK_PAIRS`` iterations. Counts include the steps run
    again."""
    start_hook, sim_step = events_mod._start_hook, events_mod.sim_step

    def start_spy(s, now, bins, live=None):
        out = start_hook(s, now, bins, live)
        if live is not None:
            counts["drain_iterations"] += live.any()
            counts["drain_lane_iterations"] += live.sum()
            counts["cancels"] += (out.repass & live).sum()
        return out

    def step_spy(s, bins, **kw):
        if kw.get("naive") and kw.get("hook_pairs") is None:
            counts["steps_run_again"] += 1
        return sim_step(s, bins, **kw)
    return patched((events_mod, "_start_hook", start_spy),
                   (events_mod, "sim_step", step_spy))


def full_faulty(grid_mod, families, policies, backfill, events_mod,
                dev) -> int:
    """Phase 11: the naive-and-faults program at full size (phase 4's
    geometry, the ``faulty`` family, policies 2 and 3); one timed run
    with its checks and counts, no profiled window. Returns the run's
    scan launches."""
    cfg = grid_mod.XSimConfig(n_warm=512, n_backlog=768, n_arrivals=1024,
                              max_stages=9)
    grid = families.family_grid(cfg, "faulty", shrink=1.0,
                                policy_ids=(2, 3), n_seeds=FAULTY_SEEDS,
                                device=dev)
    check(grid.n == 36 * FAULTY_SEEDS and grid.cfg.max_jobs == 2313,
          f"full-size faulty grid is {grid.n} x {grid.cfg.max_jobs}")
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    drain = {k: zero.clone() for k in ("drain_iterations",
                                       "drain_lane_iterations", "cancels")}
    drain["steps_run_again"] = 0
    torch.cuda.reset_peak_memory_stats()
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    with counting_drain(events_mod, drain):
        final, m = grid_mod.run_grid(grid, fleet, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    designs = dict(backfill.DESIGN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    m = {k: v.cpu().numpy() for k, v in m.items()}
    counts = check_naive_faults_run("full_faulty", "faulty", grid, final, m)
    check(launches > 0 and designs["fused"] == launches,
          f"full_faulty: launches {launches}, by design {designs}")
    print(f"full_faulty: B={grid.n} N={grid.cfg.max_jobs} "
          f"n_faults={grid.fault_t.shape[1]} "
          f"n_steps_budget={grid.cfg.n_steps} run_s={run_s:.6f} "
          f"ms_per_step={run_s * 1e3 / counts['steps_max']:.3f} "
          f"scenarios_per_s={grid.n / run_s:.6f} "
          f"freed_scan_launches={launches} by_design={designs} "
          f"peak_mem_bytes={peak} "
          + " ".join(f"{k}={v}" for k, v in counts.items()) + " "
          + " ".join(f"{k}={int(v)}" for k, v in drain.items()))
    print("full_faulty/note: run_s includes the drain counters (seven "
          "small launches a drain iteration)")
    for cut in FULL_FAULTY_CUTS:
        print(f"full_faulty/cut: {cut}")
    strategy_rows(grid, m, tag="full_faulty",
                  keys=("twt_s", "makespan_s", "core_hours", "oh_hours",
                        "misses", "restarts"))
    return launches


def queue_sim_batch(cases, dev):
    """Phase 12(a)'s cases frozen into one batch on ``dev``: each a port
    QueueSim snapshot with the workflow's rows, taken before the port's
    ``run_*`` drives the same simulator (estimators on ``dev``). Returns
    the batch and the runs (None for the cancel lanes)."""
    from repro_torch.core import asa, prng
    from repro_torch.sched import strategies as S
    from repro_torch.sched.centers import CenterProfile
    from repro_torch.sched.queue_sim import QueueSim
    from repro_torch.sched.workflows import WORKFLOWS
    from repro_torch.xsim import compare, policies
    from repro_torch.xsim import state as X

    tiny = CenterProfile(**QS_TINY)
    states, refs = [], []
    for kind, name, seed in cases:
        wf = WORKFLOWS[name]
        sim = QueueSim(tiny, seed=seed, bg_horizon=0.0)
        sim.run_until(600.0)
        table, row = compare.scenario_from_queue_sim(sim, max_jobs=64)
        free = compare.queue_sim_free_cores(sim)
        kw, ref = {}, None
        if kind in ("asa", "asa_naive", "cancel"):
            kw["est"] = asa.init(53, prng.PRNGKey(seed + 17, dev))
            if kind != "cancel":
                ref = S.run_asa(sim, wf, 8, "tiny",
                                S.ASAEstimator(seed=seed + 17, device=dev),
                                use_dependencies=kind == "asa")
        else:
            ref = getattr(S, f"run_{kind}")(sim, wf, 8, "tiny")
        if kind == "pilot":
            kw["pilot_waste_cs"] = S.pilot_waste_cs(wf, 8)
        pol = X.ASA_NAIVE if kind == "cancel" else X.POLICY_NAMES.index(kind)
        policies.add_workflow(table, row, wf, 8, pol, t0=600.0)
        states.append(X.freeze(table, total_cores=tiny.total_cores,
                               free_cores=free, now=600.0, policy=pol,
                               t0=600.0, device=dev, **kw))
        refs.append(ref)
    return X.concat(states), refs


def staged_sweep(events_mod, batch, naive: bool, dev, freed_mode: str
                 ) -> dict:
    """The batch after each step budget of ``QS_STEPS``, by continuing one
    sweep (a step is a function of the state alone)."""
    out, done = {}, 0
    for n in sorted(set(QS_STEPS.values())):
        batch = events_mod.sweep(batch, n_steps=n - done, naive=naive,
                                 freed_mode=freed_mode, device=dev)
        out[n], done = batch, n
    if batch.status.is_cuda:
        torch.cuda.synchronize()
    return out


def check_queue_sim_lane(tag: str, case, i: int, fin, m: dict, ref) -> None:
    """The reference's cross-validation assertions on lane ``i``."""
    kind, name, _ = case

    def close(k, want):
        got = float(m[k][i])
        check(abs(got - want) <= max(QS_REL * abs(want), QS_ABS),
              f"{tag}: {k} {got} against the QueueSim's {want}")

    close("twt_s", ref.twt_s)
    close("makespan_s", ref.makespan_s)
    if kind in ("bigjob", "pilot"):
        close("core_hours", ref.core_hours)
    if kind == "per_stage":
        check(0.0 < float(m["utilization"][i]) <= 1.0,
              f"{tag}: utilization out of (0, 1]")
    if kind == "pilot":
        oh = float(m["oh_hours"][i])
        check(abs(oh - ref.oh_hours) <= 1e-5 * abs(ref.oh_hours) and oh > 0,
              f"{tag}: pilot OH {oh} against {ref.oh_hours}")
        check(int(m["wf_done"][i]) == int(m["wf_total"][i]) == 1,
              f"{tag}: the pilot did not finish")
    if kind in ("asa", "asa_naive"):
        from repro_torch.sched.workflows import WORKFLOWS

        oh = float(m["oh_hours"][i])
        check(abs(oh - ref.oh_hours) <= 1e-3,
              f"{tag}: OH {oh} against {ref.oh_hours}")
        check(int(m["misses"][i]) == ref.misses,
              f"{tag}: misses {int(m['misses'][i])} against {ref.misses}")
        check(kind == "asa_naive" or oh == 0.0, f"{tag}: ASA idled")
        preds = fin.pred_wait[i][fin.is_wf[i]].cpu().numpy()
        got = preds[1:len(ref.pred_waits) + 1]
        check(np.allclose(got, ref.pred_waits, rtol=1e-7, atol=0.0),
              f"{tag}: predictions {got.tolist()} against "
              f"{ref.pred_waits}")
        check(int(fin.est.t[i]) >= 2 * len(WORKFLOWS[name].stages),
              f"{tag}: the estimator did not learn in the run")


def queue_sim_differentials(backfill, events_mod, compare_mod, dev) -> int:
    """Phase 12(a): the QueueSim differentials frozen into two batches on
    the card (27 lanes without the naive world, 9 with it), each swept
    through the kernel and through the plain scan: bitwise equal at every
    step budget, every launch ``fused``, each lane held against the port's
    QueueSim run at the reference's tolerances. Returns the kernel
    paths' launches."""
    total = 0
    for name, cases, naive in (("deps", QS_DEPS, False),
                               ("naive", QS_NAIVE, True)):
        tag = f"tables/queue_sim_{name}"
        t0 = time.perf_counter()
        batch, refs = queue_sim_batch(cases, dev)
        build_s = time.perf_counter() - t0
        reset_scan_counts(backfill)
        t0 = time.perf_counter()
        kern = staged_sweep(events_mod, batch, naive, dev, "auto")
        kern_s = time.perf_counter() - t0
        launches = backfill.KERNEL_LAUNCHES["freed_scan"]
        designs = dict(backfill.DESIGN_LAUNCHES)
        check(launches > 0 and designs["fused"] == launches,
              f"{tag}: kernel path launches {launches}, by design {designs}")
        backfill.KERNEL_LAUNCHES["freed_scan"] = 0
        t0 = time.perf_counter()
        plain = staged_sweep(events_mod, batch, naive, dev, "ref")
        plain_s = time.perf_counter() - t0
        check(backfill.KERNEL_LAUNCHES["freed_scan"] == 0,
              f"{tag}: the plain path launched the kernel")
        for n in kern:
            check(states_equal(kern[n], plain[n]),
                  f"{tag}: kernel and plain path differ after {n} steps")
        metrics = {n: {k: v.cpu().numpy()
                       for k, v in compare_mod.metrics(st).items()}
                   for n, st in kern.items()}
        misses = oh = cancelled = 0
        for i, (case, ref) in enumerate(zip(cases, refs)):
            n = QS_STEPS[case[0]]
            m, fin = metrics[n], kern[n]
            lane = f"{tag}/{case[0]}-{case[1]}-{case[2]}"
            if ref is not None:
                check_queue_sim_lane(lane, case, i, fin, m, ref)
            else:
                misses += int(m["misses"][i])
                oh += float(m["oh_hours"][i])
                cancelled += int(torch.isfinite(fin.canc_start[i]).sum())
                check(int(m["wf_done"][i]) == int(m["wf_total"][i]),
                      f"{lane}: a resubmission did not finish")
        if naive:
            check(misses >= 3 and oh > 0.0 and cancelled > 0,
                  f"{tag}: the cancel check saw misses {misses}, OH {oh}, "
                  f"cancelled stages {cancelled}")
        steps = kern[300].steps.cpu().numpy()
        print(f"{tag}: B={len(cases)} N=64 steps_max={int(steps.max())} "
              f"build_s={build_s:.3f} kernel_path_s={kern_s:.3f} "
              f"plain_path_s={plain_s:.3f} bitwise_equal=True "
              f"freed_scan_launches={launches} by_design={designs} "
              f"lanes_within_tolerance={sum(r is not None for r in refs)}"
              + (f" cancel_check_misses={misses} cancel_check_oh_h={oh:.6f}"
                 f" cancelled_stages={cancelled}" if naive else ""))
        total += launches
    return total


def timed_estimator(acc: dict):
    """Within the block, ``ASAEstimator.learn`` and ``predict`` add their
    host seconds and calls to ``acc`` (``predict`` ends in a device read,
    so on the card it also waits for the ``learn`` work queued before
    it)."""
    from repro_torch.sched.strategies import ASAEstimator

    def timed(name: str):
        fn = getattr(ASAEstimator, name)

        def call(self, *args):
            t0 = time.perf_counter()
            try:
                return fn(self, *args)
            finally:
                acc[name][0] += time.perf_counter() - t0
                acc[name][1] += 1
        return call

    for name in ("learn", "predict"):
        acc[name] = [0.0, 0]
    return patched((ASAEstimator, "learn", timed("learn")),
                   (ASAEstimator, "predict", timed("predict")))


def run_timed(tag: str, fn):
    """``fn()`` with its wall seconds and the estimator's share printed."""
    acc: dict = {}
    with timed_estimator(acc):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    est_s = acc["learn"][0] + acc["predict"][0]
    print(f"{tag}: wall_s={wall:.3f} estimator_s={est_s:.3f} "
          f"estimator_share={est_s / wall:.4f} "
          f"learn_calls={acc['learn'][1]} learn_s={acc['learn'][0]:.3f} "
          f"predict_calls={acc['predict'][1]} "
          f"predict_s={acc['predict'][0]:.3f}")
    return out


def table1_on_card(dev) -> None:
    """Phase 12(b): ``run_table1`` at full size for ``TABLE1_CPU_CENTER``
    (its three scales, three workflows; BigJob, Per-Stage, ASA, ASA-Naive,
    pilot) with the estimators on the card, then again with the
    estimators on the CPU, in one process (the estimator seeds are
    ``hash()`` of strings; each (center, scale) has its own estimator and
    background): every run's metrics equal. Prints the normalized
    averages as ``benchmarks/table1_strategies.py`` does, over this one
    center's runs, beside the paper's row (over both centers)."""
    import dataclasses

    from repro_torch.sched import runner

    kw = dict(seed=0, include_naive=True, include_pilot=True)
    one = {TABLE1_CPU_CENTER: runner.CENTERS[TABLE1_CPU_CENTER]}
    with patched((runner, "CENTERS", one)):
        res = run_timed("tables/table1_cuda",
                        lambda: runner.run_table1(**kw, device=dev))
        cpu = run_timed("tables/table1_cpu",
                        lambda: runner.run_table1(**kw, device="cpu"))
    check(len(res.runs) == len(cpu.runs) == 3 * 3 * 5
          and [dataclasses.asdict(r) for r in res.runs]
          == [dataclasses.asdict(r) for r in cpu.runs],
          f"tables/table1: the card's {TABLE1_CPU_CENTER} runs differ from "
          f"the CPU's")
    for r in res.runs:
        check(all(math.isfinite(getattr(r, k)) for k in
                  ("twt_s", "makespan_s", "core_hours", "oh_hours")),
              f"tables/table1: a non-finite metric in {r}")
    naive = [r for r in res.runs if r.strategy == "asa_naive"]
    print(f"tables/table1: runs={len(res.runs)} ({TABLE1_CPU_CENTER}) "
          f"runs_equal_cpu={len(cpu.runs)} "
          f"naive_misses={sum(r.misses for r in naive)} "
          f"naive_oh_h={sum(r.oh_hours for r in naive):.6f}")
    for strat, d in sorted(runner.summarize_table1(res).items()):
        print(f"table1_strategies/{TABLE1_CPU_CENTER}_only/{strat},0,"
              f"twt=+{d['twt']*100:.0f}%;makespan=+{d['makespan']*100:.0f}%;"
              f"ch=+{d['ch']*100:.0f}%")
    print("table1_strategies/paper_ref_both_centers,0,"
          "bigjob_ch=+53%;per_stage_makespan=+34%;asa_makespan=+2%")


def table2_on_card(dev) -> None:
    """Phase 12(c): ``run_table2`` at the repository benchmark's setting,
    its submissions and warm-ups cut (``TABLE2_SUBMISSIONS``,
    ``TABLE2_WARMUP``), with the estimators on the card: 18 rows, ratios
    in [0, 1], finite waits; printed as ``benchmarks/table2_accuracy.py``
    does."""
    from repro_torch.sched import runner

    rows = run_timed("tables/table2_cuda", lambda: runner.run_table2(
        n_submissions=TABLE2_SUBMISSIONS, n_warmup=TABLE2_WARMUP,
        device=dev))
    check(len(rows) == 18, f"tables/table2: {len(rows)} rows, expected 18")
    for r in rows:
        check(0.0 <= r.hit_ratio <= 1.0 and 0.0 <= r.miss_ratio <= 1.0,
              f"tables/table2: a ratio outside [0, 1] in {r}")
        check(all(math.isfinite(getattr(r, k)) for k in
                  ("real_wt_h", "real_wt_std_h", "asa_wt_h", "asa_wt_std_h",
                   "pwt_h", "pwt_std_h", "oh_loss_h")),
              f"tables/table2: a non-finite wait in {r}")
        print(f"table2_accuracy/{r.workflow}_{r.center}_{r.scale},0,"
              f"real={r.real_wt_h:.2f}h;asa={r.asa_wt_h:.2f}h;"
              f"pwt={r.pwt_h:.2f}h;hit={r.hit_ratio:.2f};"
              f"miss={r.miss_ratio:.2f};oh={r.oh_loss_h:.1f}h")
    print(f"tables/table2: rows={len(rows)} "
          f"n_submissions={TABLE2_SUBMISSIONS} n_warmup={TABLE2_WARMUP}")


def state_on_cpu(s):
    """A copy of a port state (a NamedTuple of tensors, ``est`` and
    ``trace`` NamedTuples of tensors inside) on the CPU."""
    return type(s)(*(None if v is None else
                     type(v)(*(x.cpu() for x in v)) if isinstance(v, tuple)
                     else v.cpu() for v in s))


def check_trace(tag: str, grid, final, m: dict, n_steps: int,
                kinds: tuple[str, ...]) -> dict:
    """The checks of phase 13 on a traced final state: no ring overflowed,
    the named event kinds occur, ``sweep_summary``'s per-kind counters
    sum to its ``trace_events``; returns the summary on the host."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    check(not bool(obs_trace.overflowed(final.trace).any()),
          f"{tag}: a ring overflowed")
    h = obs_metrics.to_host(obs_metrics.sweep_summary(final,
                                                      n_steps=n_steps))
    names = obs_trace.EVENT_NAMES.values()
    missing = [k for k in kinds if h[f"ev_{k}"] == 0]
    check(not missing, f"{tag}: no {missing} event in any ring")
    check(sum(h[f"ev_{k}"] for k in names) == h["trace_events"]
          == int(final.trace.head.sum()),
          f"{tag}: per-kind counters do not sum to trace_events")
    check(h["wf_done"] == int(m["wf_done"].sum()),
          f"{tag}: sweep_summary's wf_done differs from the metrics'")
    return h


def traced_table1_faulty(grid_mod, families, backfill, faulty: dict,
                         plain: Worker, dev) -> int:
    """Phase 13(a): phase 10's ``faulty`` run (its grid, warmed fleet and
    ``pred_seed``), traced at the default capacity: kernel path against
    plain path bitwise (rings included), phase 10's untraced state and
    launches bit for bit once the ring is removed, every event kind, the
    replayed chain waits equal to ``twt_s`` on every ASA and ASA-Naive
    lane, a Chrome trace and JSONL written and validated. Returns the
    kernel path's scan launches. (Until the model split came it warmed
    its own estimators for 3 rounds and ran the untraced sweep again.)"""
    import tempfile

    from repro_torch import convert
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import metrics as obs_metrics

    tag = "traced/table1_faulty"
    plain_grid = faulty["grid"]
    grid = families.family_grid(plain_grid.cfg.with_trace(), "faulty",
                                **NAIVE_GRID, device=dev)
    fleet = faulty["fleet"]
    torch.cuda.synchronize()
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    fin_k, m_k = grid_mod.run_grid(grid, fleet, pred_seed=7, device=dev)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    designs = dict(backfill.DESIGN_LAUNCHES)
    check(launches > 0 and designs["fused"] == launches,
          f"{tag}: kernel path launches {launches}, by design {designs}")
    fin_r, ref_s, ref_launches, _ = plain.get("faulty_traced")
    check(ref_launches == 0, f"{tag}: the plain path launched the kernel")
    check(numpy_equal(convert.to_numpy(fin_k), fin_r),
          f"{tag}: kernel path and plain path differ (rings included)")
    fin_u = faulty["final"]
    check(faulty["launches"] == launches,
          f"{tag}: phase 10's untraced run launched the scan "
          f"{faulty['launches']} times, the traced {launches}")
    check(fin_u.trace is None and states_equal(fin_u,
                                               fin_k._replace(trace=None)),
          f"{tag}: without its ring the state differs from phase 10's "
          "untraced run's")
    m = {k: v.cpu().numpy() for k, v in m_k.items()}
    counts = check_naive_faults_run(tag, "faulty", grid, fin_k, m)
    h = check_trace(tag, grid, fin_k, m_k, grid.cfg.n_steps,
                    ("submit", "start", "finish", "cancel", "resubmit",
                     "kill"))
    host = state_on_cpu(fin_k)
    lanes = [i for i, lab in enumerate(grid.labels)
             if lab["strategy"] in ("asa", "asa_naive")]
    for i in lanes:
        twt = obs_metrics.replay_chain_waits(host, i)[2]
        check(twt == m["twt_s"][i],
              f"{tag}: lane {i}: replayed twt {twt!r} != twt_s "
              f"{m['twt_s'][i]!r}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        meta = obs_export.write_chrome_trace(path, fin_k, grid.labels)
        rows = obs_export.write_jsonl(str(Path(tmp) / "events.jsonl"),
                                      fin_k, grid.labels)
        with open(path) as f:
            chrome = json.load(f)
        errs = obs_export.validate_chrome(chrome) + \
            obs_export.validate_file(path)
        size = Path(path).stat().st_size
    check(errs == [], f"{tag}: the Chrome trace is invalid: {errs[:3]}")
    check(rows == meta["events_total"] == h["trace_events"],
          f"{tag}: {rows} JSONL rows, {meta['events_total']} events")
    print(f"{tag}: B={grid.n} N={grid.cfg.max_jobs} "
          f"capacity={grid.cfg.trace_capacity} kernel_path_s={kern_s:.3f} "
          f"plain_path_s={ref_s:.3f} bitwise_equal=True "
          f"untraced_equal=True (phase 10's run) "
          f"freed_scan_launches={launches} by_design={designs} "
          f"replayed_lanes={len(lanes)} chrome_events="
          f"{len(chrome['traceEvents'])} chrome_bytes={size} "
          f"jsonl_rows={rows} "
          + " ".join(f"{k}={v}" for k, v in counts.items()))
    print(f"{tag}/events: total={h['trace_events']} "
          f"dropped={h['trace_dropped']} " + " ".join(
              f"{k}={h[k]}" for k in h if k.startswith("ev_")))
    return launches


# phase 13(b)'s two profiled windows (untraced and traced), steps each:
# cut from 16 to 4 for the smoke's time when phase 17 came
TRACED_PROFILE_STEPS = 4
# phase 13(b)'s traced sweep runs TRACED_LANES of the grid's 108 lanes,
# those phase 4 drained in the fewest steps (all 108 until the model
# split came, then 12: the smoke's time), held against the same lanes of
# phase 4's run
TRACED_LANES = 4


def take_lanes(s, idx: torch.Tensor):
    """The lanes ``idx`` of a batched port state (a NamedTuple of
    tensors, ``est`` and ``trace`` NamedTuples of tensors inside)."""
    return type(s)(*(None if v is None else
                     type(v)(*(x[idx] for x in v)) if isinstance(v, tuple)
                     else v[idx] for v in s))


def traced_full_size(grid_mod, policies, backfill, events_mod, full: dict,
                     dev) -> int:
    """Phase 13(b): phase 4's full-size grid, traced at the default
    capacity, one timed run of ``TRACED_LANES`` of its lanes against the
    same lanes of phase 4's untraced run (the state bitwise once the ring
    is removed, the scan launches phase 4's loop runs over them), the
    summary on the card against the same summary on the CPU, its peak
    memory, ``trace_meta``; then ``TRACED_PROFILE_STEPS`` profiled steps
    of the whole grid, untraced and traced. Returns the run's scan
    launches."""
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import metrics as obs_metrics

    from repro_torch.xsim import compare as compare_mod

    tag = "traced/full"
    plain = full["grid"]
    cfg = plain.cfg.with_trace()
    grid = grid_mod.make_grid(cfg, shrink=1.0, policy_ids=(0, 1, 2),
                              n_seeds=2, device=dev)
    # the lanes phase 4 drained first; the chunked loop runs the steps of
    # its slowest, to the next chunk's end (events.simulate)
    steps4 = full["final"].steps
    lanes = torch.sort(torch.argsort(steps4, stable=True)[:TRACED_LANES]
                       ).values
    rem = cfg.n_steps % cfg.chunk_steps
    want_launches = rem + cfg.chunk_steps * max(0, -(-(int(
        steps4[lanes].max()) - rem) // cfg.chunk_steps))
    ests = policies.scenario_estimators(
        full["fleet"], torch.as_tensor(grid.geo_idx, device=dev), 1)
    s0 = take_lanes(grid.build(ests), lanes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    final = events_mod.sweep(s0, n_steps=cfg.n_steps,
                             chunk_steps=cfg.chunk_steps,
                             pred_mode=cfg.pred_mode, device=dev)
    m = compare_mod.batched_metrics(final)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    designs = dict(backfill.DESIGN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches == want_launches and designs["fused"] == launches,
          f"{tag}: scan launches {launches} {designs}, phase 4's loop "
          f"over these lanes {want_launches}")
    check(states_equal(final._replace(trace=None),
                       take_lanes(full["final"], lanes)),
          f"{tag}: without its ring the state differs from phase 4's "
          f"same lanes")
    h = check_trace(tag, grid, final, m, cfg.n_steps,
                    ("submit", "start", "finish"))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    on_card = obs_metrics.to_host(obs_metrics.sweep_summary(
        final, n_steps=cfg.n_steps))
    summary_s = time.perf_counter() - t0
    summary_peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    on_cpu = obs_metrics.to_host(obs_metrics.sweep_summary(
        state_on_cpu(final), n_steps=cfg.n_steps))
    cpu_s = time.perf_counter() - t0
    check(on_card.keys() == on_cpu.keys() == h.keys(),
          f"{tag}: summary keys differ between the card and the CPU")
    floats = [k for k in on_card if isinstance(on_card[k], float)]
    for k in on_card:
        if k in floats:
            check(math.isclose(on_card[k], on_cpu[k], rel_tol=1e-6),
                  f"{tag}: summary {k}: card {on_card[k]!r}, CPU "
                  f"{on_cpu[k]!r}")
        else:
            check(on_card[k] == on_cpu[k],
                  f"{tag}: summary counter {k}: card {on_card[k]!r}, CPU "
                  f"{on_cpu[k]!r}")
    steps = final.steps.cpu().numpy()
    print(f"{tag}: B={len(lanes)} of {grid.n} (the lanes phase 4 drained "
          f"first: {lanes.tolist()}) N={cfg.max_jobs} "
          f"capacity={cfg.trace_capacity} run_s={run_s:.6f} "
          f"ms_per_step={run_s * 1e3 / int(steps.max()):.3f} "
          f"steps_max={int(steps.max())} freed_scan_launches={launches} "
          f"by_design={designs} peak_mem_bytes={peak} "
          f"ring_bytes={final.trace.data.numel() * 4} "
          f"untraced_state_equal=True")
    print(f"{tag}/summary: card_s={summary_s:.6f} cpu_s={cpu_s:.6f} "
          f"peak_mem_increment_bytes={summary_peak} counters_equal=True "
          + " ".join(f"{k}={on_card[k]}" for k in
                     ("trace_events", "backfill_hits", "wf_done",
                      "wf_total", "drain_frac", "steps_frac"))
          + " " + " ".join(f"{k}={on_card[k]}" for k in on_card
                           if k.startswith("ev_")))
    print(f"{tag}/trace_meta: {json.dumps(obs_export.trace_meta(final))}")
    s0 = grid.build(ests)
    t0 = time.perf_counter()
    for what, state in (("untraced", full["state"]), ("traced", s0)):
        device_profile(f"profile_{what}", lambda st=state: events_mod.simulate(
            st, n_steps=TRACED_PROFILE_STEPS, chunk_steps=0,
            pred_mode="greedy"), TRACED_PROFILE_STEPS,
            f"full-size {what} steps", ("freed_scan",))
    print(f"{tag}/profiles: steps={TRACED_PROFILE_STEPS} "
          f"seconds={time.perf_counter() - t0:.3f}")
    return launches


# phase 14: the ASA decision service at the setting of
# benchmarks/serve_latency.py. (a) its load generator (build_traffic): the
# clean family at 1/64 size, ASA only, 57 seeds a cell (18 cells: 1026
# tenants), traced so that (f) can merge its rings; (b) its server: a
# 1536-slot table, batches of 256, 3 open-loop replays, a closed-loop
# replay at 64 in flight, then one spans-off/on pair of replays (two
# until the VLM phase came: the smoke's time)
SERVE_LOADGEN = dict(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
                     t0=3600.0)
SERVE_SEEDS = 57
SERVE_MIN_TENANTS = 1000
SERVE_SLOTS, SERVE_BATCH = 1536, 256
SERVE_REPLAYS, SERVE_CLOSED, SERVE_AB_PAIRS = 3, 64, 1
SERVE_PROFILE_STEPS = 8
SERVE_TRACE_SCENARIOS = 8
# (e) the card's decisions against the CPU route's (the engine's
# tolerances, as tests/test_torch_serve_asa.py holds the port against the
# reference): log_p absolute, expected_s relative, entropy absolute; a MAP
# bin may flip only where the CPU posterior's two bins are within
# SERVE_NEAR_TIE
SERVE_LOG_P_ATOL, SERVE_EXPECTED_RTOL, SERVE_ENTROPY_ATOL = 1e-4, 1.5e-5, 1e-5
SERVE_NEAR_TIE = 2e-4


def build_traffic(grid_mod, families, policies, backfill, dev) -> dict:
    """Phase 14(a): ``benchmarks/serve_latency.py::build_traffic`` on the
    port. The load generator's sweep runs through the scan kernel, and
    once more through the plain scan: the states (rings included) must be
    bitwise equal and every launch ``fused``. Returns the request stream
    ``(t_sim, tenant, observed_wait or None)`` in simulated-time order,
    the traced final state, its labels and the scan's launches."""
    from repro_torch.xsim.state import ASA

    cfg = grid_mod.XSimConfig(**SERVE_LOADGEN).with_trace()
    grid = families.family_grid(cfg, "clean", policy_ids=(ASA,),
                                n_seeds=SERVE_SEEDS, shrink=1 / 64.0,
                                seed=0, device=dev)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    torch.cuda.synchronize()
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    final, _ = grid_mod.run_grid(grid, fleet, device=dev)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    designs = dict(backfill.DESIGN_LAUNCHES)
    check(launches > 0 and designs["fused"] == launches,
          f"serve/loadgen: scan launches {launches}, by design {designs}")
    backfill.KERNEL_LAUNCHES["freed_scan"] = 0
    t0 = time.perf_counter()
    plain, _ = grid_mod.run_grid(grid, fleet, freed_mode="ref", device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(backfill.KERNEL_LAUNCHES["freed_scan"] == 0,
          "serve/loadgen: the plain path launched the kernel")
    check(states_equal(final, plain),
          "serve/loadgen: kernel path and plain path differ")
    waits, valid = grid_mod.stage_waits(final, cfg)
    sl = slice(cfg.max_jobs - cfg.max_stages, cfg.max_jobs)
    starts = final.start[:, sl].cpu().numpy()
    events: list[tuple[float, int, float | None]] = []
    for t in range(grid.n):
        # the stream opens with the stage-0 submit-lead query, then every
        # observed stage start feeds the posterior
        events.append((cfg.t0, t, None))
        for y in range(cfg.max_stages):
            if valid[t, y]:
                events.append((float(starts[t, y]), t, float(waits[t, y])))
    events.sort(key=lambda e: (e[0], e[1]))
    n_obs = sum(1 for e in events if e[2] is not None)
    check(grid.n >= SERVE_MIN_TENANTS,
          f"serve/loadgen: {grid.n} tenants, fewer than {SERVE_MIN_TENANTS}")
    print(f"serve/loadgen: tenants={grid.n} N={cfg.max_jobs} "
          f"events={len(events)} observations={n_obs} "
          f"kernel_path_s={kern_s:.3f} plain_path_s={plain_s:.3f} "
          f"bitwise_equal=True freed_scan_launches={launches} "
          f"by_design={designs}")
    return dict(events=events, n_tenants=grid.n, final=final,
                labels=grid.labels, launches=launches)


def _run_stream(server, events, in_flight: int | None = None
                ) -> tuple[float, list[float]]:
    """Submit the stream (open loop, or at most ``in_flight`` unresolved);
    returns (wall seconds, submit-to-resolution latencies). A failed
    request raises here: a batch the card failed is not served."""
    import threading

    lat: list[float] = []
    lock = threading.Lock()
    slots = threading.BoundedSemaphore(in_flight) if in_flight else None

    def stamp(t_sub):
        def cb(fut):
            if fut.exception() is None:
                dt = time.perf_counter() - t_sub
                with lock:
                    lat.append(dt)
            if slots is not None:
                slots.release()
        return cb

    futures = []
    t0 = time.perf_counter()
    for _t, tenant, wait in events:
        if slots is not None:
            check(slots.acquire(timeout=300), "serve: closed loop stalled")
        fut = server.submit(tenant, wait)
        fut.add_done_callback(stamp(time.perf_counter()))
        futures.append(fut)
    for fut in futures:
        fut.result(timeout=300)
    return time.perf_counter() - t0, lat


def _latency(lat: list[float], n: int, wall: float) -> dict:
    a = np.asarray(lat) * 1e3
    return dict(n_requests=n, wall_s=wall, decisions_per_s=n / wall,
                p50_ms=float(np.percentile(a, 50)),
                p99_ms=float(np.percentile(a, 99)),
                max_ms=float(a.max()), mean_ms=float(a.mean()))


def _leg_rates(after: dict, before: dict) -> dict:
    d = {k: float(after[k]) - float(before[k]) for k in (
        "asa_serve_decisions_total", "asa_serve_padded_rows_total",
        "asa_serve_requests_total", "asa_serve_deferrals_total",
        "asa_serve_batches_total")}
    dispatched = d["asa_serve_decisions_total"] + \
        d["asa_serve_padded_rows_total"]
    return dict(pad_fraction=d["asa_serve_padded_rows_total"] / dispatched,
                defer_rate=d["asa_serve_deferrals_total"]
                / d["asa_serve_requests_total"],
                batches=int(d["asa_serve_batches_total"]))


def _print_leg(tag: str, lat: dict, rates: dict) -> None:
    print(f"{tag}: " + " ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in {**lat, **rates}.items()))


def _probe(server, tenants) -> list[tuple[float, float, float]]:
    """Decide-only probes through a running server: pure table reads."""
    futs = [server.submit(t) for t in tenants]
    return [(d.lead_s, d.expected_s, d.entropy)
            for d in (f.result(timeout=300) for f in futs)]


def serve_replays(traffic: dict, ckpt_dir: str, dev):
    """Phase 14(b): the server of ``serve_latency``'s default setting on
    the card: a warm-up replay, 3 open-loop replays, the closed loop at 64
    in flight, 8 profiled steps, and paired spans-off/on replays in
    turns. Returns the server (stopped) and its config."""
    import gc

    from repro_torch.serve.loop import ASAServer, ServeConfig

    events = traffic["events"]
    cfg = ServeConfig(n_slots=SERVE_SLOTS, batch_size=SERVE_BATCH,
                      checkpoint_dir=ckpt_dir)
    server = ASAServer(cfg, device=dev)
    t0 = time.perf_counter()
    warm = server.submit(0)
    server.step_once(wait_s=0)
    warm.result(timeout=300)
    first_s = time.perf_counter() - t0
    server.start()
    try:
        t0 = time.perf_counter()
        _run_stream(server, events)      # admits every tenant
        warmup_s = time.perf_counter() - t0
        reg = server.obs.registry
        s0 = reg.snapshot()
        gc.collect()
        gc.disable()
        try:
            wall, lat = 0.0, []
            for _ in range(SERVE_REPLAYS):
                w, ls = _run_stream(server, events)
                wall += w
                lat += ls
        finally:
            gc.enable()
        s1 = reg.snapshot()
        _print_leg(f"serve/open_loop: replays={SERVE_REPLAYS}",
                   _latency(lat, SERVE_REPLAYS * len(events), wall),
                   _leg_rates(s1, s0))
        gc.collect()
        gc.disable()
        try:
            wall, lat = _run_stream(server, events, SERVE_CLOSED)
        finally:
            gc.enable()
        s2 = reg.snapshot()
        _print_leg(f"serve/closed_loop: in_flight={SERVE_CLOSED}",
                   _latency(lat, len(events), wall), _leg_rates(s2, s1))
        # paired replays, spans off and on, the order flipped each pair
        walls = {False: 0.0, True: 0.0}
        pairs = []
        for rep in range(SERVE_AB_PAIRS):
            w = {}
            for spans in ((False, True) if rep % 2 == 0 else (True, False)):
                server.obs.spans = spans
                gc.collect()
                gc.disable()
                try:
                    w[spans] = _run_stream(server, events)[0]
                finally:
                    gc.enable()
                walls[spans] += w[spans]
            pairs.append(w[True] / w[False] - 1.0)
        server.obs.spans = False
        print(f"serve/obs_ab: pairs={SERVE_AB_PAIRS} "
              f"wall_off_s={walls[False]:.6f} wall_on_s={walls[True]:.6f} "
              f"overhead_frac={walls[True] / walls[False] - 1.0:.6f} "
              f"pair_overheads={[round(x, 4) for x in pairs]} "
              f"span_events={len(server.obs.events)}")
    finally:
        server.stop()
    # where a decision step's time goes: 8 full batches (each 256 distinct
    # tenants, every other row observing), stepped by hand on a server of
    # its own (the profiler's warm-up call admits the tenants)
    obs_waits = [e[2] for e in events if e[2] is not None]
    n = traffic["n_tenants"]
    bench = ASAServer(ServeConfig(n_slots=SERVE_SLOTS,
                                  batch_size=SERVE_BATCH), device=dev)

    def steps():
        for i in range(SERVE_PROFILE_STEPS * SERVE_BATCH):
            bench.submit(i % n, obs_waits[i % len(obs_waits)]
                         if i % 2 == 0 else None)
        done = 0
        while done < SERVE_PROFILE_STEPS:
            done += bench.step_once(wait_s=0) > 0
    device_profile("serve/profile", steps, SERVE_PROFILE_STEPS,
                   "decision steps of 256", ())
    print(f"serve/setting: slots={SERVE_SLOTS} batch={SERVE_BATCH} "
          f"tenants={server.n_tenants} first_step_s={first_s:.6f} "
          f"warmup_replay_s={warmup_s:.6f} "
          f"stats={json.dumps(server.stats, sort_keys=True)}")
    return server, cfg


def serve_restart(server, cfg, tenants, dev) -> list:
    """Phase 14(c): save, restore, probe every tenant on both servers:
    bitwise equal. Returns the uninterrupted server's probes."""
    from repro_torch.runtime import checkpoint
    from repro_torch.serve.loop import ASAServer

    t0 = time.perf_counter()
    path = server.save(step=999)
    save_s = time.perf_counter() - t0
    manifest = json.loads((path / "manifest.json").read_text())
    t0 = time.perf_counter()
    restored = ASAServer.restore(cfg, step=999, device=dev)
    restore_s = time.perf_counter() - t0
    check(checkpoint.verify_step(cfg.checkpoint_dir, 999) == [],
          "serve/restart: the checkpoint does not verify")
    out = {}
    for name, srv in (("uninterrupted", server), ("restored", restored)):
        srv.start()
        try:
            out[name] = _probe(srv, tenants)
        finally:
            srv.stop()
    check(out["restored"] == out["uninterrupted"],
          "serve/restart: the restored server's decisions differ")
    for a, b in zip(server._table, restored._table):
        check(torch.equal(a, b), "serve/restart: the restored table differs")
    nbytes = sum(m["nbytes"] for m in manifest["leaves"])
    print(f"serve/restart: codec={manifest['codec']} "
          f"leaves={len(manifest['leaves'])} payload_bytes={nbytes} "
          f"save_s={save_s:.6f} restore_s={restore_s:.6f} "
          f"probed_tenants={len(tenants)} bitwise_equal=True")
    return out["uninterrupted"]


def serve_crash_recovery(cfg, events, tenants, want, dev) -> None:
    """Phase 14(d): a supervised server under chaos (a step exception, a
    burst, a crash) on the card. Its first incarnation serves a stream of
    other tenants (ids shifted past the table's) and crashes; every
    future resolves with a Decision or a typed error; the restored
    incarnation answers every tenant bitwise as the uninterrupted server
    did (the contract of tests/test_serve_chaos.py::
    test_crash_recovery_is_bitwise_with_uninterrupted_run)."""
    from repro_torch.serve import chaos as schaos
    from repro_torch.serve.loop import Decision, ServeSupervisor

    inj = schaos.ChaosInjector(schaos.ChaosSchedule((
        schaos.step_exception(1), schaos.queue_burst(2, 64),
        schaos.crash(3))), seed=0)
    sup = ServeSupervisor(cfg, chaos=inj, device=dev)
    shift = 1 << 16
    sup.start()
    try:
        futs = [sup.submit(t + shift, w)
                for _s, t, w in events[:4 * SERVE_BATCH]]
        deadline = time.monotonic() + 120
        while sup.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        restarted = time.monotonic()
        check(sup.restarts == 1, "serve/crash: the supervisor did not "
              "restart the crashed server")
        outcomes: dict[str, int] = {}
        for f in futs + list(inj.burst_futures):
            err = f.exception(timeout=300)
            check(err is None or isinstance(err, RuntimeError),
                  f"serve/crash: an untyped failure {err!r}")
            if err is None:
                check(isinstance(f.result(), Decision),
                      "serve/crash: a future resolved to no Decision")
            key = "decision" if err is None else type(err).__name__
            outcomes[key] = outcomes.get(key, 0) + 1
        got = _probe(sup, tenants)
    finally:
        sup.stop()
    check(inj.pending == (), f"serve/crash: events not fired {inj.pending}")
    check(got == want, "serve/crash: the restored decisions differ from "
          "the uninterrupted server's")
    crash_t = next(w for _b, ev, w in inj.fired
                   if ev.kind == "crash_kill_between_batches")
    print(f"serve/crash: fired={inj.counts()} outcomes={outcomes} "
          f"futures={sum(outcomes.values())} all_resolved=True "
          f"restart_observed_s={restarted - crash_t:.6f} "
          f"probed_tenants={len(tenants)} bitwise_equal=True")


def serve_card_vs_cpu(events, dev) -> None:
    """Phase 14(e): the whole stream through ``step_once`` on the card and
    on the CPU route, in this process: identical batches, so the tenant
    ids, dirty masks and keys are equal, log_p within the engine's
    tolerance, the decisions within theirs, and the MAP flips counted."""
    from repro_torch.serve.loop import ASAServer, ServeConfig

    cfg = ServeConfig(n_slots=SERVE_SLOTS, batch_size=SERVE_BATCH)
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        srv = ASAServer(cfg, device=d)
        t0 = time.perf_counter()
        futs = [srv.submit(t, w) for _s, t, w in events]
        while any(not f.done() for f in futs):
            srv.step_once(wait_s=0)
        wall = time.perf_counter() - t0
        out[name] = (srv, [f.result(timeout=60) for f in futs], wall)
    (card, dc, wall_c), (cpu, dp, wall_p) = out["card"], out["cpu"]
    check(card._batches == cpu._batches, "serve/card_vs_cpu: batch counts "
          f"{card._batches} and {cpu._batches}")
    check(np.array_equal(card._tenant_ids, cpu._tenant_ids)
          and card._dirty == cpu._dirty
          and card._admissions == cpu._admissions,
          "serve/card_vs_cpu: tenant maps differ")
    for f in ("key", "rounds", "t", "round_loss"):
        check(torch.equal(getattr(card._table, f).cpu(),
                          getattr(cpu._table, f)),
              f"serve/card_vs_cpu: table {f} differs")
    log_p_err = float((card._table.log_p.cpu() - cpu._table.log_p)
                      .abs().max())
    check(log_p_err <= SERVE_LOG_P_ATOL,
          f"serve/card_vs_cpu: log_p differs by {log_p_err}")
    exp_err = max(abs(a.expected_s - b.expected_s) / abs(b.expected_s)
                  for a, b in zip(dc, dp))
    ent_err = max(abs(a.entropy - b.entropy) for a, b in zip(dc, dp))
    check(exp_err <= SERVE_EXPECTED_RTOL and ent_err <= SERVE_ENTROPY_ATOL,
          f"serve/card_vs_cpu: expected_s {exp_err}, entropy {ent_err}")
    flips = sum(a.lead_s != b.lead_s for a, b in zip(dc, dp))
    # the final tables' MAP bins: a flip only at a near-tie of the CPU's
    lp_c, lp_p = card._table.log_p.cpu(), cpu._table.log_p
    table_flips = torch.nonzero(lp_c.argmax(-1) != lp_p.argmax(-1))[:, 0]
    for s in table_flips.tolist():
        gap = float(lp_p[s].max() - lp_p[s, lp_c[s].argmax()])
        check(gap <= SERVE_NEAR_TIE,
              f"serve/card_vs_cpu: slot {s} flips its MAP at a gap {gap}")
    print(f"serve/card_vs_cpu: requests={len(dc)} batches={card._batches} "
          f"card_s={wall_c:.6f} cpu_s={wall_p:.6f} keys_equal=True "
          f"tenant_ids_equal=True log_p_max_abs_err={log_p_err:.3e} "
          f"expected_max_rel_err={exp_err:.3e} "
          f"entropy_max_abs_err={ent_err:.3e} decision_map_flips={flips} "
          f"table_map_flips={len(table_flips)}")


def serve_exports(traffic: dict, server) -> None:
    """Phase 14(f): the merged Chrome trace (the load generator's rings of
    its first scenarios and the server's spans, no pid collision), one
    scrape of ``/metrics`` and ``/metrics.json`` over localhost."""
    import tempfile
    import urllib.request

    from repro_torch.obs import export as obs_export
    from repro_torch.obs.serve_obs import SERVE_PID, SERVE_REQUEST_PID
    from repro_torch.parallel import fleet

    k = SERVE_TRACE_SCENARIOS
    part = fleet.unpad(traffic["final"], k)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "merged.json")
        meta = obs_export.write_merged_trace(path, part,
                                             traffic["labels"][:k],
                                             serve=server.obs)
        with open(path) as f:
            obj = json.load(f)
        errs = obs_export.validate_chrome(obj) + \
            obs_export.validate_file(path)
        size = Path(path).stat().st_size
    check(errs == [], f"serve/exports: the merged trace is invalid "
          f"{errs[:3]}")
    pids = {e["pid"] for e in obj["traceEvents"]}
    check({p for p in pids if p < SERVE_PID} == set(range(k))
          and {SERVE_PID, SERVE_REQUEST_PID} <= pids,
          f"serve/exports: pids {sorted(pids)[:12]}")
    port = server.serve_metrics_http(port=0)
    try:
        got = {}
        for route in ("/metrics", "/metrics.json"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{route}", timeout=30) as r:
                got[route] = (r.status, r.read())
    finally:
        server.stop_metrics_http()
    text = got["/metrics"][1].decode()
    snap = json.loads(got["/metrics.json"][1])
    check(got["/metrics"][0] == 200 and got["/metrics.json"][0] == 200
          and "# TYPE asa_serve_requests_total counter" in text
          and snap["asa_serve_requests_total"]
          == server.stats["requests"],
          "serve/exports: the scrape endpoint answered wrong")
    print(f"serve/exports: merged_events={meta['events_total']} "
          f"serve_events_kept={meta['serve_events_kept']} "
          f"serve_events_dropped={meta['serve_events_dropped']} "
          f"scenarios={meta['n_scenarios']} bytes={size} valid=True "
          f"scrape_metrics_bytes={len(got['/metrics'][1])} "
          f"scrape_json_series={len(snap)}")


def serve_service(grid_mod, families, policies, backfill, dev
                  ) -> tuple[int, list]:
    """Phase 14, (a)-(f); returns the load generator's scan launches and
    the request stream (phase 16(c) replays it)."""
    import tempfile

    traffic = build_traffic(grid_mod, families, policies, backfill, dev)
    tenants = list(range(traffic["n_tenants"]))
    with tempfile.TemporaryDirectory() as ckpt:
        server, cfg = serve_replays(traffic, ckpt, dev)
        want = serve_restart(server, cfg, tenants, dev)
        serve_crash_recovery(cfg, traffic["events"], tenants, want, dev)
    serve_card_vs_cpu(traffic["events"], dev)
    serve_exports(traffic, server)
    return traffic["launches"], traffic["events"]


# the learned policy (phase 15): (a) rl.train.TrainConfig()'s geometry, one
# rollout through the kernel and the plain scan; (b) the repository's
# acceptance recipe, benchmarks/rl_train.py's SMOKE and its held-out
# seed (copied: the smoke imports nothing of the reference)
RL_SMOKE = dict(iters=3, n_seeds=8, lr=0.5,
                sim=dict(n_warm=16, n_backlog=12, n_arrivals=16,
                         max_stages=9, t0=1800.0))
RL_EVAL_SEED = 1234
# phase 15(a)'s profiled RL steps: cut from 16 to 4 for the smoke's time
# when phase 17 came
RL_PROFILE_STEPS = 4
# lanes of the card-vs-CPU rollout that may part at a near-tie (the MAP
# feature of a posterior at a near-tie, or an action's Gumbel top two)
RL_MAX_PARTED = 0.1


def lane_gap_spy(policy_mod, gaps: dict):
    """Within the block, ``act_sample`` keeps each lane's smallest top-two
    gap of (logits + Gumbel noise) over its draws in ``gaps["min"]`` (a
    host-side spy for the CPU route)."""
    from repro_torch.core import prng

    act_sample = policy_mod.act_sample

    def spy(params, obs, key):
        lg = policy_mod.logits(params, obs)
        top = torch.topk(prng.gumbel(key, (lg.shape[-1],)) + lg, 2).values
        gap = top[..., 0] - top[..., 1]
        old = gaps.get("min")
        gaps["min"] = gap if old is None else torch.minimum(old, gap)
        return act_sample(params, obs, key)
    return patched((policy_mod, "act_sample", spy))


def rl_card_vs_cpu(events_mod, policy_mod, s0, fin_k, params, grid) -> None:
    """Phase 15(a): the card's rollout against the CPU route's on the same
    (card-built) state and weights: lanes equal in every integer field and
    ``rl_act``, or parted, each parted lane printed with its first
    differing stage, the largest feature gap of its observations there
    and its smallest top-two gap on the CPU route."""
    gaps: dict = {}
    cpu_params = type(params)(*(p.cpu() for p in params))
    t0 = time.perf_counter()
    with lane_gap_spy(policy_mod, gaps):
        fin_c = events_mod.sweep(
            state_on_cpu(s0), n_steps=grid.cfg.n_steps,
            chunk_steps=grid.cfg.chunk_steps, pred_mode=grid.cfg.pred_mode,
            naive=True, params=cpu_params, rl_mode="sample", device="cpu")
    cpu_s = time.perf_counter() - t0
    from repro_torch import convert

    a, b = convert.to_numpy(fin_k), convert.to_numpy(fin_c)
    parted = np.zeros(grid.n, bool)
    for k in a:
        if a[k].dtype.kind in "biu":
            parted |= (a[k] != b[k]).reshape(grid.n, -1).any(axis=1)
    obs_err = np.abs(a["rl_obs"] - b["rl_obs"])[~parted]
    gap = gaps["min"].numpy()
    for lane in np.flatnonzero(parted):
        diff = np.flatnonzero(a["rl_act"][lane] != b["rl_act"][lane])
        y = int(diff[0]) if diff.size else -1
        d = (np.abs(a["rl_obs"][lane, y] - b["rl_obs"][lane, y])
             if y >= 0 else np.zeros(1))
        print(f"rl/card_vs_cpu/parted: lane={lane} "
              f"label={grid.labels[lane]} first_act_stage={y} "
              f"obs_max_diff={float(d.max()):.6g} "
              f"at_feature={int(d.argmax())} cpu_min_top2_gap="
              f"{float(gap[lane]):.6g}")
    print(f"rl/card_vs_cpu: lanes={grid.n} parted={int(parted.sum())} "
          f"rl_act_flips={int((a['rl_act'] != b['rl_act']).sum())} "
          f"rl_obs_max_abs_err_equal_lanes="
          f"{float(obs_err.max()) if obs_err.size else 0.0:.6g} "
          f"cpu_rollout_s={cpu_s:.3f} min_top2_gap={float(gap.min()):.6g}")
    check(parted.mean() <= RL_MAX_PARTED,
          f"rl/card_vs_cpu: {int(parted.sum())} of {grid.n} lanes parted")
    check(obs_err.size == 0 or float(obs_err.max()) <= 1e-4,
          "rl/card_vs_cpu: observations differ in lanes that agree")


def rl_full_recipe(backfill, events_mod, plain: Worker, dev
                   ) -> tuple[int, dict]:
    """Phase 15(a): ``rl.train.TrainConfig()``'s geometry (B=144, N=73):
    a warmed fleet, one sampled rollout through the kernel and through
    the plain scan, bitwise with the buffers; the card against the CPU
    route; one REINFORCE step on the card against the CPU;
    ``RL_PROFILE_STEPS`` profiled RL steps; the seconds of a rollout, a
    step and an iteration, and from them the estimated seconds of the
    30-iteration recipe. Returns the
    kernel rollout's scan launches, and the rollout (grid, fleet, params,
    final state, trajectory) that phase 16(b) shards."""
    from repro_torch import convert
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.rl import policy as rl_policy
    from repro_torch.rl import train as rl_train
    from repro_torch.xsim import policies

    cfg = rl_train.TrainConfig()
    t0 = time.perf_counter()
    fleet, params = rl_fleet_and_head(dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = rl_grid(dev)
    grid_s = time.perf_counter() - t0
    check(grid.n == 144 and grid.cfg.max_jobs == 73,
          f"rl: the training grid is {grid.n} x {grid.cfg.max_jobs}")
    s0 = grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=dev), 1))

    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    fin_k, m_k, traj = rl_rollout(grid, params, fleet, dev)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    designs = dict(backfill.DESIGN_LAUNCHES)
    check(launches > 0 and designs["fused"] == launches,
          f"rl/rollout: launches {launches}, by design {designs}")
    fin_r, plain_s, plain_launches, _ = plain.get("rl_rollout")
    check(plain_launches == 0,
          "rl/rollout: the plain path launched the kernel")
    check(numpy_equal(convert.to_numpy(fin_k), fin_r),
          "rl/rollout: kernel path and plain path differ")
    m = {k: v.cpu().numpy() for k, v in m_k.items()}
    steps = fin_k.steps.cpu().numpy()
    check(bool(np.all(m["wf_done"] == m["wf_total"])),
          "rl/rollout: not every workflow finished")
    check(int(steps.max()) < grid.cfg.n_steps,
          "rl/rollout: a scenario used its whole step budget")
    act = traj.act.cpu().numpy()
    valid = fin_k.wf_rows.cpu().numpy() >= 0
    check(bool(np.all(act[valid] >= 0)) and bool(np.all(act[~valid] == -1)),
          "rl/rollout: a stage drew no action, or a padding slot one")
    check(bool(torch.isfinite(traj.obs).all())
          and bool(torch.isfinite(traj.reward).all()),
          "rl/rollout: non-finite observations or rewards")

    t0 = time.perf_counter()
    summary = obs_metrics.to_host(obs_metrics.sweep_summary(
        fin_k, n_steps=grid.cfg.n_steps))
    summary_s = time.perf_counter() - t0
    # the first step pays autograd's and cuBLAS's set-up; the second is
    # a training iteration's
    step_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        new, ent = rl_train.reinforce_step(params, traj.obs, traj.act,
                                           traj.reward, cfg.lr)
        ent_v = float(ent)
        step_s.append(time.perf_counter() - t0)
    first_step_s, step_s = step_s
    cpu_new, cpu_ent = rl_train.reinforce_step(
        type(params)(*(p.cpu() for p in params)),
        *(x.cpu() for x in traj), cfg.lr)
    errs = [float((g.cpu() - c).abs().max() / c.abs().max())
            for g, c in zip(new, cpu_new)]
    ent_err = abs(ent_v - float(cpu_ent)) / abs(float(cpu_ent))
    check(max(errs) <= 1e-5 and ent_err <= 1e-5,
          f"rl/reinforce_step: card against CPU {errs}, entropy {ent_err}")
    check(all(not torch.equal(a, b) for a, b in zip(new[::2], params[::2])),
          "rl/reinforce_step: the weights did not move")
    iter_s = grid_s + rollout_s + summary_s + step_s
    print(f"rl/rollout: B={grid.n} N={grid.cfg.max_jobs} "
          f"n_steps_budget={grid.cfg.n_steps} steps_max={int(steps.max())} "
          f"steps_mean={float(steps.mean()):.3f} warm_fleet_s={warm_s:.3f} "
          f"kernel_rollout_s={rollout_s:.6f} plain_rollout_s={plain_s:.6f} "
          f"bitwise_equal=True freed_scan_launches={launches} "
          f"by_design={designs} reward_mean="
          f"{float(traj.reward.mean()):.6f} misses={int(m['misses'].sum())} "
          f"oh_hours_mean={float(m['oh_hours'].mean()):.6f} "
          f"drain_frac={summary['drain_frac']:.6f}")
    print(f"rl/reinforce_step: step_s={step_s:.6f} "
          f"first_step_s={first_step_s:.6f} entropy={ent_v:.6f} "
          f"card_vs_cpu_rel_err={max(errs):.3g} entropy_rel_err="
          f"{ent_err:.3g} n_params={rl_policy.n_params(params)}")
    print(f"rl/iteration: grid_s={grid_s:.6f} rollout_s={rollout_s:.6f} "
          f"summary_s={summary_s:.6f} step_s={step_s:.6f} "
          f"iteration_s={iter_s:.6f} est_recipe_s="
          f"{warm_s + cfg.iters * iter_s:.3f} (warm_fleet_s + {cfg.iters} "
          f"iterations)")
    rl_card_vs_cpu(events_mod, rl_policy, s0, fin_k, params, grid)
    t0 = time.perf_counter()
    device_profile("profile_rl", lambda: events_mod.simulate(
        s0, n_steps=RL_PROFILE_STEPS, pred_mode=grid.cfg.pred_mode,
        naive=True, params=params, rl_mode="sample"), RL_PROFILE_STEPS,
        "RL steps (B=144, N=73)", ("freed_scan",))
    print(f"profile_rl/window: steps={RL_PROFILE_STEPS} "
          f"seconds={time.perf_counter() - t0:.3f}")
    return launches, dict(grid=grid, fleet=fleet, params=params,
                          final=fin_k, traj=traj, oh_weight=cfg.oh_weight)


def rl_acceptance(backfill, dev) -> int:
    """Phase 15(b): ``benchmarks/rl_train.py``'s ``SMOKE`` recipe on the
    card: ``train``, then ``evaluate`` of the trained head and of the init
    head on one warmed fleet at the held-out seed, held to the
    reference's contract (the trained head's reward above the init
    head's, twt no worse than Per-Stage's and within 15% of ASA's, no OH
    for ASA and Per-Stage). Returns the scan launches of the run."""
    from repro_torch.rl import train as rl_train
    from repro_torch.xsim.grid import XSimConfig

    kw = dict(RL_SMOKE, sim=XSimConfig(**RL_SMOKE["sim"]))
    cfg = rl_train.TrainConfig(**kw)
    reset_scan_counts(backfill)
    t0 = time.perf_counter()
    res = rl_train.train(cfg, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = rl_train.warmed_fleet(cfg, grid_seed=RL_EVAL_SEED, device=dev)
    ev = rl_train.evaluate(res.params, cfg, eval_seed=RL_EVAL_SEED,
                           fleet=fleet, device=dev)
    ev0 = rl_train.evaluate(res.init_params, cfg, eval_seed=RL_EVAL_SEED,
                            fleet=fleet, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    designs = dict(backfill.DESIGN_LAUNCHES)
    check(launches > 0 and designs["fused"] == launches,
          f"rl/train: launches {launches}, by design {designs}")
    for strat, d in sorted(ev.items()):
        print(f"rl_eval/{strat},0,twt_s={d['twt_s']:.0f};"
              f"oh_hours={d['oh_hours']:.3f};reward={d['reward']:.3f};"
              f"n={d['n']}")
    improved = ev["rl"]["reward"] > ev0["rl"]["reward"]
    vs_ps = ev["rl"]["twt_s"] <= ev["per_stage"]["twt_s"]
    vs_asa = ev["rl"]["twt_s"] <= 1.15 * ev["asa"]["twt_s"]
    print(f"rl/train: iters={cfg.iters} rewards={res.rewards} "
          f"entropies={res.entropies} train_s={train_s:.3f} "
          f"eval_s={eval_s:.3f} s_per_iter={train_s / cfg.iters:.3f} "
          f"init_eval={ev0['rl']['reward']:.6f} "
          f"trained_eval={ev['rl']['reward']:.6f} improved={improved} "
          f"beats_per_stage={vs_ps} within_15pct_asa={vs_asa} "
          f"freed_scan_launches={launches}")
    check(set(ev) == {"bigjob", "per_stage", "asa", "asa_naive", "rl"},
          f"rl/train: strategies {sorted(ev)}")
    check(improved, "rl/train: the trained head did not improve on the "
          f"init head's held-out reward ({ev['rl']['reward']:.3f} vs "
          f"{ev0['rl']['reward']:.3f})")
    check(vs_ps and vs_asa, f"rl/train: twt rl={ev['rl']['twt_s']:.0f}s, "
          f"per_stage={ev['per_stage']['twt_s']:.0f}s, "
          f"asa={ev['asa']['twt_s']:.0f}s")
    check(ev["asa"]["oh_hours"] == 0.0 and ev["per_stage"]["oh_hours"] == 0.0,
          "rl/train: ASA or Per-Stage paid OH core-hours")
    check(len(res.telemetry) == cfg.iters
          and all(t["drain_frac"] == 1.0 for t in res.telemetry),
          "rl/train: a training rollout left a lane undrained")
    return launches


# phase 16: the sharded paths and the campaign. (a) phase 10's faulty run
# again over SHARD_BLOCKS blocks on the card (288 scenarios pad to 290);
# (b) phase 15(a)'s rollout over 2 blocks; (c) phase 14's stream through
# a server over SERVE_SHARD_BLOCKS blocks (256 queries split evenly);
# (d) examples/campaign_schedule.py's campaign (copied: the smoke imports
# nothing of the reference), its seeds: estimator 1, sims 41 and 42
SHARD_BLOCKS, ROLLOUT_SHARD_BLOCKS, SERVE_SHARD_BLOCKS = 5, 2, 4
CAMPAIGN_STAGES = (("data-prep", 160, 1800.0, "-"),
                   ("pretrain", 640, 7200.0, "qwen3-moe-235b-a22b"),
                   ("anneal", 320, 3600.0, "qwen3-moe-235b-a22b"),
                   ("sft", 320, 2400.0, "deepseek-7b"),
                   ("eval", 160, 1200.0, "-"))
CAMPAIGN_SEEDS = dict(est=1, warm=41, sim=42)


def sharded_sweeps(faulty: dict, backfill, side: Worker, dev) -> int:
    """Phase 16(a): phase 10's ``faulty`` run (its grid, warmed fleet and
    ``pred_seed``) through ``run_grid(n_shards=1)`` and over a mesh of
    ``SHARD_BLOCKS`` blocks on the card (both in ``side_runs``' worker):
    final states and metrics bitwise phase 10's, ``sharded_sweep_summary``'s
    counters equal to ``sweep_summary``'s; over every card too where the
    host has more than one. Returns the sharded runs' scan launches (all
    ``fused``)."""
    from repro_torch import convert
    from repro_torch.launch.mesh import ScenariosMesh, make_scenarios_mesh
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.xsim import grid as grid_mod

    grid, want = faulty["grid"], faulty["final"]
    want_np = convert.to_numpy(want)
    want_m = {k: v.cpu().numpy() for k, v in faulty["metrics"].items()}
    meshes = {"n_shards=1": dict(n_shards=1),
              f"blocks={SHARD_BLOCKS}": dict(
                  mesh=ScenariosMesh([dev] * SHARD_BLOCKS))}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes[f"cards={n_cards}"] = dict(mesh=make_scenarios_mesh(None))
    else:
        print(f"sharded/multi_card: not run (torch.cuda.device_count() == "
              f"{n_cards}): every block of this phase lies on one card")
    designs = {"fused": 0, "presorted": 0}
    for tag, kw in meshes.items():
        if tag.startswith("cards="):
            reset_scan_counts(backfill)
            t0 = time.perf_counter()
            fin, m = grid_mod.run_grid(grid, faulty["fleet"],
                                       pred_seed=faulty["pred_seed"],
                                       device=dev, **kw)
            torch.cuda.synchronize()
            fin = convert.to_numpy(fin)
            m = {k: v.cpu().numpy() for k, v in m.items()}
            run_s, by = time.perf_counter() - t0, backfill.DESIGN_LAUNCHES
        else:
            fin, run_s, by, m = side.get(f"sharded_{tag}")
        designs = {k: designs[k] + by[k] for k in designs}
        check(numpy_equal(fin, want_np) and numpy_equal(m, want_m),
              f"sharded/{tag}: the sharded sweep differs from phase 10's")
        print(f"sharded/{tag}: B={grid.n} N={grid.cfg.max_jobs} "
              f"run_s={run_s:.6f} bitwise_equal=True")
    launches = sum(designs.values())
    check(launches > 0 and designs["fused"] == launches,
          f"sharded: scan launches {launches}, by design {designs}")
    n_steps = grid.cfg.n_steps
    one = obs_metrics.sweep_summary(want, n_steps=n_steps)
    for tag, kw in meshes.items():
        mesh = kw.get("mesh") or make_scenarios_mesh(1, device=dev)
        got = obs_metrics.sharded_sweep_summary(want, mesh, n_steps=n_steps)
        check(got.keys() == one.keys(), f"sharded/{tag}: summary keys")
        for k, v in one.items():
            if v.dtype.is_floating_point:
                check(bool(torch.allclose(got[k], v, rtol=1e-6, atol=0.0)),
                      f"sharded/{tag}: summary {k} {got[k]} against {v}")
            else:
                check(torch.equal(got[k], v),
                      f"sharded/{tag}: summary counter {k} differs")
    print(f"sharded: freed_scan_launches={launches} by_design={designs} "
          f"summary_counters_equal=True padded_to="
          f"{-(-grid.n // SHARD_BLOCKS) * SHARD_BLOCKS}")
    return launches


def sharded_rollout(rl_run: dict, side: Worker) -> int:
    """Phase 16(b): phase 15(a)'s rollout over ``ROLLOUT_SHARD_BLOCKS``
    blocks on the card (in ``side_runs``' worker): bitwise in every
    field, ``rl_obs``/``rl_act`` included, and the trajectory too.
    Returns its scan launches."""
    from repro_torch import convert

    fin, run_s, designs, traj = side.get("rollout_sharded")
    launches = sum(designs.values())
    check(launches > 0 and designs["fused"] == launches,
          f"sharded_rollout: launches {launches}, by design {designs}")
    check(numpy_equal(fin, convert.to_numpy(rl_run["final"]))
          and all(torch.equal(a, b.cpu())
                  for a, b in zip(traj, rl_run["traj"])),
          "sharded_rollout: the sharded rollout differs from phase 15(a)'s")
    print(f"sharded_rollout: B={rl_run['grid'].n} "
          f"blocks={ROLLOUT_SHARD_BLOCKS} rollout_s={run_s:.6f} "
          f"bitwise_equal=True freed_scan_launches={launches} "
          f"by_design={designs}")
    return launches


def _replay_in_step(server, events) -> tuple[list, float]:
    """The stream through ``step_once`` alone, a batch's worth of submits
    at a time: the batches are a function of the stream, so two servers
    fed it alike form the same batches. Returns the decisions and the
    wall seconds."""
    out, t0 = [], time.perf_counter()
    for lo in range(0, len(events), SERVE_BATCH):
        futs = [server.submit(t, w) for _s, t, w in events[lo:lo
                                                           + SERVE_BATCH]]
        while not all(f.done() for f in futs):
            server.step_once(wait_s=0)
        out += [(d.tenant, d.lead_s, d.expected_s, d.entropy)
                for d in (f.result() for f in futs)]
    return out, time.perf_counter() - t0


def sharded_service(events, dev) -> None:
    """Phase 16(c): phase 14's stream through a server of
    ``ServeConfig(n_shards=1)`` and one over ``SERVE_SHARD_BLOCKS`` blocks
    on the card: decisions, slots and tables (posteriors and keys, every
    replica) bitwise equal; the sharded server restored from its
    checkpoint, its replicas bitwise the live one's."""
    import tempfile

    from repro_torch.launch.mesh import ScenariosMesh
    from repro_torch.serve import asa as serve_asa
    from repro_torch.serve.loop import ASAServer, ServeConfig

    mesh = ScenariosMesh([dev] * SERVE_SHARD_BLOCKS)
    with tempfile.TemporaryDirectory() as ckpt:
        one = ASAServer(ServeConfig(n_slots=SERVE_SLOTS,
                                    batch_size=SERVE_BATCH, n_shards=1),
                        device=dev)
        cfg = ServeConfig(n_slots=SERVE_SLOTS, batch_size=SERVE_BATCH,
                          checkpoint_dir=ckpt)
        sharded = ASAServer(cfg, mesh=mesh, device=dev)
        want, one_s = _replay_in_step(one, events)
        got, sharded_s = _replay_in_step(sharded, events)
        check(got == want, "sharded_service: the decisions differ")
        check(one._slot_of == sharded._slot_of,
              "sharded_service: the tenants' slots differ")
        for rep in (serve_asa.first_replica(one._table),) + sharded._table:
            for a, b in zip(serve_asa.first_replica(one._table), rep):
                check(torch.equal(a, b),
                      "sharded_service: a table replica differs")
        sharded.save(step=1)
        restored = ASAServer.restore(cfg, step=1, mesh=mesh, device=dev)
        for rep in restored._table:
            for a, b in zip(sharded._table[0], rep):
                check(torch.equal(a, b),
                      "sharded_service: the restored table differs")
    print(f"sharded_service: requests={len(events)} "
          f"blocks={SERVE_SHARD_BLOCKS} replicas={len(sharded._table)} "
          f"n_shards_1_s={one_s:.6f} sharded_s={sharded_s:.6f} "
          f"decisions_per_s_n_shards_1={len(events) / one_s:.3f} "
          f"decisions_per_s_sharded={len(events) / sharded_s:.3f} "
          f"bitwise_equal=True restored_bitwise=True")


def campaign_on_card(dev) -> None:
    """Phase 16(d): ``examples/campaign_schedule.py`` on the port, the
    estimator on the card, against the same ASA campaign with the
    estimator on the CPU in this process: outcomes equal field by field;
    the example's table printed."""
    from repro_torch.runtime.campaign import CampaignScheduler, CampaignStage
    from repro_torch.sched.centers import UPPMAX
    from repro_torch.sched.queue_sim import QueueSim
    from repro_torch.sched.strategies import (ASAEstimator, PILOT_STARTUP_S,
                                              PILOT_TASK_LATENCY_S)

    stages = [CampaignStage(*st) for st in CAMPAIGN_STAGES]

    def fresh_sim(seed=CAMPAIGN_SEEDS["sim"]):
        sim = QueueSim(UPPMAX, seed=seed)
        sim.run_until(3600)
        return sim

    exec_s = sum(st.duration_s for st in stages)
    peak = max(st.slices for st in stages)
    rows = {}
    for name, run_s in (("big-job", exec_s),
                        ("pilot", exec_s + PILOT_STARTUP_S
                         + len(stages) * PILOT_TASK_LATENCY_S)):
        sim = fresh_sim()
        job = sim.submit(peak, run_s, user=name)
        sim.run_until_job_ends(job)
        rows[name] = (job.end_time - job.submit_time, peak * run_s / 3600.0)
    sim = fresh_sim()
    t0 = sim.now
    for st in stages:
        j = sim.submit(st.slices, st.duration_s, user="ps")
        sim.run_until_job_ends(j)
    rows["per-stage"] = (j.end_time - t0, sum(
        st.slices * st.duration_s for st in stages) / 3600.0)

    reps, walls = {}, {}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        est = ASAEstimator(seed=CAMPAIGN_SEEDS["est"], device=where)
        CampaignScheduler(fresh_sim(CAMPAIGN_SEEDS["warm"]), est).run(stages)
        reps[tag] = CampaignScheduler(fresh_sim(), est).run(stages)
        walls[tag] = time.perf_counter() - t0
    rep = reps["card"]
    check([dataclasses.asdict(o) for o in rep.outcomes]
          == [dataclasses.asdict(o) for o in reps["cpu"].outcomes],
          "campaign: the card's outcomes differ from the CPU's")
    hidden = (sum(o.real_wait_s for o in rep.outcomes[1:])
              - sum(o.perceived_wait_s for o in rep.outcomes[1:]))
    check(rep.makespan_s > 0 and hidden > 0,
          f"campaign: makespan {rep.makespan_s}, hidden wait {hidden}")
    print(f"campaign: {'strategy':10s} {'makespan_h':>10s} "
          f"{'slice_h':>9s} {'hidden_wait_h':>13s}")
    for name, (mk, sh) in rows.items():
        print(f"campaign: {name:10s} {mk / 3600:10.2f} {sh:9.0f} "
              f"{'-':>13s}")
    print(f"campaign: {'ASA':10s} {rep.makespan_s / 3600:10.2f} "
          f"{rep.slice_hours:9.0f} {hidden / 3600:13.2f}")
    for o in rep.outcomes:
        print(f"campaign/stage: {o.name:10s} "
              f"predicted={o.predicted_wait_s / 3600:6.2f}h "
              f"real={o.real_wait_s / 3600:6.2f}h "
              f"perceived={o.perceived_wait_s / 3600:6.2f}h")
    print(f"campaign: card_s={walls['card']:.6f} cpu_s={walls['cpu']:.6f} "
          f"outcomes_equal=True")


def sharded_and_campaign(faulty: dict, rl_run: dict, events, backfill,
                         side: Worker, dev) -> dict:
    """Phase 16, (a)-(d), each part's seconds printed. Returns the scan's
    launches by path."""
    paths, t0 = {}, time.perf_counter()
    paths["sweep/sharded"] = sharded_sweeps(faulty, backfill, side, dev)
    t1 = time.perf_counter()
    paths["rl/rollout_sharded"] = sharded_rollout(rl_run, side)
    t2 = time.perf_counter()
    sharded_service(events, dev)
    t3 = time.perf_counter()
    campaign_on_card(dev)
    t4 = time.perf_counter()
    print(f"phase16/seconds: a={t1 - t0:.3f} b={t2 - t1:.3f} "
          f"c={t3 - t2:.3f} d={t4 - t3:.3f}")
    return paths


# phase 17: training on the card. (a) repro_torch.launch.train.train at
# qwen2-0.5b's published width (d896, vocab 151936, tied embeddings;
# float32 parameters, m and v, bfloat16 activations), its depth cut to
# TRAIN_RESTART_LAYERS, batch 4, sequence 1024: 3 steps checkpointed at
# step 2, a second process-local run of 5 steps that resumes from it, and
# an uninterrupted 5-step run: every loss of the resumed run equal to the
# uninterrupted run's, bit for bit (the cuts: the resumed run writes no
# checkpoint of its own; the depth, for the checkpoint's zlib save, about
# 48 s of 5.4 GB at 24 layers, 2.1 GB at 4; (b) trains qwen2 at its
# published depth). (b) At trained parameters, one batch's loss under
# no_grad through every kernel (flash attention, the grouped matmul, wkv6, on the tensor
# cores) against the plain route, for each family: TRAIN_CASES (arch,
# depth, batch; None keeps the published depth), each case trained first
# (qwen2: 2 untimed steps, 3 timed ones and a profiled step; the others 2
# steps). The limit is half a bfloat16 step of the loss (2^-9 relative):
# the routes differ only where they round a bfloat16 activation at other
# places (flash attention keeps p in float32 where sdpa rounds the
# weights; the kernels sum in other orders), which moves the float32 mean
# of the log-probabilities by far less than one rounding step of it, as
# tests/test_torch_launch_train.py holds the two packages; a wrong mask,
# head, expert or decay moves it by the loss's own scale. (c) A
# make_train_step(use_flash=True) step on the card raises (the kernel has
# no backward) and writes no parameter.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "qwen2-0.5b", 4, 1024
TRAIN_RESTART_LAYERS = 4
TRAIN_CASES = (("qwen2-0.5b", None, 4), ("moonshot-v1-16b-a3b", 2, 2),
               ("rwkv6-3b", 4, 2))
TRAIN_KERNEL_REL = 2.0 ** -9


def _kernel_counters():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    return {"flash_attention": flash_ops, "grouped_matmul": gmm_ops,
            "wkv6": wkv_ops}


def _reset_kernel_counts() -> None:
    for mod in _kernel_counters().values():
        for cnt in (mod.KERNEL_LAUNCHES, mod.DESIGN_LAUNCHES):
            for k in cnt:
                cnt[k] = 0


def train_restart(dev, arch: str = TRAIN_ARCH,
                  layers: int | None = TRAIN_RESTART_LAYERS,
                  batch: int = TRAIN_BATCH, tag: str = "train/restart"
                  ) -> None:
    """Phase 17(a): ``launch.train.train`` at published
    width, its depth cut to ``layers`` (None: the published depth),
    restarted from its checkpoint, against the uninterrupted run. The
    checkpoints are written with zlib's stored blocks (level 0): the check
    is the bitwise resumption, not the codec's speed (level 3 until the
    VLM phase came)."""
    import shutil
    import tempfile
    from functools import partial

    from repro_torch.configs import ARCHS
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import checkpoint as ckpt

    run = dict(reduced=False, batch=batch, seq=TRAIN_SEQ, log_every=1,
               device=str(dev))
    cfg = ARCHS[arch]
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cut = dict(ARCHS, **{arch: cfg})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        with patched((launch_train, "ARCHS", cut),
                     (ckpt, "save_async", partial(ckpt.save_async,
                                                  level=0))):
            free = shutil.disk_usage(tmp).free
            times = {}
            t0 = time.perf_counter()
            r1 = launch_train.train(arch, steps=3, ckpt_dir=tmp,
                                    ckpt_every=2, **run)
            times["first"] = time.perf_counter() - t0
            check(ckpt.latest_step(tmp) == 2,
                  f"{tag}: no checkpoint of step 2 in {tmp}")
            ckpt_bytes = sum(f.stat().st_size
                             for f in Path(tmp, "step_2").iterdir())
            t0 = time.perf_counter()
            r2 = launch_train.train(arch, steps=5, ckpt_dir=tmp,
                                    ckpt_every=100, **run)
            times["resumed"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r3 = launch_train.train(arch, steps=5, ckpt_dir=None, **run)
            times["uninterrupted"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [v for _, v in r3["losses"]]
    check(all(math.isfinite(v) for v in losses), f"{tag}: losses {losses}")
    ln_v = math.log(cfg.vocab_size)
    check(0.2 * ln_v < losses[0] < 3 * ln_v,
          f"{tag}: first loss {losses[0]} far from ln(vocab) {ln_v:.3f}")
    check(r1["losses"] == r3["losses"][:3],
          f"{tag}: the checkpointed run's losses {r1['losses']} differ "
          f"from the uninterrupted run's {r3['losses'][:3]}")
    check(r2["losses"] == r3["losses"][2:],
          f"{tag}: the resumed run's losses {r2['losses']} differ from "
          f"the uninterrupted run's {r3['losses'][2:]}")
    print(f"{tag}: arch={arch} layers={cfg.n_layers} "
          f"batch={batch} seq={TRAIN_SEQ} "
          f"losses={losses} resumed_equal=True first_s={times['first']:.3f} "
          f"resumed_s={times['resumed']:.3f} "
          f"uninterrupted_s={times['uninterrupted']:.3f} "
          f"checkpoint_bytes={ckpt_bytes} disk_free_bytes={free} "
          f"peak_mem_bytes={peak}")


def kernel_route_loss(arch: str, layers, batch: int, dev) -> dict:
    """Phase 17(b), one case: train, then one batch's loss through every
    kernel of the family against the plain route. Returns the kernel
    route's launches by kernel."""
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    cfg = ARCHS[arch]
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    tag = f"train/{cfg.family}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = OPT.tree_map(lambda p: p.float(),
                          TS.init_params(cfg, seed=0, device=dev))
    opt = OPT.init(params)
    n_params = sum(p.numel() for p in OPT.leaves(params))
    batch_fn = make_batch_fn(cfg, ShapeSpec("smoke", TRAIN_SEQ, batch,
                                            "train"), seed=0, device=dev)
    t0 = time.perf_counter()
    train_batch = batch_fn(0)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    eval_batch = batch_fn(1)
    step = TS.make_train_step(cfg, remat="none")
    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], m = step(state["params"],
                                                state["opt"], train_batch)
        return m

    for _ in range(2):
        m = one_step()
    timed = []
    if arch in TIMED_TRAIN_ARCHS:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = one_step()
            torch.cuda.synchronize()
            timed.append(time.perf_counter() - t0)
    if arch == TRAIN_ARCH:
        device_profile(f"{tag}/profile", one_step, 1,
                       f"{arch} training steps (batch {batch}, seq "
                       f"{TRAIN_SEQ})", ())
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(m["loss"])), f"{tag}: loss {m['loss']}")
    params = state["params"]
    with torch.no_grad():
        _reset_kernel_counts()
        got = float(TS.model_loss(params, eval_batch, cfg, remat="none",
                                  use_flash=True, use_moe_kernel=True,
                                  use_kernel=True))
        launches = {n: sum(mod.KERNEL_LAUNCHES.values())
                    for n, mod in _kernel_counters().items()}
        designs = {n: dict(mod.DESIGN_LAUNCHES)
                   for n, mod in _kernel_counters().items()}
        want = float(TS.model_loss(params, eval_batch, cfg, remat="none"))
        plain_launches = sum(sum(mod.KERNEL_LAUNCHES.values())
                             for mod in _kernel_counters().values())
    rel = abs(got - want) / abs(want)
    L = cfg.n_layers
    from repro_torch.models import zamba2 as Z
    expect = ({"flash_attention": L, "grouped_matmul": 0, "wkv6": 0}
              if cfg.family in ("dense", "vlm") else
              {"flash_attention": cfg.encoder.n_layers + 2 * L,
               "grouped_matmul": 0, "wkv6": 0}
              if cfg.family == "audio" else
              {"flash_attention": Z.n_attn(cfg), "grouped_matmul": 0,
               "wkv6": 0}
              if cfg.family == "hybrid" else
              {"flash_attention": L, "grouped_matmul": 3 * L, "wkv6": 0}
              if cfg.family == "moe" else
              {"flash_attention": 0, "grouped_matmul": 0, "wkv6": L})
    check(launches == expect, f"{tag}: kernel launches {launches}, "
          f"expected {expect}")
    check(plain_launches == sum(expect.values()),
          f"{tag}: the plain route launched a kernel")
    tensor_cores = {"flash_attention": "wgmma", "grouped_matmul": "wgmma",
                    "wkv6": "mma"}
    for name, n in expect.items():
        check(designs[name].get(tensor_cores[name], 0) == n,
              f"{tag}: {name} designs {designs[name]}, expected {n} on "
              f"the tensor cores")
    check(math.isfinite(got) and rel <= TRAIN_KERNEL_REL,
          f"{tag}: kernel-route loss {got!r} against the plain route's "
          f"{want!r}: relative difference {rel:.3e} > {TRAIN_KERNEL_REL}")
    steps = int(state["opt"].step)
    line = (f"{tag}: arch={arch} layers={L} d_model={cfg.d_model} "
            f"params={n_params} batch={batch} seq={TRAIN_SEQ} "
            f"trained_steps={steps} train_loss={float(m['loss']):.6f} "
            f"kernel_loss={got!r} plain_loss={want!r} rel_diff={rel:.3e} "
            f"launches={launches} data_s={data_s:.3f} peak_mem_bytes={peak}")
    if timed:
        per_step = sum(timed) / len(timed)
        line += (f" step_s={[round(t, 6) for t in timed]} "
                 f"s_per_step={per_step:.6f} "
                 f"tokens_per_s={batch * TRAIN_SEQ / per_step:.1f}")
    print(line)
    if arch in TIMED_TRAIN_ARCHS:
        refuse_kernel_training(cfg, state, train_batch)
    return launches


def refuse_kernel_training(cfg, state: dict, batch: dict) -> None:
    """Phase 17(c): a step through the kernels raises and writes nothing."""
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS

    leaves = OPT.leaves(state["params"]) + OPT.leaves(state["opt"].m)
    versions = [x._version for x in leaves]
    step0 = int(state["opt"].step)
    try:
        TS.make_train_step(cfg, use_flash=True, remat="none")(
            state["params"], state["opt"], batch)
    except RuntimeError as e:
        check("no backward" in str(e), f"train/refuse: raised {e!r}")
    else:
        fail("train/refuse: a training step through the flash kernel did "
             "not raise")
    check([x._version for x in leaves] == versions
          and int(state["opt"].step) == step0,
          "train/refuse: the refused step wrote a parameter or a moment")
    print(f"train/refuse: make_train_step(use_flash=True) on the card "
          f"({cfg.name}) raised RuntimeError (no backward); no parameter or "
          f"moment written")


def training_on_card(dev) -> dict:
    """Phase 17, (a)-(c), each part's seconds printed. Returns the kernel
    route's launches by kernel and path."""
    t0 = time.perf_counter()
    train_restart(dev)
    t1 = time.perf_counter()
    from repro_torch.configs import ARCHS

    paths = {}
    for arch, layers, batch in TRAIN_CASES:
        launches = kernel_route_loss(arch, layers, batch, dev)
        fam = ARCHS[arch].family
        for name, n in launches.items():
            if n:
                paths.setdefault(name, {})[f"train/{fam}_kernel_loss"] = n
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    print(f"phase17/seconds: a={t1 - t0:.3f} b_c={t2 - t1:.3f}")
    return paths


# phase 18: the hybrid family (zamba2-1.2b). (a) Serving at the published
# size in bfloat16 is SERVE["hybrid"], through serve_phase. (b) The kernel
# route against its twin (flash swapped for its plain version): the
# bfloat16 end-to-end logits reported (38 layers of random weights
# amplify rounding, as RWKV-6's 32 do in phase 8); each of the 6
# shared-attention calls of prefill held on the kernel route's own q, k, v
# against the plain version (FLASH_ATOL, FLASH_REL: the kernel's own
# limits), and each shared block's output on its own input against the
# twin's block (LAYER_TOL["twin"], phase 6's kind); and in float32 at
# published width, depth cut to HYBRID_F32_LAYERS (the bfloat16 model's
# weights unrounded; flash on the CUDA cores) the logits and the share of
# equal greedy tokens, as phase 8 holds RWKV-6 (HYBRID_F32_TOL, the same
# limits as SSM_F32_TOL). 12 layers keep the published period of 6 and
# two shared-block invocations, as (c) does; cut from the published 38
# (7.2 GB, 4.7 s) for the smoke's time when phase 21 came to count the
# split training step's launches.
HYBRID_F32_TOL = (5e-4, 1e-4, 0.85)
HYBRID_F32_GEN = 8
HYBRID_F32_LAYERS = 12
# (c) The block prefill against the reference's token-by-token serving
# route (repro/launch/serve.py's hybrid branch: decode_step over the
# prompt), in float32 at published width: arch, batch, prompt, new
# tokens, depth. 12 layers keep the published period of 6 and give two
# shared-block invocations, each with its own KV ring (4 layers at that
# period would have none); 244 = 128 + 116, so a 128-token block and a
# 116-token tail taken one token at a time (500 = 3 × 128 + 116 until the
# model split came: the token-by-token route's 500 steps, the smoke's
# time). Held: logits (largest |Δ|,
# rms(Δ)/rms), each part of the state after the prompt (its largest |Δ|
# over its largest |value|), every greedy token equal. Measured on an
# H100: logits 7.0e-5 and 1.5e-5, states 1.4e-5 (conv) to 6.7e-5 (the
# keys): the two routes sum in float32 in other orders (chunked SSD and
# a 2048-wide block against 500 one-step recurrences), which 12 layers
# at d2048 amplify past the 8.1e-6 the CPU test reads at d64. The limits
# are about ten times the readings at 500, the float32 limits of (b).
HYBRID_E2E = ("zamba2-1.2b", 4, 244, 8, 12)
HYBRID_E2E_TOL = dict(logits=(5e-4, 1e-4), state=5e-4)
# (d) Training: arch, depth (None: the published 38), batch; through
# kernel_route_loss as phase 17(b), seconds a step timed, a step through
# the kernel refused.
HYBRID_TRAIN = ("zamba2-1.2b", None, 2)
# (e) The threefry counter past flat index 2**32: a (40, 250) block of
# bits from 2**32 - 5000 on, and 8 rows of categorical(shape=) over
# zamba2's vocabulary from the row that holds index 2**32.
COUNTER_BITS = ((40, 250), 2 ** 32 - 5000)
COUNTER_ROWS = (32_000, 8)


def hybrid_attention_check(tag: str, params, prompts, cfg) -> None:
    """Phase 18(b), bfloat16: the kernel route's prefill, each
    shared-attention call's output against the plain version on the same
    q, k, v, and each shared block's output against the twin route's block
    on the same input."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import zamba2 as Z

    flash, block = flash_ops.flash_attention, Z._shared_block
    attn_calls, block_calls = [], []

    def flash_spy(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        attn_calls.append((q, k, v, kw, out))
        return out

    def block_spy(params_, x, cfg_, **kw):
        out = block(params_, x, cfg_, **kw)
        block_calls.append((x, kw, out[0]))
        return out

    with patched((flash_ops, "flash_attention", flash_spy),
                 (Z, "_shared_block", block_spy)):
        Z.prefill(params, prompts, cfg, use_kernels=True)
    n = Z.n_attn(cfg)
    check(len(attn_calls) == len(block_calls) == n,
          f"{tag}: {len(attn_calls)} flash calls and {len(block_calls)} "
          f"shared blocks in prefill, want {n} of each")
    worst = [0.0, 0.0, 0.0]
    for q, k, v, kw, out in attn_calls:
        want = flash_ref.attention_ref(q, k, v, **kw)
        errs = flash_check(f"{tag} shared attention {tuple(q.shape)}", out,
                           want, q.dtype)
        worst = [max(a, b) for a, b in zip(worst, errs)]
    del attn_calls
    tol_max, tol_rel = LAYER_TOL["twin"]
    worst_max = worst_rel = 0.0
    with plain_kernels():
        for x, kw, out in block_calls:
            other = block(params, x, cfg, **kw)[0]
            d = (out.float() - other.float())
            worst_max = max(worst_max, float(d.abs().max()
                                             / other.float().abs().max()))
            worst_rel = max(worst_rel, float(
                d.pow(2).mean().sqrt() / other.float().pow(2).mean().sqrt()))
    print(f"{tag}/shared_attention: {n} flash calls on the kernel route's "
          f"own q, k, v against the plain version: worst max_abs_err="
          f"{worst[0]:.6g} worst_row_rel={worst[1]:.6g} rel_rms="
          f"{worst[2]:.6g} (limits {FLASH_ATOL[torch.bfloat16]}, "
          f"{FLASH_REL[torch.bfloat16]}); {n} shared blocks against the "
          f"twin's on the same input: worst max_abs_diff/max_abs="
          f"{worst_max:.6g} worst rel_rms={worst_rel:.6g} (tolerance "
          f"{tol_max}, {tol_rel})")
    check(worst_max <= tol_max and worst_rel <= tol_rel,
          f"{tag}: a shared block of the kernel route differs from the "
          f"twin's beyond tolerance")


def hybrid_float32_run(dev) -> None:
    """Phase 18(b), float32 at full width, HYBRID_F32_LAYERS deep: the
    kernel route (flash on the CUDA cores) against the twin route."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import zamba2 as Z

    arch, batch, prompt_len, _ = SERVE["hybrid"]
    cfg = dataclasses.replace(get_arch(arch), dtype="float32",
                              n_layers=HYBRID_F32_LAYERS)
    params = Z.init_lm(cfg, seed=0, device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    before = dict(flash_ops.DESIGN_LAUNCHES)
    kern = launch_serve.generate(params, prompts, cfg, HYBRID_F32_GEN,
                                 use_kernels=True)
    designs = {d: flash_ops.DESIGN_LAUNCHES[d] - before[d] for d in before}
    check(designs == {"wgmma": 0, "simt": Z.n_attn(cfg)},
          f"zamba2 float32 ran flash designs {designs}, want all "
          f"{Z.n_attn(cfg)} through simt")
    with plain_kernels():
        twin = launch_serve.generate(params, prompts, cfg, HYBRID_F32_GEN,
                                     use_kernels=True)
    c = _compare(kern, twin, cfg.vocab_size)
    tol_max, tol_rel, tol_agree = HYBRID_F32_TOL
    tag = f"serve/hybrid/e2e_float32_L{cfg.n_layers}"
    print_compare(f"{tag}/kernel_vs_twin", c, batch,
                  f"(tolerance: max {tol_max}, rel_rms {tol_rel}, "
                  f"agreement >= {tol_agree})")
    print(f"{tag}: prefill_ms kernel={kern['prefill_s'] * 1e3:.3f} twin="
          f"{twin['prefill_s'] * 1e3:.3f}; flash_designs={designs}")
    del params, prompts, kern, twin
    torch.cuda.empty_cache()
    check(c["token_agreement"] >= tol_agree and all(
        c[f"{n}_max"] <= tol_max and c[f"{n}_rel"] <= tol_rel
        for n in ("prefill", "decode")),
        f"{tag}: the kernel route differs from the twin route beyond "
        f"tolerance")


def hybrid_stepwise_generate(params, prompts, cfg, gen: int) -> dict:
    """The reference's serving route for Zamba2 (``repro/launch/serve.py``,
    its ``hybrid`` branch): ``decode_step`` over the prompt one token at a
    time from ``init_decode_state`` (rings of S + gen slots; no kernel),
    then greedy decode. Returns ``generate``'s keys but the times, and
    ``state``, a copy of the state after the prompt."""
    from repro_torch.models import zamba2 as Z
    from repro_torch.serve.step import greedy_sample

    b, s = prompts.shape
    state = Z.init_decode_state(cfg, b, s + gen, device=prompts.device)
    for t in range(s):
        logits, state = Z.decode_step(params, prompts[:, t:t + 1], state, t,
                                      cfg)
    out = dict(prefill_logits=logits, decode_logits=None,
               state={k: v.clone() for k, v in state.items()})
    token, generated = greedy_sample(logits), []
    for i in range(gen):
        generated.append(token)
        logits, state = Z.decode_step(params, token, state, s + i, cfg)
        if i == 0:
            out["decode_logits"] = logits
        token = greedy_sample(logits)
    out["tokens"] = torch.cat(generated, dim=1)
    return out


def hybrid_end_to_end(dev) -> None:
    """Phase 18(c): the block prefill and decode (``launch.serve.generate``
    through the kernel) against the token-by-token route, float32, depth
    cut (``HYBRID_E2E``), a ragged prompt."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import zamba2 as Z

    arch, batch, prompt_len, gen, n_layers = HYBRID_E2E
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              dtype="float32")
    chunk = cfg.ssm.chunk
    params = Z.init_lm(cfg, seed=0, device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    before = flash_ops.KERNEL_LAUNCHES["flash_attention"]
    t0 = time.perf_counter()
    res = launch_serve.generate(params, prompts, cfg, gen, use_kernels=True)
    launches = flash_ops.KERNEL_LAUNCHES["flash_attention"] - before
    _, state = Z.prefill(params, prompts, cfg, max_seq=prompt_len + gen,
                         use_kernels=True)
    t1 = time.perf_counter()
    ref = hybrid_stepwise_generate(params, prompts, cfg, gen)
    t2 = time.perf_counter()
    c = _compare(res, ref, cfg.vocab_size)
    parts = {}
    for k in ("conv", "ssm", "attn_k", "attn_v"):
        want = ref["state"][k].float()
        parts[k] = float((state[k].float() - want).abs().max()
                         / want.abs().max())
    tol = HYBRID_E2E_TOL
    tag = f"serve/hybrid/e2e_float32_L{n_layers}"
    print_compare(f"{tag}/kernel_vs_stepwise", c, batch,
                  f"(tolerance: max {tol['logits'][0]}, rel_rms "
                  f"{tol['logits'][1]}, tokens equal)")
    print(f"{tag}: prompt {prompt_len} = {prompt_len // chunk} x {chunk} + "
          f"{prompt_len % chunk} (block, then one token at a time); "
          f"shared invocations={Z.n_attn(cfg)} flash launches={launches}; "
          f"state after the prompt, max_abs_diff/max_abs: "
          + " ".join(f"{k}={v:.6g}" for k, v in parts.items())
          + f" (limit {tol['state']}); kernel_route_s={t1 - t0:.3f} "
          f"stepwise_s={t2 - t1:.3f}")
    ok = (launches == Z.n_attn(cfg) == 2 and c["token_agreement"] == 1.0
          and all(v <= tol["state"] for v in parts.values())
          and all(c[f"{n}_max"] <= tol["logits"][0]
                  and c[f"{n}_rel"] <= tol["logits"][1]
                  for n in ("prefill", "decode")))
    del params, prompts, res, state, ref
    torch.cuda.empty_cache()
    check(ok, f"{tag}: the block prefill differs from the token-by-token "
          f"route beyond tolerance")


def counter_past_2_32(dev) -> None:
    """Phase 18(e): threefry draws straddling flat index 2**32 on the card
    against the CPU route, bitwise."""
    from repro_torch.core import prng

    key = prng.PRNGKey(26)
    shape, offset = COUNTER_BITS
    got = prng.bits(key.to(dev), shape, offset=offset)
    want = prng.bits(key, shape, offset=offset)
    vocab, rows = COUNTER_ROWS
    r0 = 2 ** 32 // vocab
    logits = torch.randn(vocab, generator=torch.Generator().manual_seed(26))
    got_rows = prng.categorical_rows(key.to(dev), logits.to(dev), r0,
                                     r0 + rows)
    want_rows = prng.categorical_rows(key, logits, r0, r0 + rows)
    n = math.prod(shape)
    print(f"prng/past_2_32: bits {shape} at flat indices {offset} .. "
          f"{offset + n - 1} bitwise_equal_cpu="
          f"{torch.equal(got.cpu(), want)}; categorical rows {r0} .. "
          f"{r0 + rows - 1} over V={vocab} (flat indices {r0 * vocab} .. "
          f"{(r0 + rows) * vocab - 1}) equal_cpu="
          f"{torch.equal(got_rows.cpu(), want_rows)} rows={got_rows.tolist()}")
    check(offset < 2 ** 32 < offset + n and r0 * vocab < 2 ** 32
          < (r0 + rows) * vocab, "prng/past_2_32: a block misses 2**32")
    check(torch.equal(got.cpu(), want)
          and torch.equal(got_rows.cpu(), want_rows),
          "prng/past_2_32: the card's draws differ from the CPU route's")


def hybrid_on_card(dev) -> dict:
    """Phase 18, (a)-(e), each part's seconds printed. Returns the flash
    launches by path: serve/hybrid (the main path of (a)) and
    train/hybrid_kernel_loss (d)."""
    t0 = time.perf_counter()
    served = serve_phase("hybrid", dev)
    t1 = time.perf_counter()
    hybrid_float32_run(dev)
    t2 = time.perf_counter()
    hybrid_end_to_end(dev)
    t3 = time.perf_counter()
    arch, layers, batch = HYBRID_TRAIN
    launches = kernel_route_loss(arch, layers, batch, dev)
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    counter_past_2_32(dev)
    t5 = time.perf_counter()
    print(f"phase18/seconds: a_b_bf16={t1 - t0:.3f} b_f32={t2 - t1:.3f} "
          f"c={t3 - t2:.3f} d={t4 - t3:.3f} e={t5 - t4:.3f}")
    return dict(served=served, train=launches)


# phase 19: the audio family (whisper-tiny: 4 encoder and 4 decoder
# layers, d384, 6 heads of 64, vocab 51865 padded to 51968, 1500 frames,
# about 49.7 M parameters). (a) Serving at the published size in bfloat16
# is SERVE["audio"] through serve_phase: every attention of prefill goes
# through the flash kernel (4 in the encoder without a mask, 4 causal
# self-attentions over the prompt, 4 cross attentions of the prompt over
# the 1500 frames: 12 launches, all wgmma). (b) The kernel route against
# its twin: the bfloat16 logits reported, each of the 12 flash calls held
# on the kernel route's own q, k, v (FLASH_ATOL, FLASH_REL); and in
# float32 at full depth (flash on the CUDA cores) the logits within
# AUDIO_F32_TOL (largest |Δ|, rms(Δ)/rms: the limits of phase 18(b), a
# few float32 roundings amplified over 8 layers) and every greedy token
# equal. (c) Training at published size: float32 parameters, batch 4,
# sequence 1024, remat none, through kernel_route_loss as phase 17(b)
# (seconds a step, data seconds a batch, the loss through the kernel
# against the plain route within TRAIN_KERNEL_REL, a step through it
# refused); its launch.train restart (from a step-2 checkpoint, bitwise
# the uninterrupted 5-step run, as phase 17(a)) went when the model split
# came, for the smoke's time. (d) The batches'
# frames (prng.normal at the training batch's shape) on the card against
# the CPU route, bitwise, in bfloat16 and float32. Row 2d of PERF.md: the
# flash kernel at the three prefill shapes (FLASH_WHISPER_SHAPES: part,
# B, Sq, Sk, H, hd, causal), each timed beside the plain version and
# F.scaled_dot_product_attention on the same q, k, v.
AUDIO_F32_TOL = (5e-4, 1e-4)
AUDIO_TRAIN = ("whisper-tiny", None, 4)
FLASH_WHISPER_SHAPES = (("encoder", 16, 1500, 1500, 6, 64, False),
                        ("decoder_self", 16, 64, 64, 6, 64, True),
                        ("cross", 16, 64, 1500, 6, 64, False))


def flash_whisper_rows(dev) -> dict:
    """Row 2d: the flash kernel at whisper-tiny's three prefill shapes in
    bfloat16 (the tensor-core design) against ``attention_ref`` (FLASH_ATOL,
    FLASH_REL), timed beside the plain version and
    ``F.scaled_dot_product_attention`` on the same q, k, v, with its
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(19)
    rows = {}
    for part, b, sq, sk, h, hd, causal in FLASH_WHISPER_SHAPES:
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, sk, h, hd), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        design = ops.flash_design(q.dtype, hd)
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        key = f"{b}x{sq}x{sk}x{h}x{hd}" + ("c" if causal else "")
        err, row, rms = flash_check(f"whisper {part} {key} {design}", got,
                                    want, q.dtype)
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                     reps=20)
        plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal),
                           reps=10)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=20)
        bound, by = flash_bound_ms(b, sq, h, hd, 0, q.dtype, sk=sk,
                                   causal=causal)
        rows[key] = dict(part=part, design=design, causal=causal,
                         max_abs_err=err, rel_row_err=row, rel_rms=rms,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=by)
        print(f"kernel/flash_attention whisper {part} {key}: design="
              f"{design} max_abs_err={err:.6g} worst_row_rel={row:.6g} "
              f"rel_rms={rms:.6g} ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms={lib_ms:.6f} bound_ms={bound:.6f} ({by})")
        del q, k, v, qt, kt, vt, got, want
    return rows


def attention_check(tag: str, params, prompts, cfg, *extra) -> None:
    """Phases 19(b) and 20(c), bfloat16: the kernel route's prefill (the
    encoder–decoder's with its frames, the VLM's with its patches), each
    flash call's output against the plain version on the same q, k, v."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.serve.step import make_prefill_step

    flash, calls = flash_ops.flash_attention, []

    def flash_spy(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    with patched((flash_ops, "flash_attention", flash_spy)):
        make_prefill_step(cfg, use_kernels=True)(params, prompts, *extra)
    n = (cfg.encoder.n_layers + 2 * cfg.n_layers if cfg.family == "audio"
         else cfg.n_layers)
    check(len(calls) == n, f"{tag}: {len(calls)} flash calls in prefill, "
          f"want {n}")
    worst, kinds, big, lim = [0.0, 0.0, 0.0], {}, 0.0, 0.0
    base = FLASH_ATOL[torch.bfloat16]
    for q, k, v, kw, out in calls:
        want = flash_ref.attention_ref(q, k, v, **kw)
        kind = f"{q.shape[1]}x{k.shape[1]}" + ("c" if kw["causal"] else "")
        # the kernel tests' absolute tolerance is for outputs of unit
        # scale; a model's own attention outputs reach several units
        # (pixtral's 4-8, where one bfloat16 step is 2^-5), so the limit
        # is the larger of it and two steps of the largest output
        top = float(want.float().abs().max())
        atol = max(FLASH_ATOL[q.dtype], 2 * torch.finfo(q.dtype).eps * top)
        errs = flash_check(f"{tag} attention {kind}", out, want, q.dtype,
                           atol=atol)
        worst = [max(a, b) for a, b in zip(worst, errs)]
        big, lim = max(big, top), max(lim, atol)
        kinds[kind] = kinds.get(kind, 0) + 1
    del calls
    print(f"{tag}/attention: {n} flash calls (Sq x Sk: {kinds}) on the "
          f"kernel route's own q, k, v against the plain version: worst "
          f"max_abs_err={worst[0]:.6g} worst_row_rel={worst[1]:.6g} "
          f"rel_rms={worst[2]:.6g} (limits: absolute max({base}, 2 "
          f"bfloat16 steps of the largest output), "
          f"at most {lim:.6g} here, the largest output {big:.6g}; "
          f"relative {FLASH_REL[torch.bfloat16]})")


def audio_float32_full_depth(dev) -> None:
    """Phase 19(b), float32 at full width and depth: the kernel route
    (flash on the CUDA cores) against the twin route, frames and prompts
    from a seed."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import encdec

    arch, batch, prompt_len, gen = SERVE["audio"]
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    params = encdec.init_lm(cfg, seed=0, device=dev)
    draws = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            device=dev, generator=draws)
    frames = torch.randn((batch, cfg.encoder.n_frames, cfg.d_model),
                         device=dev, generator=draws)
    before = dict(flash_ops.DESIGN_LAUNCHES)
    kern = launch_serve.generate(params, prompts, cfg, gen, use_kernels=True,
                                 frames=frames)
    designs = {d: flash_ops.DESIGN_LAUNCHES[d] - before[d] for d in before}
    n = cfg.encoder.n_layers + 2 * cfg.n_layers
    check(designs == {"wgmma": 0, "simt": n},
          f"whisper float32 ran flash designs {designs}, want all {n} "
          f"through simt")
    with plain_kernels():
        twin = launch_serve.generate(params, prompts, cfg, gen,
                                     use_kernels=True, frames=frames)
    c = _compare(kern, twin, cfg.vocab_size)
    tol_max, tol_rel = AUDIO_F32_TOL
    tag = f"serve/audio/e2e_float32_L{cfg.encoder.n_layers}+{cfg.n_layers}"
    print_compare(f"{tag}/kernel_vs_twin", c, batch,
                  f"(tolerance: max {tol_max}, rel_rms {tol_rel}, tokens "
                  f"equal)")
    print(f"{tag}: prefill_ms kernel={kern['prefill_s'] * 1e3:.3f} twin="
          f"{twin['prefill_s'] * 1e3:.3f}; flash_designs={designs}")
    del params, prompts, frames, kern, twin
    torch.cuda.empty_cache()
    check(c["token_agreement"] == 1.0 and all(
        c[f"{p}_max"] <= tol_max and c[f"{p}_rel"] <= tol_rel
        for p in ("prefill", "decode")),
        f"{tag}: the kernel route differs from the twin route beyond "
        f"tolerance")


def audio_frames_card_vs_cpu(dev, cpu: Worker) -> None:
    """Phase 19(d): the training batch's frames on the card (through
    ``make_batch_fn``) against the same ``prng.normal`` draw on the CPU
    (``_frames_cpu``, in the CPU references' worker), bitwise, in
    bfloat16 and float32."""
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.models.lm import act_dtype
    from repro_torch.train.data import make_batch_fn

    arch, _, batch = AUDIO_TRAIN
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(ARCHS[arch], dtype=dtype)
        t0 = time.perf_counter()
        got = make_batch_fn(cfg, ShapeSpec("smoke", TRAIN_SEQ, batch,
                                           "train"), seed=0,
                            device=dev)(1)["frames"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want, cpu_s = cpu.get(f"frames_{dtype}")
        equal = torch.equal(got.cpu(), want)
        print(f"prng/audio_frames_{dtype}: {tuple(got.shape)} "
              f"bitwise_equal_cpu={equal} batch_on_card_s={t1 - t0:.3f} "
              f"frames_on_cpu_s={cpu_s:.3f} mean={float(want.mean()):.6f} "
              f"std={float(want.float().std()):.6f}")
        check(got.dtype == want.dtype == act_dtype(cfg) and equal,
              f"prng/audio_frames_{dtype}: the card's frames differ from "
              f"the CPU route's")


def audio_on_card(dev, cpu: Worker | None = None) -> dict:
    """Phase 19, row 2d and (a)-(d), each part's seconds printed. Returns
    the flash launches by path (serve/audio, the main path of (a), and
    train/audio_kernel_loss of (c)) and row 2d."""
    t0 = time.perf_counter()
    rows = flash_whisper_rows(dev)
    t1 = time.perf_counter()
    served = serve_phase("audio", dev)
    t2 = time.perf_counter()
    audio_float32_full_depth(dev)
    t3 = time.perf_counter()
    arch, layers, batch = AUDIO_TRAIN
    launches = kernel_route_loss(arch, layers, batch, dev)
    torch.cuda.empty_cache()
    print("train/audio_restart/cut: no launch.train restart (it went when "
          "phase 21 took the model split: the smoke's time; phase 17(a) "
          "restarts launch.train on the card)")
    t4 = time.perf_counter()
    audio_frames_card_vs_cpu(dev, cpu or Worker(cpu_references))
    t5 = time.perf_counter()
    print(f"phase19/seconds: row_2d={t1 - t0:.3f} a_b_bf16={t2 - t1:.3f} "
          f"b_f32={t3 - t2:.3f} c={t4 - t3:.3f} d={t5 - t4:.3f}")
    return dict(served=served, train=launches, flash_rows=rows)


# phase 20: the VLM prefix (pixtral-12b: 40 layers, d5120, 32 heads of 128
# over 8 KV heads, d_ff 14336, vocab 131072 untied; 12.25 G parameters,
# 24.5 GB of bf16; its "ViT" a stub: 1024 precomputed patch embeddings a
# request in the config, 8 in the reference's serving route). (a) Serving
# at the published size in bfloat16 is SERVE["vlm"] through serve_phase:
# every layer's attention of prefill goes through the flash kernel over
# the 8 + 1024 rows (40 launches, all wgmma); decode from the empty cache
# of the reference's route. (b) The prefill step at the config's 1024
# patches and a 1024-token prompt, batch 4 (VLM_PREFILL): flash at row
# 2e's shape (4, 2048, 32, 128) causal, its 40 launches by design; row 2e
# itself: the kernel at that shape against attention_ref (FLASH_ATOL,
# FLASH_REL), timed beside the plain version and SDPA, with its bound.
# (c) The kernel route against its twin in bfloat16 is serve_phase's
# (each of the 40 flash calls on its own q, k, v); in float32 at
# published width cut to VLM_F32[4] layers (9.7 GB of parameters; flash
# on the CUDA cores) the logits within VLM_F32_TOL (phase 19(b)'s
# limits) and every greedy token equal. (d) Training at published width
# cut to 4 layers (2.43 G parameters: 39 GB of float32 parameters,
# gradients, m and v), batch 2, 1024 patches and 1024 tokens, through
# kernel_route_loss as phase 17(b). Its launch.train restart went when
# the model split came (the smoke's time: the untied embedding and head
# alone make a 16 GB checkpoint of parameters, m and v at any depth, about
# 68 s to save and restore): launch.train's restart is held on the card
# by phase 17(a), the VLM route's by
# tests/test_torch_vlm.py. (e) The batches' patch embeddings on the card
# against the CPU route, bitwise, in bfloat16 and float32. (f)
# core.xla_f32 over
# XLA_F32_N inputs on the card against the CPU, bitwise. (g) The dry
# run's plan of qwen2-0.5b's train_4k on a (1, 1) mesh at a batch of
# DRYRUN_BATCH: its argument bytes against the bytes the card's allocator
# was asked for once launch.train's float32 parameters, AdamW state and
# one batch are placed (equal), and against the allocator's own blocks
# (above by no more than its rounding: 512 bytes a tensor, and less than
# 1 MiB left unsplit in a large block).
VLM_PREFILL = ("pixtral-12b", 4, 1024, 1024)     # batch, patches, prompt
VLM_F32 = ("pixtral-12b", 4, 1024, 8, 4)         # batch, prompt, gen, depth
VLM_F32_TOL = AUDIO_F32_TOL
VLM_TRAIN = ("pixtral-12b", 4, 2)
TIMED_TRAIN_ARCHS = (TRAIN_ARCH, HYBRID_TRAIN[0], AUDIO_TRAIN[0],
                     VLM_TRAIN[0])
XLA_F32_N = 10 ** 7
DRYRUN_BATCH = 4


def vlm_prefill_row(dev) -> dict:
    """Phase 20(b) and row 2e."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.models.lm import act_dtype
    from repro_torch.serve.step import make_prefill_step

    arch, b, p, s = VLM_PREFILL
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_lm(cfg, seed=0, device=dev)
    draws = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                            generator=draws)
    patches = torch.randn((b, p, cfg.d_model), device=dev,
                          generator=draws).to(act_dtype(cfg))
    prefill = make_prefill_step(cfg, use_kernels=True)
    logits, _ = prefill(params, prompts, patches)        # warm-up
    _reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill(params, prompts, patches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    designs = dict(ops.DESIGN_LAUNCHES)
    launches = ops.KERNEL_LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    check(designs == {"wgmma": cfg.n_layers, "simt": 0}
          and launches == cfg.n_layers,
          f"vlm/prefill_1024: flash launches by design {designs}, want all "
          f"{cfg.n_layers} through wgmma")
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size].float()).all()),
          "vlm/prefill_1024: logits not finite")
    print(f"vlm/prefill_1024: arch={arch} batch={b} patches={p} prompt={s} "
          f"rows={p + s} prefill_ms={prefill_s * 1e3:.3f} "
          f"tok_per_s={b * (p + s) / prefill_s:.1f} flash_launches="
          f"{launches} flash_designs={designs} peak_mem_bytes={peak}")
    del params, prompts, patches, logits
    torch.cuda.empty_cache()

    h, hd, rows = cfg.n_heads, cfg.hd, p + s
    gen = torch.Generator(device=dev).manual_seed(20)
    q, k, v = (torch.randn((b, rows, h, hd), generator=gen,
                           device=dev).bfloat16() for _ in range(3))
    design = ops.flash_design(q.dtype, hd)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    key = f"{b}x{rows}x{h}x{hd}"
    err, row, rms = flash_check(f"pixtral {key} {design}", got, want,
                                q.dtype)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), reps=20)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True),
                       reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=20)
    bound, by = flash_bound_ms(b, rows, h, hd, 0, q.dtype)
    print(f"kernel/flash_attention pixtral {key}: design={design} "
          f"max_abs_err={err:.6g} worst_row_rel={row:.6g} rel_rms={rms:.6g} "
          f"ms={ms:.6f} plain_ms={plain_ms:.6f} library_ms={lib_ms:.6f} "
          f"bound_ms={bound:.6f} ({by})")
    del q, k, v, qt, kt, vt, got, want
    torch.cuda.empty_cache()
    return {key: dict(design=design, causal=True, max_abs_err=err,
                      rel_row_err=row, rel_rms=rms, ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, bound_ms=bound, bound_by=by,
                      prefill_ms=prefill_s * 1e3, prefill_launches=launches)}


def vlm_float32_cut(dev) -> None:
    """Phase 20(c), float32 at published width, depth cut: the kernel
    route (flash on the CUDA cores) against the twin route."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as T

    arch, batch, prompt_len, gen, layers = VLM_F32
    cfg = dataclasses.replace(get_arch(arch), dtype="float32",
                              n_layers=layers)
    params = T.init_lm(cfg, seed=0, device=dev)
    draws = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            device=dev, generator=draws)
    patches = torch.randn((batch, 8, cfg.d_model), device=dev,
                          generator=draws)
    before = dict(flash_ops.DESIGN_LAUNCHES)
    kern = launch_serve.generate(params, prompts, cfg, gen, use_kernels=True,
                                 patches=patches)
    designs = {d: flash_ops.DESIGN_LAUNCHES[d] - before[d] for d in before}
    check(designs == {"wgmma": 0, "simt": layers},
          f"pixtral float32 ran flash designs {designs}, want all {layers} "
          f"through simt")
    with plain_kernels():
        twin = launch_serve.generate(params, prompts, cfg, gen,
                                     use_kernels=True, patches=patches)
    c = _compare(kern, twin, cfg.vocab_size)
    tol_max, tol_rel = VLM_F32_TOL
    tag = f"serve/vlm/e2e_float32_L{layers}"
    print(f"{tag}/cut: {layers} of 40 layers at full width (float32 "
          f"parameters: {sum(x.numel() for x in T.flatten(params).values())}"
          f" elements)")
    print_compare(f"{tag}/kernel_vs_twin", c, batch,
                  f"(tolerance: max {tol_max}, rel_rms {tol_rel}, tokens "
                  f"equal)")
    print(f"{tag}: prefill_ms kernel={kern['prefill_s'] * 1e3:.3f} twin="
          f"{twin['prefill_s'] * 1e3:.3f}; flash_designs={designs}")
    del params, prompts, patches, kern, twin
    torch.cuda.empty_cache()
    check(c["token_agreement"] == 1.0 and all(
        c[f"{p}_max"] <= tol_max and c[f"{p}_rel"] <= tol_rel
        for p in ("prefill", "decode")),
        f"{tag}: the kernel route differs from the twin route beyond "
        f"tolerance")


def vlm_patches_card_vs_cpu(dev, cpu: Worker) -> None:
    """Phase 20(e): the training batch's patch embeddings on the card
    (through ``make_batch_fn``) against the same draw on the CPU (in the
    CPU references' worker), bitwise, in bfloat16 and float32."""
    from repro_torch.configs import ARCHS

    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(ARCHS[VLM_TRAIN[0]], dtype=dtype)
        t0 = time.perf_counter()
        got = _vlm_batch(dtype, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want, cpu_s = cpu.get(f"patches_{dtype}")
        equal = all(torch.equal(got[k].cpu(), want[k]) for k in want)
        pe = want["patch_embeds"]
        print(f"prng/vlm_patch_embeds_{dtype}: {tuple(pe.shape)} "
              f"bitwise_equal_cpu={equal} batch_on_card_s={t1 - t0:.3f} "
              f"batch_on_cpu_s={cpu_s:.3f} "
              f"mean={float(pe.float().mean()):.6f} "
              f"std={float(pe.float().std()):.6f}")
        check(equal and pe.shape == (1, cfg.encoder.n_frames, cfg.d_model),
              f"prng/vlm_patch_embeds_{dtype}: the card's batch differs "
              f"from the CPU route's")


def xla_f32_card_vs_cpu(dev) -> None:
    """Phase 20(f): ``core.xla_f32`` on the card against the CPU, bit for
    bit: exp over the estimator's range and past both clamp ends, log over
    the estimator's range and every positive exponent, logsumexp over
    53-wide rows (the estimator's) with exact ties, XLA_F32_N inputs each."""
    from repro_torch.core import xla_f32

    gen = torch.Generator().manual_seed(20)
    n = XLA_F32_N
    half = n // 2
    inputs = {
        "exp": torch.cat([torch.rand(half, generator=gen) * 88.0 - 87.0,
                          torch.rand(n - half, generator=gen) * 210.0
                          - 110.0]),
        "log": torch.cat([torch.exp(torch.rand(half, generator=gen) * 24.0
                                    - 10.0),
                          torch.exp2(torch.rand(n - half, generator=gen)
                                     * 250.0 - 124.0)]),
        "logsumexp": torch.randn((n // 53, 53), generator=gen) * 10.0,
    }
    inputs["logsumexp"][:, 3] = inputs["logsumexp"][:, 5]
    fns = {"exp": xla_f32.exp, "log": xla_f32.log,
           "logsumexp": lambda t: xla_f32.logsumexp(t, -1)}
    for name, x in inputs.items():
        t0 = time.perf_counter()
        got = fns[name](x.to(dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = fns[name](x)
        t2 = time.perf_counter()
        same = (got.cpu().view(torch.int32) == want.view(torch.int32))
        print(f"xla_f32/{name}: inputs={x.numel()} bitwise_equal_cpu="
              f"{bool(same.all())} card_s={t1 - t0:.3f} cpu_s={t2 - t1:.3f}")
        check(bool(same.all()), f"xla_f32/{name}: {int((~same).sum())} "
              f"results differ between the card and the CPU")


def dryrun_vs_card(dev) -> None:
    """Phase 20(g): the dry run's argument bytes against the card."""
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import DeviceMesh, make_local_mesh
    from repro_torch.parallel.sharding import ShardingRules, place
    from repro_torch.train import optimizer as OPT
    from repro_torch.train.data import make_batch_fn
    from repro_torch.train.step import init_params

    cfg = ARCHS[TRAIN_ARCH]
    shape = ShapeSpec("train_4k", 4096, DRYRUN_BATCH, "train")
    grid = np.empty((1, 1), dtype=object)
    grid.fill(torch.device("meta"))
    t0 = time.perf_counter()
    rec = dryrun.plan_cell(cfg, shape, DeviceMesh(grid, ("data", "model")),
                           "1x1")
    plan_s = time.perf_counter() - t0
    want = rec["memory"]["argument_size_in_bytes"]
    torch.cuda.empty_cache()

    def requested() -> int:   # bytes asked for, not the rounded blocks
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    base, base_alloc = requested(), torch.cuda.memory_allocated()
    mesh = make_local_mesh(device=str(dev))
    rules = ShardingRules(mesh)
    params = OPT.tree_map(lambda p: p.float(),
                          init_params(cfg, seed=0, device=mesh.device))
    params = place(params, rules.tree_shardings(params))
    opt = OPT.init(params)
    batch = make_batch_fn(cfg, shape, device=mesh.device)(0)
    torch.cuda.synchronize()
    held = requested() - base
    alloc = torch.cuda.memory_allocated() - base_alloc
    n = len(OPT.leaves(params)) * 3 + 1 + len(batch)
    print(f"dryrun/train_4k_1x1: arch={cfg.name} batch={DRYRUN_BATCH} "
          f"seq=4096 predicted_argument_bytes={want} card_requested_bytes="
          f"{held} diff={held - want} card_allocated_bytes={alloc} "
          f"(the allocator's blocks) tensors={n} "
          f"temp_bytes={rec['memory']['temp_size_in_bytes']} "
          f"flops={rec['cost']['flops']} fits_80gb={rec['fits_80gb']} "
          f"plan_s={plan_s:.3f}")
    del params, opt, batch
    torch.cuda.empty_cache()
    # the requested bytes are the tensors' own and must equal the plan's;
    # the allocated bytes are the allocator's blocks: each request rounded
    # up to 512 bytes, and a large block left whole when less than 1 MiB
    # of it would remain
    check(held == want,
          f"dryrun/train_4k_1x1: the card holds {held} requested bytes, "
          f"the plan predicted {want}")
    check(0 <= alloc - want <= n * ((1 << 20) + 512),
          f"dryrun/train_4k_1x1: the card's blocks hold {alloc} bytes, "
          f"more than the allocator's rounding of {n} tensors adds to the "
          f"plan's {want}")


def vlm_on_card(dev, cpu: Worker | None = None) -> dict:
    """Phase 20, (a)-(g), each part's seconds printed. Returns the flash
    launches by path (serve/vlm, the main path of (a), and
    train/vlm_kernel_loss of (d)) and row 2e."""
    t0 = time.perf_counter()
    served = serve_phase("vlm", dev)
    t1 = time.perf_counter()
    row = vlm_prefill_row(dev)
    t2 = time.perf_counter()
    vlm_float32_cut(dev)
    t3 = time.perf_counter()
    arch, layers, batch = VLM_TRAIN
    print(f"train/vlm/cut: {layers} of 40 layers at published width (the "
          f"float32 parameters, gradients, m and v of 40 layers, about 195 "
          f"GB, do not fit one card); no restart (a 16 GB checkpoint at "
          f"any depth; phase 17(a) restarts launch.train)")
    launches = kernel_route_loss(arch, layers, batch, dev)
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    vlm_patches_card_vs_cpu(dev, cpu or Worker(cpu_references))
    t5 = time.perf_counter()
    xla_f32_card_vs_cpu(dev)
    t6 = time.perf_counter()
    dryrun_vs_card(dev)
    t7 = time.perf_counter()
    print(f"phase20/seconds: a_c_bf16={t1 - t0:.3f} b_row_2e={t2 - t1:.3f} "
          f"c_f32={t3 - t2:.3f} d={t4 - t3:.3f} e={t5 - t4:.3f} "
          f"f={t6 - t5:.3f} g={t7 - t6:.3f}")
    return dict(served=served, train=launches, flash_row=row)


# The CPU sides of phases 19(d), 20(e) and 21(a) (the batches' frames and
# patch embeddings and XLA's log1p, a normal and an exponential draw, on
# the CPU: about 33 s of the card's host) run in a worker process that
# starts after phase 9 and takes CPU_REF_THREADS threads, while the main
# process drives the card (in the main process, each beside its card leg,
# until the model split came: the smoke's time).
CPU_REF_THREADS = 2


def _frames_cpu(dtype: str) -> torch.Tensor:
    """Phase 19(d)'s frames, drawn on the CPU as ``make_batch_fn`` draws
    them on the card."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import prng
    from repro_torch.models.lm import act_dtype

    arch, _, batch = AUDIO_TRAIN
    cfg = dataclasses.replace(ARCHS[arch], dtype=dtype)
    key = prng.fold_in(prng.PRNGKey(0 ^ 7), 1)   # seed 0, step 1
    return prng.normal(key, (batch, cfg.encoder.n_frames, cfg.d_model),
                       dtype=act_dtype(cfg))


def _vlm_batch(dtype: str, device) -> dict:
    """Phase 20(e)'s batch (1 row, step 1) of ``make_batch_fn``."""
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.train.data import make_batch_fn

    cfg = dataclasses.replace(ARCHS[VLM_TRAIN[0]], dtype=dtype)
    return make_batch_fn(cfg, ShapeSpec("smoke", 32, 1, "train"), seed=0,
                         device=device)(1)


def _log1p_inputs() -> torch.Tensor:
    return torch.from_numpy(np.arange(0, 1 << 32, SHARDED_LOG1P_STRIDE,
                                      dtype=np.uint64).astype(np.uint32)
                            .view(np.float32))


def cpu_references(path: str) -> None:
    """The worker: each CPU side and its seconds, saved to ``path``."""
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(CPU_REF_THREADS)
    from repro_torch.core import prng, xla_f32

    refs = {}
    work = [(f"frames_{d}", lambda d=d: _frames_cpu(d))
            for d in ("bfloat16", "float32")]
    work += [(f"patches_{d}", lambda d=d: _vlm_batch(d, "cpu"))
             for d in ("bfloat16", "float32")]
    work += [("log1p", lambda: xla_f32.log1p(_log1p_inputs()))]
    work += [(draw.__name__, lambda draw=draw: draw(prng.PRNGKey(29),
                                                    (SHARDED_DRAWS,)))
             for draw in (prng.normal, prng.exponential)]
    for name, fn in work:
        t0 = time.perf_counter()
        refs[name] = (fn(), time.perf_counter() - t0)
    torch.save(refs, path)


class Worker:
    """``target(path)`` in a worker process (spawned, a daemon: it ends
    with the smoke) that saves a dict of results to ``path``;
    ``get(name)`` waits for the worker at the first call and returns the
    result ``name``."""

    def __init__(self, target):
        import multiprocessing
        import tempfile

        self.name = target.__name__
        self.path = str(Path(tempfile.gettempdir()) /
                        f"chip_smoke_{self.name}_{time.time_ns()}.pt")
        self.proc = multiprocessing.get_context("spawn").Process(
            target=target, args=(self.path,), daemon=True)
        self.proc.start()
        self.results = None

    def get(self, name: str):
        if self.results is None:
            t0 = time.perf_counter()
            self.proc.join(timeout=900)
            check(self.proc.exitcode == 0,
                  f"the {self.name} worker ended with {self.proc.exitcode}")
            self.results = torch.load(self.path, weights_only=False)
            Path(self.path).unlink()
            print(f"{self.name}: waited_s={time.perf_counter() - t0:.3f} "
                  + " ".join(f"{k}_s={v[1]:.3f}"
                             for k, v in self.results.items()))
        return self.results[name]

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=30)
        Path(self.path).unlink(missing_ok=True)


# phase 21: training with parameters split over a (data, model) mesh of
# the one card (a DeviceMesh whose positions all repeat cuda:0, as
# ScenariosMesh repeats a device in phase 16; train.step's split route). (a)
# XLA's float32 log1p (core.xla_f32.log1p) on the card against the CPU
# over every SHARDED_LOG1P_STRIDE-th float32 bit pattern (2^24 inputs),
# and a normal and an exponential draw of SHARDED_DRAWS, bitwise.
SHARDED_LOG1P_STRIDE = 256
SHARDED_DRAWS = 1 << 20
# (b) qwen2-0.5b at published width and depth, phase 17's batch: 3 steps
# on a (2, 2) mesh against 3 steps of make_train_step(accum=2) on the
# unsplit card route, from the same weights and batches (drawn once);
# (c) a (1, 2) mesh against the unsplit step, 2 steps. On both each
# layer's compute is split over ``model`` (parallel.model_split: the
# positions' partial sums added in position order), so the losses and
# grad norms are held within TRAIN_KERNEL_REL (phase 17(b)'s gate) of
# the other route's and the largest parameter, m and v differences are
# printed. The split step gathers a (layer, position) block at a time and
# sums each gradient into its blocks, so its peak is held to at most the
# other route's plus the bytes of the shards that repeat a block
# (parameters, m, v) and of the largest layer's and the top-level
# leaves' gathers. (f) A (2, 1) mesh, no compute split, at
# SPLIT_ROWS_LAYERS layers: 2 steps bitwise accum=2 (losses, grad norms,
# parameters, m, v).
SHARDED_STEPS = 3
SPLIT_ROWS_LAYERS = 4
# (b) also runs, on (2, 2), SPLIT_TIMED_ROUNDS rounds of one more step of
# the accum route and the split route, then one profiled step of each:
# where the split route's time goes (split_step_launches). The split
# route with its gathers-again hooks off went when (g) came, for the
# smoke's time (PERF.md keeps its last reading).
SPLIT_TIMED_ROUNDS = 2
# (d) launch.train at published width cut to SHARDED_RESTART_LAYERS
# layers and sequences of SHARDED_RESTART_SEQ (1024 until the model split
# came: a batch's draws over the vocabulary took 0.74 s, eight batches
# of the smoke's time), SHARDED_RESTART_AT steps on (2, 2) in this
# process (it saved there until (g) came; (g)'s save takes its place);
# (g) the same run on SHARDED_PROCESS_RANKS processes, one a position of
# the (2, 2) mesh, every one on the card (launch.train under a
# torch.distributed group, parallel.dist: gloo through pinned host
# buffers), saved at SHARDED_RESTART_AT (zlib level 0): its losses and
# every leaf of its checkpoint's params, m and v bitwise (d)'s; its
# checkpoint resumed onto (4, 1) and onto (1, 1) for as many more steps
# (2 and 2 until the model split came, for the smoke's time), each
# continuation's losses bitwise the accum=4 / accum=1 steps from the same
# checkpoint; (e) apply_resize (2, 2) -> (4, 1) of that state, every
# shard bitwise. A rank that fails, or runs past SHARDED_PROCESS_DEADLINE
# seconds, fails the phase.
SHARDED_RESTART_LAYERS = 2
SHARDED_RESTART_SEQ = 256
SHARDED_RESTART_AT = 1
SHARDED_PROCESS_RANKS = 4
SHARDED_PROCESS_DEADLINE = 300


def card_mesh(dev, data: int, model: int):
    from repro_torch.launch.mesh import DeviceMesh

    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device(dev))
    return DeviceMesh(grid, ("data", "model"))


def log1p_card_vs_cpu(dev, cpu: Worker) -> None:
    """Phase 21(a)."""
    from repro_torch.core import prng, xla_f32

    x = _log1p_inputs()
    t0 = time.perf_counter()
    got = xla_f32.log1p(x.to(dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want, cpu_s = cpu.get("log1p")
    got = got.cpu()
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want))
    print(f"xla_f32/log1p: inputs={x.numel()} (every "
          f"{SHARDED_LOG1P_STRIDE}th bit pattern) bitwise_equal_cpu="
          f"{bool(same.all())} card_s={t1 - t0:.3f} cpu_s={cpu_s:.3f} "
          f"(the worker's)")
    check(bool(same.all()), f"xla_f32/log1p: {int((~same).sum())} results "
          f"differ between the card and the CPU")
    for draw in (prng.normal, prng.exponential):
        key = prng.PRNGKey(29)
        t0 = time.perf_counter()
        got = draw(key.to(dev), (SHARDED_DRAWS,))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want, cpu_s = cpu.get(draw.__name__)
        equal = torch.equal(got.cpu(), want)
        print(f"prng/{draw.__name__}: draws={SHARDED_DRAWS} "
              f"bitwise_equal_cpu={equal} card_s={t1 - t0:.3f} "
              f"cpu_s={cpu_s:.3f}")
        check(equal, f"prng/{draw.__name__}: the card's draw differs from "
              f"the CPU's")


def _timed_steps(step, make_state, batches) -> tuple:
    """The state ``make_state()`` makes and the steps over ``batches``
    from it: (params, opt, [loss], [grad norm], [seconds], peak bytes
    above what was allocated before the state was made, the device's
    peak bytes)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, opt = make_state()
    losses, norms, secs = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    peak = torch.cuda.max_memory_allocated()
    return params, opt, losses, norms, secs, peak - before, peak


def _replicated_bytes(*trees) -> int:
    """The bytes of the shards that repeat a block another position
    holds, over ``trees`` (the step's gradient accumulators hold one
    tensor a block, so they repeat none)."""
    from repro_torch.parallel.sharding import ShardedTensor
    from repro_torch.train import optimizer as OPT

    return sum(s.numel() * s.element_size()
               for tree in trees for x in OPT.leaves(tree)
               if isinstance(x, ShardedTensor)
               for k, s in enumerate(x.shards) if k not in x.firsts)


def _gather_bytes(cfg, tree) -> tuple[int, int]:
    """(the split leaves' bytes in the type the layers use them in, which
    the unsplit routes hold cast through the backward; the bytes a split
    step's gathers hold at once at most: the largest layer's split leaves
    and the split top-level leaves, in that type)."""
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ShardedTensor, taken_by_layer
    from repro_torch.train import step as TS

    use = TS.use_dtypes(cfg)
    tree_use, top, layer = 0, 0, {}
    for path, x in lm.flatten(tree).items():
        if not isinstance(x, ShardedTensor):
            continue
        size = x.numel() * torch.empty((), dtype=use[path]).element_size()
        tree_use += size
        if taken_by_layer(path):
            stack = path.split("/", 1)[0]
            layer[stack] = layer.get(stack, 0) + size // x.shape[0]
        else:
            top += size
    return tree_use, top + max(layer.values(), default=0)


def _step_launches(step, params, opt, batch) -> tuple[int, float]:
    """(device launches, device ms) of one ``step(params, opt, batch)``
    under torch.profiler (CUDA activity: kernels, copies and fills that
    took device time, counted as phase 4 counts them), read from the
    profiler's raw events rather than its averages (seconds less at a
    step's 16k launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    return len(ns), sum(ns) / 1e6


def split_step_launches(tag: str, cfg, ref, got, batch, data: int) -> None:
    """Where the split route's time goes: SPLIT_TIMED_ROUNDS rounds of one
    more step of each route in turn, unprofiled (wall and the process's
    CPU seconds), then one profiled step of each (launches, device ms):
    the ``accum`` route and the split route. Counted on the split route's
    profiled step: its gathers (``gathers``, those again included), the
    gathers again (``regathers``), the block copies of both, and the
    autograd inputs of a step (a block's layer each, one gradient copy
    and one sum a row)."""
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.sharding import ShardedTensor
    from repro_torch.train import step as TS

    counts = dict(gathers=0, regathers=0, block_copies=0)
    real_build, real_regather = SH._build, SH._regather

    def build(plan, blocks):
        counts["gathers"] += 1
        counts["block_copies"] += len(plan.index)
        return real_build(plan, blocks)

    def regather(plan, blocks):
        counts["regathers"] += 1
        return real_regather(plan, blocks)

    split_step = TS.make_train_step(cfg, remat="none")
    routes = {"accum": (TS.make_train_step(cfg, accum=data, remat="none"),
                        ref, contextlib.nullcontext),
              "split": (split_step, got, contextlib.nullcontext)}
    out = {name: dict(step_s=[], cpu_s=[]) for name in routes}
    for _ in range(SPLIT_TIMED_ROUNDS):
        for name, (step, state, ctx) in routes.items():
            with ctx():
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), time.process_time()
                step(state[0], state[1], batch)
                torch.cuda.synchronize()
                out[name]["step_s"].append(round(time.perf_counter() - t0,
                                                 6))
                out[name]["cpu_s"].append(round(time.process_time() - c0,
                                                6))
    for name, (step, state, ctx) in routes.items():
        counts.update(gathers=0, regathers=0, block_copies=0)
        with ctx(), patched((SH, "_build", build),
                            (SH, "_regather", regather)):
            launches, busy_ms = _step_launches(step, state[0], state[1],
                                               batch)
        out[name].update(launches=launches, device_ms=round(busy_ms, 3),
                         **counts)
    out["split"]["autograd_block_inputs"] = data * sum(
        len(x.firsts) * (x.shape[0] if SH.taken_by_layer(path) else 1)
        for path, x in lm.flatten(got[0]).items()
        if isinstance(x, ShardedTensor))
    print(f"{tag}/launches: {json.dumps(out)}")
    check(out["split"]["regathers"] > 0 and out["accum"]["gathers"] == 0,
          f"{tag}: gathers again {out}: the hooks were not on where they "
          f"should be, or the accum route gathered")


def _trees_equal(got, want) -> bool:
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.train import optimizer as OPT

    return all(torch.equal(a, b) for a, b in zip(
        OPT.leaves(gather_tree(got)), OPT.leaves(want)))


def _trees_diff(got, want) -> float:
    """The largest |Δ| over every leaf of a split tree and a whole one."""
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.train import optimizer as OPT

    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        OPT.leaves(gather_tree(got)), OPT.leaves(want)))


def split_rows_bitwise(dev) -> None:
    """Phase 21(f): no ``model`` split, so the split step is bitwise the
    accumulating one."""
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.parallel.sharding import ShardingRules, place
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    tag = "train/split_2x1"
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], n_layers=SPLIT_ROWS_LAYERS)
    base = OPT.tree_map(lambda p: p.float(),
                        TS.init_params(cfg, seed=0, device=dev))
    batch_fn = make_batch_fn(cfg, ShapeSpec("smoke", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"), seed=0, device=dev)
    batches = [batch_fn(i) for i in range(2)]
    mesh = card_mesh(dev, 2, 1)

    def unsplit():
        p = OPT.tree_map(lambda x: x.clone(), base)
        return p, OPT.init(p)

    def split():
        sp = place(OPT.tree_map(lambda x: x.clone(), base),
                   ShardingRules(mesh).tree_shardings(base))
        return sp, OPT.init(sp)

    ref = _timed_steps(TS.make_train_step(cfg, accum=2, remat="none"),
                       unsplit, batches)
    got = _timed_steps(TS.make_train_step(cfg, remat="none"), split,
                       batches)
    same = (all(torch.equal(a, b) for i in (2, 3)
                for a, b in zip(got[i], ref[i]))
            and all(_trees_equal(g, r) for g, r in (
                (got[0], ref[0]), (got[1].m, ref[1].m),
                (got[1].v, ref[1].v))))
    print(f"{tag}: arch={TRAIN_ARCH} layers={cfg.n_layers} "
          f"batch={TRAIN_BATCH} seq={TRAIN_SEQ} steps=2 "
          f"losses={[float(x) for x in got[2]]} bitwise_accum_2={same} "
          f"step_s={[round(t, 6) for t in got[4]]} "
          f"accum_step_s={[round(t, 6) for t in ref[4]]}")
    check(same, f"{tag}: the (2, 1) split step is not bitwise accum=2")
    del ref, got
    torch.cuda.empty_cache()


def split_steps(dev) -> None:
    """Phase 21(b) and (c)."""
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.parallel.sharding import (ShardedTensor, ShardingRules,
                                               place)
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    cfg = ARCHS[TRAIN_ARCH]
    base = OPT.tree_map(lambda p: p.float(),
                        TS.init_params(cfg, seed=0, device=dev))
    t0 = time.perf_counter()
    batch_fn = make_batch_fn(cfg, ShapeSpec("smoke", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"), seed=0, device=dev)
    batches = [batch_fn(i) for i in range(SHARDED_STEPS)]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    for (data, model), n in (((2, 2), SHARDED_STEPS), ((1, 2), 2)):
        tag = f"train/split_{data}x{model}"

        def unsplit():
            p = OPT.tree_map(lambda x: x.clone(), base)
            return p, OPT.init(p)

        def split():
            sp = place(OPT.tree_map(lambda x: x.clone(), base),
                       ShardingRules(mesh).tree_shardings(base))
            return sp, OPT.init(sp)

        mesh = card_mesh(dev, data, model)
        ref = _timed_steps(TS.make_train_step(cfg, accum=data, remat="none"),
                           unsplit, batches[:n])
        got = _timed_steps(TS.make_train_step(cfg, remat="none"), split,
                           batches[:n])
        n_split = sum(isinstance(x, ShardedTensor)
                      for x in OPT.leaves(got[0]))
        losses = [float(x) for x in got[2]]
        rel = max(abs(float(a) - float(b)) / abs(float(b))
                  for i in (2, 3) for a, b in zip(got[i], ref[i]))
        check(rel <= TRAIN_KERNEL_REL,
              f"{tag}: losses {losses} or grad norms "
              f"{[float(x) for x in got[3]]} lie {rel:.3g} from the "
              f"accum={data} route's {[float(x) for x in ref[2]]} "
              f"{[float(x) for x in ref[3]]}")
        diffs = [_trees_diff(g, r) for g, r in ((got[0], ref[0]),
                                                (got[1].m, ref[1].m),
                                                (got[1].v, ref[1].v))]
        replicated = _replicated_bytes(got[0], got[1].m, got[1].v)
        tree_use, gathered = _gather_bytes(cfg, got[0])
        print(f"{tag}: arch={TRAIN_ARCH} layers={cfg.n_layers} "
              f"batch={TRAIN_BATCH} seq={TRAIN_SEQ} steps={n} "
              f"split_leaves={n_split} of {len(OPT.leaves(got[0]))} "
              f"losses={losses} accum_{data}_losses="
              f"{[float(x) for x in ref[2]]} grad_norms="
              f"{[float(x) for x in got[3]]} accum_{data}_grad_norms="
              f"{[float(x) for x in ref[3]]} largest_rel={rel:.3g} "
              f"max_abs_diff_params_m_v={diffs} "
              f"step_s={[round(t, 6) for t in got[4]]} "
              f"accum_step_s={[round(t, 6) for t in ref[4]]} "
              f"peak_mem_bytes={got[5]} accum_peak_mem_bytes={ref[5]} "
              f"replicated_bytes={replicated} "
              f"layer_gather_bytes={gathered} "
              f"split_use_bytes={tree_use} "
              f"device_peak_bytes={got[6]} accum_device_peak_bytes={ref[6]} "
              f"data_s={data_s:.3f}")
        check(got[5] <= ref[5] + replicated + gathered,
              f"{tag}: peak {got[5]} bytes above the accum={data} route's "
              f"{ref[5]} plus replicated {replicated} and gathered "
              f"{gathered}")
        # the other route holds the split leaves cast to their use type
        # through the backward; a gather of the whole tree would too
        check(got[5] <= ref[5] - tree_use + replicated + gathered,
              f"{tag}: peak {got[5]} bytes above the accum={data} route's "
              f"{ref[5]} less the split leaves in their use type "
              f"{tree_use}, plus replicated {replicated} and gathered "
              f"{gathered}: more than a layer's gathers held at once")
        if (data, model) == (2, 2):
            split_step_launches(tag, cfg, ref, got, batches[0], data)
        del ref, got
        torch.cuda.empty_cache()


def _restart_cfg():
    from repro_torch.configs import ARCHS

    return ARCHS, dataclasses.replace(ARCHS[TRAIN_ARCH],
                                      n_layers=SHARDED_RESTART_LAYERS)


def _timed_step_maker(real, times: dict):
    """``make_train_step`` whose steps record their seconds, when the
    first started and the last ended (``times``), and the last state."""
    def make(cfg, **kw):
        step = real(cfg, **kw)

        def timed(params, opt, batch):
            torch.cuda.synchronize()
            t0 = time.time()
            times.setdefault("first_start", t0)
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            times["last_end"] = time.time()
            times.setdefault("step_s", []).append(times["last_end"] - t0)
            times["state"] = out[:2]
            return out

        return timed

    return make


def process_route_rank(rank: int, world: int, work: str,
                       spawned: float) -> None:
    """Phase 21(g): rank ``rank`` of ``launch.train`` on the (2, 2) mesh of
    ``world`` processes (``parallel.dist``; every rank on ``cuda:0``), as
    (d) runs it, saved at SHARDED_RESTART_AT into ``work/g``. Writes its
    losses, seconds (start-up: from the spawn to its first step; the
    step; the save: from the step's end to the save's publication),
    collectives and peak bytes to ``work/rank<rank>.json``; a failure's
    traceback to ``work/err<rank>.txt``."""
    import os
    import traceback
    from functools import partial

    work = Path(work)
    try:
        sys.path.insert(0, str(SRC))
        from repro_torch.launch import train as launch_train
        from repro_torch.parallel import dist
        from repro_torch.runtime import checkpoint as ckpt

        dist.init(rank, world, init_method=f"file://{work / 'init'}")
        torch.cuda.set_device(dist.local_device("cuda"))
        torch.backends.cuda.matmul.allow_tf32 = False   # as the smoke's
        torch.backends.cudnn.allow_tf32 = False         # own process
        archs, cfg = _restart_cfg()
        times: dict = {}
        dist.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        make = _timed_step_maker(launch_train.make_train_step, times)
        with patched((launch_train, "ARCHS",
                      dict(archs, **{TRAIN_ARCH: cfg})),
                     (launch_train, "make_train_step", make),
                     (ckpt, "save_async", partial(ckpt.save_async,
                                                  level=0))):
            res = launch_train.train(
                TRAIN_ARCH, steps=SHARDED_RESTART_AT,
                ckpt_dir=str(work / "g"), ckpt_every=SHARDED_RESTART_AT,
                model_parallel=2, reduced=False, batch=TRAIN_BATCH,
                seq=SHARDED_RESTART_SEQ, log_every=1, device="cuda")
        end = time.time()
        (work / f"rank{rank}.json").write_text(json.dumps(dict(
            losses=res["losses"], device=str(dist.local_device("cuda")),
            startup_s=times["first_start"] - spawned,
            step_s=times["step_s"], save_s=end - times["last_end"],
            collectives=dist.COUNTS,
            peak_bytes=torch.cuda.max_memory_allocated())))
        dist.destroy()
    except BaseException:
        (work / f"err{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)


def process_route(tmp: Path) -> list:
    """Phase 21(g): the ranks, spawned together; each one's record, in
    rank order. A rank that fails or outlives the deadline fails the
    phase (the others are ended first)."""
    import multiprocessing

    work = tmp / "ranks"
    work.mkdir()
    ctx = multiprocessing.get_context("spawn")
    spawned = time.time()
    procs = [ctx.Process(target=process_route_rank,
                         args=(r, SHARDED_PROCESS_RANKS, str(work),
                               spawned))
             for r in range(SHARDED_PROCESS_RANKS)]
    for p in procs:
        p.start()
    end = time.monotonic() + SHARDED_PROCESS_DEADLINE
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    errs = "".join(f"rank {f.name}: {f.read_text()[-2000:]}"
                   for f in sorted(work.glob("err*.txt")))
    check(codes == [0] * SHARDED_PROCESS_RANKS,
          f"train/process_2x2: ranks ended with {codes} (None: killed at "
          f"the {SHARDED_PROCESS_DEADLINE} s deadline) {errs}")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(SHARDED_PROCESS_RANKS)]


def elastic_restart(dev) -> None:
    """Phase 21(d), (g) and (e)."""
    import shutil
    import tempfile
    from functools import partial

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import train as launch_train
    from repro_torch.parallel import dist
    from repro_torch.parallel.sharding import (ShardedTensor, ShardingRules,
                                               place)
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.elastic import apply_resize
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    archs, cfg = _restart_cfg()
    run = dict(reduced=False, batch=TRAIN_BATCH, seq=SHARDED_RESTART_SEQ,
               log_every=1, device=str(dev))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_split_"))
    at = SHARDED_RESTART_AT
    try:
        times: dict = {}
        with patched((launch_train, "ARCHS",
                      dict(archs, **{TRAIN_ARCH: cfg})),
                     (launch_train, "make_train_step", _timed_step_maker(
                         launch_train.make_train_step, times))):
            t0 = time.perf_counter()
            first = launch_train.train(TRAIN_ARCH, steps=at,
                                       mesh=card_mesh(dev, 2, 2), **run)
            first_s = time.perf_counter() - t0
        one_params, one_opt = times.pop("state")
        torch.cuda.empty_cache()
        # (g) the same run, one process a mesh position
        t0 = time.perf_counter()
        ranks = process_route(tmp)
        process_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size
                         for f in (tmp / "ranks" / "g" /
                                   f"step_{at}").iterdir())
        p = OPT.tree_map(lambda x: x.float(),
                         TS.init_params(cfg, device=dev))
        o = OPT.init(p)
        state = ckpt.restore({"params": p, "m": o.m, "v": o.v,
                              "step": o.step}, tmp / "ranks" / "g", at,
                             device=dev)
        same_losses = all([tuple(x) for x in r["losses"]] == first["losses"]
                          for r in ranks)
        same_state = (_trees_equal(one_params, state["params"])
                      and _trees_equal(one_opt.m, state["m"])
                      and _trees_equal(one_opt.v, state["v"])
                      and int(state["step"]) == int(one_opt.step))
        del one_params, one_opt, p, o
        torch.cuda.empty_cache()
        kinds = {k: [r["collectives"][k] for r in ranks]
                 for k in dist.KINDS}
        print(f"train/process_2x2: ranks={len(ranks)} devices="
              f"{[r['device'] for r in ranks]} transport={dist.TRANSPORT} "
              f"layers={cfg.n_layers} batch={TRAIN_BATCH} "
              f"seq={SHARDED_RESTART_SEQ} losses={ranks[0]['losses']} "
              f"one_process_losses={first['losses']} "
              f"bitwise_one_process_losses={same_losses} "
              f"bitwise_one_process_checkpoint={same_state} "
              f"startup_s={[round(r['startup_s'], 3) for r in ranks]} "
              f"step_s={[[round(t, 3) for t in r['step_s']] for r in ranks]} "
              f"one_process_step_s={[round(t, 3) for t in times['step_s']]} "
              f"save_s={[round(r['save_s'], 3) for r in ranks]} "
              f"wall_s={process_s:.3f} one_process_run_s={first_s:.3f} "
              f"collectives_by_rank={json.dumps(kinds)} "
              f"peak_bytes={[r['peak_bytes'] for r in ranks]} "
              f"checkpoint_bytes={ckpt_bytes}")
        check(same_losses, f"train/process_2x2: the ranks' losses "
              f"{[r['losses'] for r in ranks]} are not the one-process "
              f"run's {first['losses']}")
        check(same_state, "train/process_2x2: the ranks' checkpoint is not "
              "bitwise the one-process run's params, m and v")
        with patched((launch_train, "ARCHS",
                      dict(archs, **{TRAIN_ARCH: cfg})),
                     (ckpt, "save_async", partial(ckpt.save_async,
                                                  level=0))):
            batch_fn = make_batch_fn(cfg, ShapeSpec(
                "custom", SHARDED_RESTART_SEQ, TRAIN_BATCH, "train"), seed=0,
                device=dev)
            batches = [batch_fn(s) for s in range(at, 2 * at)]
            for (data, model), accum in (((4, 1), 4), ((1, 1), 1)):
                tag = f"train/elastic_2x2_to_{data}x{model}"
                d = tmp / f"{data}x{model}"
                d.mkdir()
                shutil.copytree(tmp / "ranks" / "g" / f"step_{at}",
                                d / f"step_{at}")
                t0 = time.perf_counter()
                got = launch_train.train(TRAIN_ARCH, steps=2 * at,
                                         ckpt_dir=str(d), ckpt_every=100,
                                         mesh=card_mesh(dev, data, model),
                                         **run)
                resume_s = time.perf_counter() - t0
                rp = OPT.tree_map(lambda x: x.clone(), state["params"])
                ro = OPT.AdamWState(state["step"].clone(),
                                    OPT.tree_map(lambda x: x.clone(),
                                                 state["m"]),
                                    OPT.tree_map(lambda x: x.clone(),
                                                 state["v"]))
                step = TS.make_train_step(cfg, accum=accum, remat="none")
                want = []
                for s, b in zip(range(at, 2 * at), batches):
                    rp, ro, m = step(rp, ro, b)
                    want.append((s, float(m["loss"])))
                check(got["losses"] == want,
                      f"{tag}: the continuation's losses {got['losses']} "
                      f"differ from the accum={accum} steps' {want}")
                print(f"{tag}: from the ranks' checkpoint "
                      f"layers={cfg.n_layers} batch={TRAIN_BATCH} "
                      f"seq={SHARDED_RESTART_SEQ} "
                      f"first_losses={first['losses']} "
                      f"losses={got['losses']} bitwise_accum_{accum}=True "
                      f"resume_s={resume_s:.3f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # (e) the restored state moved from (2, 2) to (4, 1)
    old, new = card_mesh(dev, 2, 2), card_mesh(dev, 4, 1)
    tree = {"params": state["params"], "m": state["m"], "v": state["v"]}
    placed = place(tree, ShardingRules(old).tree_shardings(tree))
    t0 = time.perf_counter()
    moved = apply_resize(placed, new, ShardingRules(new))
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t0
    n_split = n_shards = 0
    for x, whole in zip(OPT.leaves(moved), OPT.leaves(tree)):
        if isinstance(x, ShardedTensor):
            n_split += 1
            n_shards += len(x.shards)
            check(x.sharding.mesh is new and all(
                torch.equal(s, whole[i]) for i, s in zip(x.indices,
                                                          x.shards)),
                  "train/apply_resize: a shard differs from its block")
        else:
            check(torch.equal(x, whole),
                  "train/apply_resize: an unsplit leaf differs")
    print(f"train/apply_resize: (2, 2) -> (4, 1) leaves="
          f"{len(OPT.leaves(moved))} split={n_split} shards={n_shards} "
          f"bitwise=True resize_s={resize_s:.3f}")


def sharded_training_on_card(dev, cpu: Worker | None = None) -> None:
    """Phase 21, (a)-(g), each part's seconds printed ((g) with (d)-(e))."""
    t0 = time.perf_counter()
    log1p_card_vs_cpu(dev, cpu or Worker(cpu_references))
    t1 = time.perf_counter()
    split_steps(dev)
    t2 = time.perf_counter()
    elastic_restart(dev)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    split_rows_bitwise(dev)
    t4 = time.perf_counter()
    print(f"phase21/seconds: a={t1 - t0:.3f} b_c={t2 - t1:.3f} "
          f"d_g_e={t3 - t2:.3f} f={t4 - t3:.3f}")


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
    from repro_torch.xsim import backfill, families, policies
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
    scan_paths = {"sweep/table1": table1_setting(grid_mod, policies,
                                                 backfill, dev)}
    phases.done("3_table1")

    # phase 4: the main path at full size (counts reset just before it)
    full = full_size(grid_mod, policies, backfill, dev, RUNNING)

    # where a full-size step's time goes (a short profiled window)
    from repro_torch.xsim import events as events_mod
    profile_window(events_mod, full["state"])

    # the kernel at the main path's own inputs (its first pass)
    e, c, r = full["inputs"]
    b, n = e.shape
    main = freed_readings(backfill, e, c, r)
    print_freed(f"kernel/freed_scan main-path input B={b} N={n} "
                f"running={int(r.sum())}", main)
    err = max([main["max_abs_err"]]
              + [v["max_abs_err"] for v in checks.values()])
    entry = dict(name="freed_scan", **KERNELS["freed_scan"],
                 launches=full["launches"]["freed_scan"], max_abs_err=err,
                 ms=main["ms"], plain_ms=main["plain_ms"],
                 bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                 library_ms=None, max_abs_diff_vs_plain=err,
                 kernel_ms=main["ms"], design=main["design"],
                 launches_by_design=full["designs"],
                 device_us=main["device_us"],
                 presorted_ms=main["presorted_ms"],
                 presorted_device_us=main["presorted_device_us"],
                 r_mean=main["r_mean"], r_max=main["r_max"],
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

    # the workers start after the last reading of phases 2-9: the plain
    # paths of phases 10, 13(a), 15(a) and 16(a)-(b) on the card, the CPU
    # sides of phases 19(d), 20(e) and 21(a), while phases 10 and 11 run
    cpu = Worker(cpu_references)
    atexit.register(cpu.close)
    plain = Worker(side_runs)
    atexit.register(plain.close)

    # phase 10: the Table-1 setting with ASA-Naive under every family;
    # phase 11: that program at full size under the faulty family (counts
    # reset inside, per path); then phase 10 against the plain paths
    by_family, faulty, finals = table1_families(grid_mod, families,
                                                policies, backfill, dev)
    for family, n in by_family.items():
        scan_paths[f"sweep/table1_naive_{family}"] = n
    phases.done("10_table1_families")
    scan_paths["sweep/full_faulty"] = full_faulty(
        grid_mod, families, policies, backfill, events_mod, dev)
    table1_families_vs_plain(finals, plain)
    phases.done("11_full_faulty")

    # phase 12: the paper's tables: the QueueSim differentials through the
    # kernel (counts reset inside, per path), then Table 1 and Table 2
    from repro_torch.xsim import compare as compare_mod
    scan_paths["tables/queue_sim_differentials"] = queue_sim_differentials(
        backfill, events_mod, compare_mod, dev)
    table1_on_card(dev)
    table2_on_card(dev)
    phases.done("12_tables")

    # phase 13: traced sweeps (obs) through the scan kernel (counts reset
    # inside, per path)
    scan_paths["sweep/table1_naive_faulty_traced"] = traced_table1_faulty(
        grid_mod, families, backfill, faulty, plain, dev)
    scan_paths["sweep/full_traced"] = traced_full_size(
        grid_mod, policies, backfill, events_mod, full, dev)
    phases.done("13_traced")

    # phase 14: the ASA decision service on traffic from the port's own
    # sweep (counts reset inside, per path)
    scan_paths["serve/loadgen"], events = serve_service(
        grid_mod, families, policies, backfill, dev)
    phases.done("14_serve_asa")

    # phase 15: the learned submission policy (counts reset inside, per
    # path): the training geometry's rollout, then the acceptance recipe
    scan_paths["rl/rollout"], rl_run = rl_full_recipe(backfill, events_mod,
                                                      plain, dev)
    scan_paths["rl/train"] = rl_acceptance(backfill, dev)
    phases.done("15_rl")

    # phase 16: the sharded paths over blocks on the card and the ASA
    # campaign (counts reset inside, per path)
    scan_paths.update(sharded_and_campaign(faulty, rl_run, events, backfill,
                                           plain, dev))
    phases.done("16_sharded_campaign")

    # phase 17: training on the card (counts reset inside, per path)
    train_paths = training_on_card(dev)
    phases.done("17_train")

    # phase 18: the hybrid family, served and trained (counts reset
    # inside, per path), and the threefry counter past 2**32
    hybrid = hybrid_on_card(dev)
    served["hybrid"] = hybrid["served"]
    train_paths["flash_attention"]["train/hybrid_kernel_loss"] = \
        hybrid["train"]["flash_attention"]
    phases.done("18_hybrid")

    # phase 19: the audio family, served and trained (counts reset inside,
    # per path), flash at its three prefill shapes, the frames' draw
    audio = audio_on_card(dev, cpu)
    served["audio"] = audio["served"]
    train_paths["flash_attention"]["train/audio_kernel_loss"] = \
        audio["train"]["flash_attention"]
    phases.done("19_audio")

    # phase 20: the VLM prefix, served and trained (counts reset inside,
    # per path), flash at its 1024-patch prefill shape (row 2e), the
    # estimator's float32 functions and the dry run against the card
    vlm = vlm_on_card(dev, cpu)
    served["vlm"] = vlm["served"]
    train_paths["flash_attention"]["train/vlm_kernel_loss"] = \
        vlm["train"]["flash_attention"]
    phases.done("20_vlm")

    # phase 21: training with parameters split over a (data, model) mesh
    # of the card, bitwise the accumulating one-device step; an elastic
    # restart onto other meshes; XLA's float32 log1p on the card
    sharded_training_on_card(dev, cpu)
    phases.done("21_train_split")
    scan_paths["sweep/full"] = full["launches"]["freed_scan"]
    entry.update(launches=sum(scan_paths.values()),
                 launches_by_path=scan_paths)
    by_path = {name: {f"serve/{fam}": r["launches"][name]
                      for fam, r in served.items()}
               for name in ("flash_attention", "grouped_matmul", "wkv6")}
    check(by_path["flash_attention"]["serve/dense"] > 0
          and by_path["flash_attention"]["serve/moe"] > 0,
          f"serving never launched flash_attention: {by_path}")
    check(by_path["grouped_matmul"]["serve/moe"] > 0,
          f"MoE serving never launched grouped_matmul: {by_path}")
    check(by_path["flash_attention"]["serve/hybrid"] > 0,
          f"hybrid serving never launched flash_attention: {by_path}")
    check(by_path["flash_attention"]["serve/audio"] == 12,
          f"audio serving did not launch flash_attention 12 times (4 + 4 + "
          f"4 attentions of its prefill): {by_path}")
    check(by_path["flash_attention"]["serve/vlm"] == 40,
          f"VLM serving did not launch flash_attention once a layer of its "
          f"prefill (40): {by_path}")
    from repro_torch.configs import get_arch
    ssm_layers = get_arch(SERVE["ssm"][0]).n_layers
    check(by_path["wkv6"]["serve/ssm"] == ssm_layers,
          f"RWKV-6 serving did not launch wkv6 once per layer of its "
          f"prefill ({ssm_layers}): {by_path}")
    for name, paths in train_paths.items():
        by_path[name].update(paths)

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
                                   for f in ("dense", "moe", "hybrid",
                                             "audio", "vlm"))
                            for d in ("wgmma", "simt")},
        moe_shape="4x1024x16x128", moe=flash_rows["4x1024x16x128"],
        hybrid_shape=FLASH_HYBRID_KEY, hybrid=flash_rows[FLASH_HYBRID_KEY],
        whisper=audio["flash_rows"], pixtral=vlm["flash_row"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
