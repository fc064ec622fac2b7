"""The ``model`` axis's compute split of the split training step, on the
CPU (ROADMAP Queue 1 item 12(d): ``parallel.model_split``, the layers'
per-position shares in ``models/``, ``parallel.sharding.SplitAtUse``'s
per-position plan).

On a (k, m) mesh with m > 1 each data row's layers are computed a
``model`` position at a time, each position with its block of every leaf
whose spec splits a compute dimension over ``model``, and the shares
summed in position order (``model_split.psum``). Inputs are made from
seeds with numpy; the meshes repeat the one CPU.

* Per sublayer, bitwise: attention (qwen2's GQA: on 2 positions the KV
  heads split with the query heads, on 4 they stay whole and each
  position reads its query heads' KV heads by global index; with QKV
  biases), the MLP (SwiGLU, and GELU with ``b_up``/``b_down``), the MoE
  layer, RWKV-6's ``time_mix`` and ``channel_mix``, the Mamba-2 block
  (its out-norm's sum of squares across positions included), the
  vocab-parallel embedding and cross-entropy: each equals the sum, in
  position order, of the same function on each position's slices,
  written out here from the whole tensors.
* Per sublayer, to float32 rounding: each against the unsplit layer,
  largest |Δ| within ``SUBLAYER_TOL`` of the largest |output| (measured:
  1.6e-7 to 6.7e-7, the row-parallel products' partial sums; the Mamba-2
  block's conv carry, the lookup and MoE's top-2 combine are exact); the
  cross-entropy within ``LOSS_ULPS`` float32 steps.
* The step, in float32 (in bfloat16 a rounding change can flip a MoE
  routing tie, ROADMAP Queue 3), from the parameters and batches of
  ``tests/test_torch_train_sharded.py``: on (2, 2) and (1, 2) meshes,
  for all six families under ``remat`` "none" and "dots" (and "full" for
  the hybrid), two steps within ``LOSS_ULPS`` (losses), ``GRAD_REL``
  (grad norms), ``PARAM_ATOL`` (parameters) and ``MOMENT_REL`` (m and v,
  rel_rms) of ``make_train_step(accum=2)`` and of the
  unsplit step (``accum=1``, the (1, m) meshes; on (2, 2) a MoE's
  capacity is a microbatch's, so ``accum=2`` is its unsplit step). From
  a float32 init the gradients agree within rel_rms 1e-4, while the
  parameters may not hold ``PARAM_ATOL`` (see
  ``test_split_gradients_are_the_accum_gradients_to_float32``). One step
  from the reference's parameters against the reference's jitted
  ``accum=2`` step, within ``tests/test_torch_train.py``'s limits.
* Bitwise among itself: across ``remat`` policies and two runs, and a
  restart of ``launch.train`` onto the same mesh.
* The plan: which leaves a spec splits over ``model``
  (``sharding.model_dim``), a position's block bitwise its slice of the
  leaf, gathered over the FSDP axes from the blocks that hold it, and
  its gradient in those blocks.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch import convert
from repro_torch.configs import ARCHS, ShapeSpec
from repro_torch.kernels.moe_gmm.ref import activation
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models import zamba2 as Z
from repro_torch.parallel import model_split as MS
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec as P,
                                           ShardedTensor, ShardingRules,
                                           SplitAtUse, gather_tree, place)
from repro_torch.train import optimizer as TO
from repro_torch.train.data import make_batch_fn
from repro_torch.train.step import init_params, make_train_step

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

LOSS_ULPS = 3              # as tests/test_torch_train_sharded.py
PARAM_ATOL = 1.4e-7
GRAD_REL = 1e-4
MOMENT_REL = {"m": 1e-4, "v": 2e-4}
SUBLAYER_TOL = 4e-6       # about 30 float32 steps of the output's scale
ARCHS6 = ("qwen2-0.5b", "moonshot-v1-16b-a3b", "rwkv6-3b", "zamba2-1.2b",
          "whisper-tiny", "pixtral-12b")
# whisper's stacks split over the FSDP axes only (the rules' fallback),
# at d_ff 1024 as tests/test_torch_train_sharded.py widens it
WIDER = {"whisper-tiny": {"d_ff": 1024}}
RUN = dict(reduced=True, batch=4, seq=32, log_every=1)


def cpu_mesh(data: int, model: int) -> DeviceMesh:
    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device("cpu"))
    return DeviceMesh(grid, ("data", "model"))


def _cfg(arch: str):
    return dataclasses.replace(ARCHS[arch].reduced(), dtype="float32",
                               **WIDER.get(arch, {}))


def _layer(cfg, seed: int = 0) -> dict:
    """Layer 0 of a float32 model, every leaf moved by numpy noise (so
    biases and norm scales are not their constants) -> flat tree."""
    rng = np.random.default_rng(seed)
    tree = init_params(cfg, seed=seed, device="cpu")
    params = lm.layer(tree.get("layers", tree.get("enc_layers")), 0)
    return {k: v + torch.from_numpy(
        0.02 * rng.standard_normal(tuple(v.shape)).astype(np.float32))
        if not isinstance(v, dict) else {
            kk: vv + torch.from_numpy(0.02 * rng.standard_normal(
                tuple(vv.shape)).astype(np.float32))
            for kk, vv in v.items()}
        for k, v in params.items()}


def _x(cfg, seed: int = 1, b: int = 2, s: int = 32) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))


def _split(p: dict, prefix: str, n: int) -> dict:
    """``p``'s leaves as the split step hands them to a layer on a mesh
    of ``n`` ``model`` positions: ``model_split.Blocks`` of slices where
    the rules split a dimension over ``model``, else the tensor."""
    rules = ShardingRules(cpu_mesh(1, n))
    out = {}
    for k, v in p.items():
        d = SH.model_dim(rules.spec_for(f"{prefix}/{k}", tuple(v.shape)))
        if d is None:
            out[k] = v
            continue
        w = v.shape[d] // n
        out[k] = MS.Blocks(n, d, v.dtype,
                           lambda j, v=v, d=d, w=w: v.narrow(d, j * w, w))
    return out


def _close(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _ulps(got, want) -> float:
    return abs(float(got) - float(want)) / float(
        np.spacing(np.float32(abs(float(want)))))


# ------------------------------------------------- sublayers, bitwise


@pytest.mark.parametrize("n", [2, 4])
def test_attention_is_the_sum_of_its_positions(n):
    cfg = _cfg("qwen2-0.5b")
    p = _layer(cfg)["attn"]
    x = _x(cfg)
    sp = _split(p, "attn", n)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    hq = H // n
    kv_split = isinstance(sp["wk"], MS.Blocks)
    assert isinstance(sp["wq"], MS.Blocks) and kv_split == (n == 2)
    pos = torch.arange(x.shape[1])[None]
    want = None
    for j in range(n):
        heads = slice(j * hq, (j + 1) * hq)
        kvh = slice(j * KV // n, (j + 1) * KV // n) if kv_split \
            else slice(None)
        q = L._proj(x, p["wq"][:, heads]) + p["bq"][heads]
        k = L._proj(x, p["wk"][:, kvh]) + p["bk"][kvh]
        v = L._proj(x, p["wv"][:, kvh]) + p["bv"][kvh]
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        if kv_split:
            kf, vf = L.repeat_kv(k, H // KV), L.repeat_kv(v, H // KV)
        else:     # each query head's KV head by its global index
            idx = (j * hq + torch.arange(hq)) // (H // KV)
            kf, vf = k[:, :, idx], v[:, :, idx]
        out = L.sdpa(q, kf, vf, causal=True, window=cfg.sliding_window)
        part = out.reshape(*x.shape[:2], -1) @ p["wo"][heads].reshape(
            -1, cfg.d_model)
        want = part if want is None else want + part
    got, cache = L.attention(sp, x, cfg)
    assert cache is None
    assert torch.equal(got, want)
    assert _close(got, L.attention(p, x, cfg)[0]) <= SUBLAYER_TOL


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny"])
def test_mlp_is_the_sum_of_its_positions(arch):
    cfg = _cfg(arch)
    p = _layer(cfg)["mlp"]
    x = _x(cfg)
    n = 2
    sp = _split(p, "mlp", n)
    assert ("b_up" in p) == (cfg.mlp == "gelu")
    if "b_up" in p:     # b_up splits with its columns, b_down does not
        assert isinstance(sp["b_up"], MS.Blocks)
        assert not isinstance(sp["b_down"], MS.Blocks)
    f = p["w_up"].shape[1] // n
    want = None
    for j in range(n):
        cols = slice(j * f, (j + 1) * f)
        if "b_up" in p:
            h = F.gelu(x @ p["w_up"][:, cols] + p["b_up"][cols],
                       approximate="tanh")
        else:
            h = (activation(cfg.mlp)(x @ p["w_gate"][:, cols])
                 * (x @ p["w_up"][:, cols]))
        part = h @ p["w_down"][cols]
        want = part if want is None else want + part
    if "b_down" in p:   # once, after the sum
        want = want + p["b_down"]
    got = L.apply_mlp(sp, x, cfg.mlp)
    assert torch.equal(got, want)
    assert _close(got, L.apply_mlp(p, x, cfg.mlp)) <= SUBLAYER_TOL


def test_moe_is_the_sum_of_its_positions():
    cfg = _cfg("moonshot-v1-16b-a3b")
    p = _layer(cfg)["moe"]
    x = _x(cfg)
    n = 2
    sp = _split(p, "moe", n)
    assert not isinstance(sp["router"], MS.Blocks)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    N, D = x.shape[0] * x.shape[1], cfg.d_model
    xt = x.reshape(N, D)
    gate, idx = MOE.route(p, xt, cfg)            # once, replicated
    C = MOE.capacity(N, cfg)
    order, keep, dest = MOE.dispatch(idx, C, E)
    sg = gate.reshape(-1)[order]
    buf = torch.zeros((E * C + 1, D))
    buf[dest] = xt[order // k] * keep[:, None].float()
    eb = buf[:-1].view(E, C, D)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel())
    per_tok = rank.view(N, k).sort(dim=1).values
    e = E // n
    want = None
    for j in range(n):
        ex = slice(j * e, (j + 1) * e)
        g = activation(cfg.mlp)(torch.einsum("ecd,edf->ecf", eb[ex],
                                             p["w_gate"][ex]))
        u = torch.einsum("ecd,edf->ecf", eb[ex], p["w_up"][ex])
        h = torch.einsum("ecf,efd->ecd", g * u, p["w_down"][ex])
        rows = torch.cat([h.reshape(e * C, D), torch.zeros((1, D))])
        local = dest - j * e * C     # other positions' rows: the zero row
        slots = torch.where((local >= 0) & (local < e * C), local, e * C)
        contrib = rows[slots] * sg[:, None]
        part = contrib[per_tok[:, 0]]
        for i in range(1, k):
            part = part + contrib[per_tok[:, i]]
        want = part if want is None else want + part
    got = MOE.apply_moe(sp, x, cfg)
    assert torch.equal(got, want.reshape(x.shape))
    # top-2: every token's rows keep their order and association
    assert k == 2 and torch.equal(got, MOE.apply_moe(p, x, cfg))


def test_rwkv6_mixes_are_the_sums_of_their_positions():
    cfg = _cfg("rwkv6-3b")
    lp = _layer(cfg)
    x = _x(cfg)
    n = 2
    p = lp["time_mix"]
    sp = _split(p, "time_mix", n)
    assert isinstance(sp["bonus_u"], MS.Blocks)
    assert not isinstance(sp["decay_A"], MS.Blocks)
    D = cfg.d_model
    d = D // n
    h = p["bonus_u"].shape[0] // n
    xs = R._token_shift(x)
    w = R._decay(p, x, xs, x.dtype)              # the LoRA, whole, once
    want, states = None, []
    for j in range(n):
        cols = slice(j * d, (j + 1) * d)
        r, kk, v, g = (R._mix(x, xs, p["mu_" + c]) @ p["w" + c][:, cols]
                       for c in "rkvg")
        B, S = x.shape[:2]
        o, st = R.wkv_chunked(*(a.reshape(B, S, h, -1)
                                for a in (r, kk, v, w[..., cols])),
                              p["bonus_u"][j * h:(j + 1) * h],
                              chunk=min(cfg.rwkv.chunk, S))
        o32 = o.float()
        o32 = o32 * torch.rsqrt((o32 * o32).mean(-1, keepdim=True) + 1e-5)
        part = ((o32.reshape(B, S, d) * p["ln_x"][cols]) * F.silu(g)) \
            @ p["wo"][cols]
        want = part if want is None else want + part
        states.append(st)
    got, (shift, state) = R.time_mix(sp, x, cfg)
    assert torch.equal(got, want)
    assert torch.equal(state, torch.cat(states, 1))
    whole, (_, whole_state) = R.time_mix(p, x, cfg)
    assert _close(got, whole) <= SUBLAYER_TOL
    assert torch.equal(shift, x[:, -1:])
    assert _close(state, whole_state) <= SUBLAYER_TOL

    p = lp["channel_mix"]
    sp = _split(p, "channel_mix", n)
    f = p["w_in"].shape[1] // n
    xk = R._mix(x, R._token_shift(x), p["mu_k"])
    want = None
    for j in range(n):
        cols = slice(j * f, (j + 1) * f)
        part = torch.square(torch.relu(xk @ p["w_in"][:, cols])) \
            @ p["w_out"][cols]
        want = part if want is None else want + part
    got, _ = R.channel_mix(sp, x)
    assert torch.equal(got, want)
    assert _close(got, R.channel_mix(p, x)[0]) <= SUBLAYER_TOL


def test_mamba2_block_is_the_sum_of_its_positions():
    """Each position runs its channels and heads up to the out-norm; the
    RMS over the whole d_inner takes the positions' sums of squares
    (each in float64, summed in position order, rounded once); then each
    position normalises, gates and projects its channels."""
    cfg = _cfg("zamba2-1.2b")
    p = _layer(cfg)["mamba"]
    x = _x(cfg)
    n = 2
    sp = _split(p, "mamba", n)
    assert all(isinstance(sp[k], MS.Blocks) for k in (
        "w_in_x", "w_in_B", "A_log", "D_skip", "conv_x", "out_norm",
        "w_out"))
    d_inner, H = p["w_in_x"].shape[1], p["A_log"].shape[0]
    c, h = d_inner // n, H // n
    ys, zs = [], []
    for j in range(n):
        cols, heads = slice(j * c, (j + 1) * c), slice(j * h, (j + 1) * h)
        q = {"w_in_z": p["w_in_z"][:, cols], "w_in_x": p["w_in_x"][:, cols],
             "conv_x": p["conv_x"][:, cols], "w_in_B": p["w_in_B"][:, heads],
             "w_in_C": p["w_in_C"][:, heads],
             "w_in_dt": p["w_in_dt"][:, heads],
             "dt_bias": p["dt_bias"][heads], "A_log": p["A_log"][heads],
             "D_skip": p["D_skip"][heads]}
        y, z, _, _ = Z._inner(q, x, cfg, None, None)
        ys.append(y.float())
        zs.append(z)
    ss = torch.square(ys[0].double()).sum(-1, keepdim=True)
    for y in ys[1:]:
        ss = ss + torch.square(y.double()).sum(-1, keepdim=True)
    rms = torch.rsqrt(ss.float() / d_inner + 1e-5)
    want = None
    for j in range(n):
        cols = slice(j * c, (j + 1) * c)
        part = ((ys[j] * rms * p["out_norm"][cols]) * F.silu(zs[j])) \
            @ p["w_out"][cols]
        want = part if want is None else want + part
    got, (conv, state) = Z.mamba2_block(sp, x, cfg)
    assert torch.equal(got, want)
    whole, (wconv, wstate) = Z.mamba2_block(p, x, cfg)
    assert _close(got, whole) <= SUBLAYER_TOL
    assert torch.equal(conv, wconv)
    assert _close(state, wstate) <= SUBLAYER_TOL


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_lookup_and_xent(n):
    """The lookup: each token's row from the position that holds it,
    zeros from the others, summed: bitwise the unsplit lookup. The
    cross-entropy over the logits' blocks: the max across positions,
    each position's sum of exp summed in position order, the label's
    logit from its position: bitwise that, written out, and within
    ``LOSS_ULPS`` of the unsplit log-softmax."""
    rng = np.random.default_rng(3)
    V, D = 256, 16
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, V, size=(2, 32)))
    sp = _split({"table": table}, "embed", n)
    assert isinstance(sp["table"], MS.Blocks) and sp["table"].dim == 0
    v = V // n
    want = None
    for j in range(n):
        local = tokens - j * v
        inside = (local >= 0) & (local < v)
        rows = torch.where(inside[..., None],
                           table[j * v:(j + 1) * v][local.clamp(0, v - 1)],
                           torch.zeros(()))
        want = rows if want is None else want + rows
    got = L.embed(sp, tokens, torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(got, table[tokens])

    logits = torch.from_numpy(4 * rng.standard_normal((2, 32, V)).astype(
        np.float32))
    logits[..., 250:] = -1e30            # a padded vocabulary's tail
    labels = torch.from_numpy(rng.integers(0, 250, size=(2, 32)))
    blocks = list(logits.split(v, -1))
    m = torch.stack([b.amax(-1) for b in blocks]).amax(0)[..., None]
    total = None
    for b in blocks:
        s = torch.exp(b - m).sum(-1)
        total = s if total is None else total + s
    picked = torch.gather(logits, -1, labels[..., None])[..., 0] - m[..., 0]
    want = -torch.mean(picked - torch.log(total))
    got = lm.xent(blocks, labels)
    assert torch.equal(got, want)
    assert _ulps(got, lm.xent(logits, labels)) <= LOSS_ULPS


def test_the_padding_is_masked_at_the_position_that_holds_it():
    cfg = dataclasses.replace(_cfg("qwen2-0.5b"), vocab_size=200)
    params = init_params(cfg, seed=0, device="cpu")   # padded to 256
    x = _x(cfg)
    whole = lm.unembed(params, x, cfg)
    split = lm.unembed(dict(params, embed=_split(params["embed"], "embed",
                                                 4)), x, cfg)
    assert [b.shape[-1] for b in split] == [64] * 4
    assert torch.equal(torch.cat(split, -1), whole)
    assert not (split[2] == -1e30).any() and (split[3][..., 8:]
                                              == -1e30).all()


# --------------------------------------------------------------- the step


def _init(arch: str, dtype: str = "bfloat16") -> dict:
    """float32 parameters: ``init_params`` in ``dtype``, cast (bfloat16:
    ``tests/test_torch_train_sharded.py``'s)."""
    return TO.tree_map(lambda x: x.float(), init_params(
        dataclasses.replace(_cfg(arch), dtype=dtype), seed=2, device="cpu"))


def _run(arch: str, data: int, model: int, *, accum: int | None = None,
         remat: str = "none", n: int = 2, init: str = "bfloat16",
         grads: list | None = None):
    """``n`` float32 steps from the same state and batches: on a
    (data, model) mesh, or with ``accum`` on one device -> (losses,
    grad norms, params, m, v), gathered. ``grads`` takes each step's
    gradients, gathered."""
    cfg = _cfg(arch)
    p = _init(arch, init)
    if accum is None:
        p = place(p, ShardingRules(cpu_mesh(data, model)).tree_shardings(p))
    o = TO.init(p)
    step = make_train_step(cfg, accum=accum or 1, remat=remat)
    batch_fn = make_batch_fn(cfg, ShapeSpec("t", 32, 4, "train"), seed=1,
                             device="cpu")
    real = TO.update

    def update(params, gs, state, **kw):
        if grads is not None:
            grads.append([g.gather() if isinstance(g, ShardedTensor)
                          else g.clone() for g in gs])
        return real(params, gs, state, **kw)

    losses, norms = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "update", update)
        for i in range(n):
            p, o, m = step(p, o, batch_fn(i))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
    return losses, norms, *(TO.leaves(gather_tree(t)) for t in (p, o.m,
                                                               o.v))


MESHES = [(2, 2), (1, 2)]
STEPS = [(arch, remat) for arch in ARCHS6 for remat in ("none", "dots")] \
    + [("zamba2-1.2b", "full")]


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("arch,remat", STEPS)
def test_split_step_is_the_accum_step_to_float32(arch, remat, data, model):
    """Two steps on a (k, m) mesh against ``accum=k`` on one device (k =
    1: the unsplit step): the losses within ``LOSS_ULPS``, the grad norms
    within ``GRAD_REL``, the parameters within ``PARAM_ATOL``, m and v
    within ``MOMENT_REL`` (measured: 37 float32 steps, 2.2e-6, on
    rwkv6's (1, 2) norm; moments 5.4e-6)."""
    got = _run(arch, data, model, remat=remat)
    want = _run(arch, 1, 1, accum=data, remat=remat)
    for a, b in zip(got[0], want[0]):
        assert _ulps(a, b) <= LOSS_ULPS, (a, b)
    for a, b in zip(got[1], want[1]):
        assert abs(float(a) - float(b)) <= GRAD_REL * float(b), (a, b)
    worst = max(float((a - b).abs().max()) for a, b in zip(got[2], want[2]))
    assert worst <= PARAM_ATOL, worst
    for name, gs, ws in (("m", got[3], want[3]), ("v", got[4], want[4])):
        for a, b in zip(gs, ws):
            if b.any():
                assert _rel_rms(a, b) <= MOMENT_REL[name], name
            else:
                assert not a.any(), name


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).double().pow(2).mean().sqrt()
                 / max(float(want.double().pow(2).mean().sqrt()), 1e-30))


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("arch", ARCHS6)
def test_split_gradients_are_the_accum_gradients_to_float32(arch, data,
                                                            model):
    """The gradients a step takes, from a float32 init: each leaf's
    within rel_rms 1e-4 of the ``accum=k`` route's
    (``tests/test_torch_train.py``'s gradient limit). From such an init
    the parameters can move further apart than ``PARAM_ATOL``: where a
    gradient element is rounding noise (RWKV-6's ``channel_mix/w_out``:
    about 1e-9 against AdamW's eps of 1e-8) the first step's update
    m̂ / (√v̂ + eps) follows the noise's sign, by up to the learning
    rate."""
    got, want = [], []
    _run(arch, data, model, init="float32", n=1, grads=got)
    _run(arch, 1, 1, accum=data, init="float32", n=1, grads=want)
    for a, b in zip(got[0], want[0]):
        if b.any():
            assert _rel_rms(a, b) <= 1e-4
        else:
            assert not a.any()


@pytest.mark.parametrize("arch", ARCHS6)
def test_split_step_is_bitwise_across_remat_and_reruns(arch):
    runs = [_run(arch, 2, 2, remat=r)
            for r in ("none", "none", "dots", "full")]
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b"])
def test_restart_onto_the_same_mesh_is_bitwise(arch, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(ttrain, "ARCHS", dict(ARCHS, **{
        arch: dataclasses.replace(ARCHS[arch], dtype="float32")}))
    kw = dict(mesh=cpu_mesh(2, 2), device="cpu", ckpt_every=2, **RUN)
    full = ttrain.train(arch, steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    resumed = ttrain.train(arch, steps=4, ckpt_dir=str(tmp_path / "b"),
                           **kw)
    assert resumed["losses"] == [x for x in full["losses"] if x[0] >= 2]
    for name in sorted(p.name for p in (tmp_path / "a" / "step_4").iterdir()
                       if p.suffix == ".bin"):
        assert ((tmp_path / "a" / "step_4" / name).read_bytes()
                == (tmp_path / "b" / "step_4" / name).read_bytes()), name


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "rwkv6-3b", "zamba2-1.2b",
                                  "whisper-tiny"])
def test_split_step_against_the_reference(arch):
    """One float32 step on a (2, 2) mesh from the reference's parameters
    (perturbed as ``tests/test_torch_train.py`` perturbs them) against
    the reference's jitted ``accum=2`` step: the loss within 1e-5
    relative and every parameter within 4e-5, that file's limits."""
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), dtype="float32",
                               **WIDER.get(arch, {}))
    cfg = _cfg(arch)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, JS.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tree = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(
        a.shape)).astype(np.float32), tree)
    jb = JD.make_batch_fn(jcfg, JShapeSpec("t", 32, 4, "train"), seed=0)(0)
    jp, _, jm = jax.jit(JS.make_train_step(jcfg, remat="none", accum=2))(
        jax.tree.map(jax.numpy.asarray, tree), JO.init(tree), jb)
    tp = convert.lm_params(tree, cfg, dtype=torch.float32)
    sp = place(tp, ShardingRules(cpu_mesh(2, 2)).tree_shardings(tp))
    sp, _, tm = make_train_step(cfg, remat="none")(
        sp, TO.init(sp), {k: torch.from_numpy(np.array(v))
                          for k, v in jb.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    jflat = lm.flatten(jax.tree.map(np.asarray, jp))
    for path, x in lm.flatten(gather_tree(sp)).items():
        np.testing.assert_allclose(x.numpy(), jflat[path], rtol=0,
                                   atol=4e-5, err_msg=path)


# --------------------------------------------------------------- the plan


def test_model_dim_is_the_compute_dimension():
    assert SH.model_dim(P("data", "model", None)) == 1
    assert SH.model_dim(P(None, "model", None), stacked=True) == 1
    assert SH.model_dim(P("model", None, "data"), stacked=True) is None
    assert SH.model_dim(P(("data", "model"), None)) is None
    assert SH.model_dim(P("data", None)) is None
    rules = ShardingRules(cpu_mesh(2, 2))
    for path, shape, want in (("layers/attn/wq", (2, 64, 4, 16), 2),
                              ("layers/attn/wo", (2, 4, 16, 64), 1),
                              ("layers/mlp/b_down", (2, 64), None),
                              ("layers/moe/router", (2, 64, 4), None),
                              ("layers/mamba/conv_x", (2, 4, 128), 2),
                              ("embed/table", (256, 64), 0),
                              ("lm_head", (64, 256), 1)):
        spec = rules.spec_for(path, shape)
        assert SH.model_dim(spec, path.startswith("layers/")) == want, path


@pytest.mark.parametrize("spec", [P("data", None, "model"),
                                  P(None, "model", "data")])
def test_a_position_block_is_gathered_over_the_fsdp_axes(spec):
    """``SplitAtUse``: layer i's block at position j is
    bitwise the leaf's layer i sliced on its ``model`` dimension, in the
    use type, built from the blocks that hold it; a loss over every
    (layer, position) block hands each block's inputs the unsplit leaf's
    gradient; a leaf no rule splits over ``model`` is gathered whole."""
    rng = np.random.default_rng(0)
    mesh = cpu_mesh(2, 2)
    x = torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(np.float32))
    sx = place(x, NamedSharding(mesh, spec))
    d = SH.model_dim(spec, stacked=True)
    at = SplitAtUse(sx, torch.bfloat16, stacked=True)
    width = x.shape[d] // 2
    total = 0
    for i in range(4):
        blocks = at[i]
        assert isinstance(blocks, MS.Blocks) and blocks.n == 2
        assert blocks.dim == d - 1
        for j in range(2):
            got = blocks.block(j)
            want = x[i].narrow(d - 1, j * width, width).to(torch.bfloat16)
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
            total = total + torch.sum(torch.sin(got.float())
                                      * w[i].narrow(d - 1, j * width, width))
        assert torch.equal(blocks.whole(), x[i].to(torch.bfloat16))
    gs = torch.autograd.grad(total, at.inputs)
    leaf = x.clone().requires_grad_()
    ref = torch.autograd.grad(torch.sum(torch.sin(
        leaf.to(torch.bfloat16).float()) * w), leaf)[0]
    index = [sx.indices[k] for k in sx.firsts]
    for (b, j), g in zip(at.slots, gs):
        assert torch.equal(g, ref[index[b]][j])
    plain = place(x, NamedSharding(mesh, P("data", None, None)))
    assert not isinstance(SplitAtUse(plain, torch.float32, stacked=True)[0],
                          MS.Blocks)


def test_psum_adds_in_position_order_and_hands_back_the_gradient():
    rng = np.random.default_rng(4)
    parts = [torch.from_numpy(rng.standard_normal(7).astype(np.float32))
             .requires_grad_() for _ in range(3)]
    got = MS.psum(parts)
    assert torch.equal(got, (parts[0] + parts[1]) + parts[2])
    g = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    for grad in torch.autograd.grad(got, parts, g):
        assert torch.equal(grad, g)
    assert MS.psum(parts[:1]) is parts[0]
