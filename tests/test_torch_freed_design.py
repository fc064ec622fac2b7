"""The reservation scan's two designs, without a card.

Which design runs on CUDA tensors is a pure function of the row length
(``xsim.backfill.freed_design``): "fused" (one launch on the raw tables)
for 1 <= N <= 16384, "presorted" (the scan on rows sorted outside the
kernel) above. On CPU tensors ``freed_matrix`` runs the plain version and
counts no launch of either design.

``_mirror`` repeats the "fused" kernel's steps in numpy (test-only;
nothing on the main path uses it), row by row with the kernel's own
group size: the load in rounds of one slot a thread, each warp's ballot
of its running slots and the prefix of the warps' counts giving each
running slot its compacted index; the order-preserving uint32 key of the
end with -0.0 sent to +0.0; the bitonic network over the 64-bit words
(key << 32 | index) padded with ~0 to the next power of two of at least
64 (the kernel runs the stages within 64-word segments in registers, the
same compare-exchanges in the same order); the cumsum
over each thread's run of sorted positions with its exclusive prefix, the
reverse (min) scan of each thread's first run end and the backward walk;
and the slot-order write. It is held bitwise against the reference's
``_freed_math``, ``_freed_sorted`` and its Pallas kernel in interpret
mode (``freed_matrix(interpret=True)``) on the same numpy inputs. Core
counts are integers below 2**24, so every sum is exact in any order.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.xsim import backfill as jbackfill
from repro_torch.xsim import backfill as tbackfill

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

FUSED_MAX_N = 16384
WARP_ROW_MAX_N = 128   # rows this short take one warp of 32 threads
MAX_THREADS = 1024
MAX_ROUNDS = 16
PAD = np.uint64(0xFFFFFFFFFFFFFFFF)

_jmath = jax.jit(jax.vmap(jbackfill._freed_math))
_jsorted = jax.jit(jax.vmap(jbackfill._freed_sorted))


@pytest.mark.parametrize("n,want", [
    (1, "fused"), (53, "fused"), (256, "fused"), (257, "fused"),
    (2313, "fused"), (FUSED_MAX_N, "fused"), (FUSED_MAX_N + 1, "presorted"),
    (20000, "presorted"), (29056, "presorted"), (0, "presorted")])
def test_freed_design(n, want):
    assert tbackfill.freed_design(n) == want


@pytest.mark.parametrize("b,n", [(3, 1), (4, 53), (2, 300), (2, 2313)])
def test_cpu_tensors_launch_no_design(b, n):
    t = [torch.as_tensor(x) for x in _tables(b, n, seed=n)]
    before = (dict(tbackfill.KERNEL_LAUNCHES),
              dict(tbackfill.DESIGN_LAUNCHES))
    got = tbackfill.freed_matrix(*t)
    assert (tbackfill.KERNEL_LAUNCHES, tbackfill.DESIGN_LAUNCHES) == before
    assert torch.equal(got, tbackfill._freed_sorted(*t))


# ------------------------------------------------------------ the mirror

def _group_size(n: int) -> int:
    """Threads owning a row: a warp for n <= 128, else ceil(n / 4)
    rounded up to warps, at most 1024 (the kernel's launcher)."""
    if n <= WARP_ROW_MAX_N:
        return 32
    return min(MAX_THREADS, -(-(-(-n // 4)) // 32) * 32)


def _keys(e: np.ndarray) -> np.ndarray:
    """The order-preserving uint32 key of each float32 end, -0.0 as +0.0."""
    u = e.astype(np.float32).view(np.uint32).copy()
    u[e == 0.0] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _key_ends(k: np.ndarray) -> np.ndarray:
    u = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32)
    return u.view(np.float32)


def _bitonic(words: np.ndarray) -> np.ndarray:
    """The network over a power-of-two array, stage by stage: pair p of the
    stage with distance j compares words i = 2j·floor(p/j) + p mod j and
    i + j, ascending where i & k == 0."""
    w = words.copy()
    size = w.size
    p = np.arange(size // 2)
    k = 2
    while k <= size:
        j = k >> 1
        while j > 0:
            i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
            a, b = w[i], w[i + j]
            swap = (a > b) == ((i & k) == 0)
            w[i[swap]], w[i[swap] + j] = b[swap], a[swap]
            j >>= 1
        k <<= 1
    return w


def _segment_stages(x0, x1, p0, k):
    """The kernel's ``segment_stages``: a warp's 64-word segment as lanes
    (x0[l] = word p0[l] = 64s + l, x1[l] = word p0[l] + 32), stages j =
    min(k / 2, 32) down to 1: j = 32 within a lane, j <= 16 by the
    partner lane's word (``__shfl_xor_sync``)."""
    lane = np.arange(32)
    if k >= 64:
        swap = (x0 > x1) == ((p0 & k) == 0)
        x0, x1 = np.where(swap, x1, x0), np.where(swap, x0, x1)
    j = (32 if k >= 64 else k) >> 1
    while j > 0:
        lower = (lane & j) == 0
        y0, y1 = x0[lane ^ j], x1[lane ^ j]
        min0 = lower == ((p0 & k) == 0)
        min1 = lower == (((p0 + 32) & k) == 0)
        x0 = np.where(min0 == (y0 < x0), y0, x0)
        x1 = np.where(min1 == (y1 < x1), y1, x1)
        j >>= 1
    return x0, x1


def _kernel_sort(words: np.ndarray) -> np.ndarray:
    """The kernel's order of the same network: k = 64 sorts each segment
    whole in registers; each larger k runs its stages j >= 64 on the whole
    array, then j = 32..1 segment by segment."""
    w = words.copy()
    size = w.size
    p = np.arange(size // 2)
    k = 64
    while k <= size:
        j = k >> 1
        while j >= 64:
            i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
            a, b = w[i], w[i + j]
            swap = (a > b) == ((i & k) == 0)
            w[i[swap]], w[i[swap] + j] = b[swap], a[swap]
            j >>= 1
        for s in range(size // 64):
            p0 = 64 * s + np.arange(32)
            x0, x1 = w[p0], w[p0 + 32]
            kk = 2 if k == 64 else k
            while kk <= k:
                x0, x1 = _segment_stages(x0, x1, p0, kk)
                kk <<= 1
            w[p0], w[p0 + 32] = x0, x1
        k <<= 1
    return w


def _mirror_row(e: np.ndarray, c: np.ndarray, r: np.ndarray) -> np.ndarray:
    n = e.size
    g = _group_size(n)
    rounds = -(-n // g)
    assert rounds <= MAX_ROUNDS
    # 1. load and compact: slot q·g + t of round q; each warp's ballot, the
    # prefix of the warps' counts
    words, cv = [], []
    slot_k = np.full(n, -1)
    total = 0
    for q in range(rounds):
        slots = q * g + np.arange(g)
        run = np.zeros(g, bool)
        run[slots < n] = r[slots[slots < n]]
        ballots = run.reshape(-1, 32)
        counts = ballots.sum(axis=1)
        warp_base = total + np.concatenate([[0], np.cumsum(counts)[:-1]])
        below = np.cumsum(ballots, axis=1) - ballots   # popc(ballot & lt)
        k = (warp_base[:, None] + below).reshape(-1)
        for t in np.flatnonzero(run):
            assert k[t] == len(words)
            slot_k[slots[t]] = k[t]
            words.append((int(_keys(e[slots[t]:slots[t] + 1])[0]) << 32)
                         | int(k[t]))
            cv.append(np.float32(c[slots[t]]))
        total += int(counts.sum())
    R = total
    # the compacted index is the slot's rank among running slots
    np.testing.assert_array_equal(slot_k[r], np.arange(R))
    cv = np.asarray(cv, np.float32)
    # 2. the bitonic network over the padded power of two (at least a
    # 64-word segment; nothing to sort for R <= 1)
    P = 64 if R > 1 else R
    while P < R:
        P <<= 1
    padded = np.full(P, PAD, np.uint64)
    padded[:R] = np.asarray(words, np.uint64)
    w = _kernel_sort(padded)
    np.testing.assert_array_equal(w, _bitonic(padded))
    assert np.all(w[R:] == PAD) and np.all(np.diff(w[:R]) > 0)
    idx = (w[:R] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ends_s = _key_ends((w[:R] >> np.uint64(32)).astype(np.uint32))
    # 3. each thread's run of sorted positions; exclusive prefix; the
    # cumsum at each thread's first run end; reverse min scan; backward walk
    per = -(-R // g) if R else 0
    lo = np.minimum(np.arange(g) * per, R)
    hi = np.minimum(lo + per, R)
    is_last = np.ones(R, bool)
    is_last[:-1] = ends_s[:-1] != ends_s[1:]
    part = np.array([cv[idx[a:b]].sum(dtype=np.float32)
                     for a, b in zip(lo, hi)], np.float32)
    pre = np.concatenate([[0], np.cumsum(part, dtype=np.float32)[:-1]]
                         ).astype(np.float32)
    total_c = np.float32(part.sum(dtype=np.float32))
    first_end = np.full(g, np.inf, np.float32)
    for t in range(g):
        csum = pre[t]
        for i in range(lo[t], hi[t]):
            csum = np.float32(csum + cv[idx[i]])
            if is_last[i]:
                first_end[t] = csum
                break
    after = np.minimum.accumulate(first_end[::-1])[::-1]
    acc_in = np.concatenate([after[1:], [np.inf]]).astype(np.float32)
    val = cv.copy()
    for t in range(g):
        acc, csum = acc_in[t], np.float32(pre[t] + part[t])
        for i in range(hi[t] - 1, lo[t] - 1, -1):
            if is_last[i]:
                acc = csum
            csum = np.float32(csum - cv[idx[i]])
            val[idx[i]] = acc
    # 4. slot order: a running slot its entry's value, others the total
    out = np.full(n, total_c, np.float32)
    out[r] = val[slot_k[r]]
    return out


def _mirror(ends, cores, running) -> np.ndarray:
    return np.stack([_mirror_row(e, c, r)
                     for e, c, r in zip(ends, cores, running)])


def _tables(b: int, n: int, seed: int, *, share: float = 0.5,
            ties: float = 0.25, inf: float = 0.1):
    """Random (B, N) tables: integer cores, ends on a coarse grid (so ties
    arise) with some forced to one value and some +inf, a running share,
    and row 0 all idle when B > 1."""
    rng = np.random.default_rng(seed)
    ends = (rng.integers(0, 4 * n + 8, (b, n)) * 2.5).astype(np.float32)
    ends[rng.random((b, n)) < ties] = 5000.0
    ends[rng.random((b, n)) < inf] = np.inf
    cores = rng.integers(1, 50, (b, n)).astype(np.float32)
    running = rng.random((b, n)) < share
    if b > 1:
        running[0] = False
    return ends, cores, running


def _edge(name: str):
    """The named edge case as (ends, cores, running)."""
    rng = np.random.default_rng(len(name))
    if name == "n1":
        return (np.array([[3.0], [np.inf], [7.0]], np.float32),
                np.array([[4.0], [9.0], [2.0]], np.float32),
                np.array([[True], [True], [False]]))
    if name == "n_not_multiple_of_32":
        return _tables(3, 45, 1)
    if name in ("r_power_of_two", "r_power_of_two_plus_one"):
        n, want = 300, 128 + (name == "r_power_of_two_plus_one")
        ends, cores, running = _tables(2, n, 2, share=0)
        for row in running:
            row[rng.choice(n, want, replace=False)] = True
        assert (running.sum(axis=1) == want).all()
        return ends, cores, running
    if name == "all_idle":
        e, c, _ = _tables(2, 70, 3)
        return e, c, np.zeros_like(e, bool)
    if name == "all_running":
        e, c, _ = _tables(2, 300, 4)
        return e, c, np.ones_like(e, bool)
    if name == "every_end_tied":
        e, c, r = _tables(3, 100, 5, share=0.7)
        return np.full_like(e, 42.0), c, r
    if name == "inf_ends_running":
        e, c, r = _tables(2, 257, 6, share=0.8, inf=0.3)
        return e, c, r
    if name == "signed_zeros":
        e, c, r = _tables(2, 64, 7, share=0.9)
        e[:, ::3] = 0.0
        e[:, 1::3] = -0.0
        return e, c, r
    if name == "fused_limit":
        return _tables(1, FUSED_MAX_N, 8, share=0.3)
    raise KeyError(name)


EDGES = ["n1", "n_not_multiple_of_32", "r_power_of_two",
         "r_power_of_two_plus_one", "all_idle", "all_running",
         "every_end_tied", "inf_ends_running", "signed_zeros",
         "fused_limit"]
# the O(N²) reference holds an (N, N) table a row: 1 GiB at the limit
MATH_MAX_N = 4096


def _assert_against_reference(ends, cores, running):
    got = _mirror(ends, cores, running)
    want = np.asarray(_jsorted(ends, cores, running))
    np.testing.assert_array_equal(got, want)
    if ends.shape[1] <= MATH_MAX_N:
        np.testing.assert_array_equal(
            got, np.asarray(_jmath(ends, cores, running)))
    np.testing.assert_array_equal(got, np.asarray(
        jbackfill.freed_matrix(ends, cores, running, interpret=True)))
    # and the port's plain version, which the card holds the kernel to
    t = [torch.as_tensor(x) for x in (ends, cores, running)]
    np.testing.assert_array_equal(got, tbackfill._freed_sorted(*t).numpy())


@pytest.mark.parametrize("name", EDGES)
def test_mirror_bitwise_on_edge_cases(name):
    _assert_against_reference(*_edge(name))


@pytest.mark.parametrize("b,n", [(4, 53), (4, 73), (4, 153), (2, 2313)])
def test_mirror_bitwise_at_the_grid_shapes(b, n):
    _assert_against_reference(*_tables(b, n, seed=100 + n, share=0.3))


def test_keys_preserve_order_and_merge_signed_zeros():
    x = np.array([-np.inf, -3e38, -1.5, -1e-45, -0.0, 0.0, 1e-45, 2.0,
                  3e38, np.inf], np.float32)
    k = _keys(x)
    assert k[4] == k[5]
    assert np.all(np.diff(k.astype(np.int64)[[0, 1, 2, 3, 5, 6, 7, 8, 9]])
                  > 0)
    np.testing.assert_array_equal(_key_ends(k), np.where(x == 0, 0.0, x))
    assert np.signbit(_key_ends(k)[4]) == 0


# hypothesis draws a row length from these (few shapes: each compiles the
# reference once), a running share, a share of ties and of +inf ends
HYP_NS = (1, 2, 31, 32, 33, 64, 100, 255, 256, 257, 511, 1000)


@settings(max_examples=30, deadline=None)
@given(n_i=st.integers(0, len(HYP_NS) - 1), share=st.floats(0.0, 1.0),
       ties=st.floats(0.0, 1.0), inf=st.floats(0.0, 0.3),
       seed=st.integers(0, 2**31 - 1))
def test_mirror_bitwise_property(n_i, share, ties, inf, seed):
    ends, cores, running = _tables(2, HYP_NS[n_i], seed, share=share,
                                   ties=ties, inf=inf)
    _assert_against_reference(ends, cores, running)
