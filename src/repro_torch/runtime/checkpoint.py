"""Checkpoint save and restore of trees of tensors (port of
``repro.runtime.checkpoint``), in the reference's on-disk format: a
checkpoint written by either package restores in the other.

Layout: <dir>/step_<n>/
  manifest.json            — step, codec, and per leaf its name, shape,
                             dtype, CRC32 and payload size
  <leaf-name>.bin          — compressed little-endian array bytes

A tree is a dict (keys in sorted order), a tuple or list, a NamedTuple
(fields in order) or a leaf: a tensor on any device, a numpy array or a
numpy scalar. Leaf names are the reference's (``jax.tree_util`` key paths
joined by ``_``: a dict key as itself, a NamedTuple field as ``.field``, a
sequence index as its number), so the ASA server's table leaves are
``table_.log_p`` … ``table_.key``. The port holds PRNG keys as int64
tensors of uint32 values; an int64 leaf is stored as uint32 (the values
are checked to fit), and a uint32 leaf restores as int64, as
``convert.tensor`` carries them. A bfloat16 leaf is stored as its raw
2-byte words with the manifest dtype ``"bfloat16"``, as the reference
(through ``ml_dtypes``) writes it, and restores as a bfloat16 tensor
(numpy needs no ``ml_dtypes`` for it). A leaf may also be a
``parallel.sharding.ShardedTensor``: it is gathered to the host in the
caller's thread and written whole, the reference's shape-canonical
format, and ``restore(shardings=)`` places each leaf by its sharding, on
whatever mesh that sharding names. On the mesh of a process group (one
process a position, ``parallel.dist``) every rank calls ``save`` or
``save_async``: the split leaves are gathered to rank 0
(``ShardedTensor.gather_on``), rank 0 alone writes, and every rank
returns (``save``, or the handle's ``join``) once rank 0 has published
the step, or raises if it failed; ``restore(shardings=)`` has every rank
read the file and keep its own shard.

Compression is zstd when the ``zstandard`` package is installed and the
stdlib's ``zlib`` otherwise; the manifest records the codec, and a zstd
checkpoint read where ``zstandard`` is missing raises.

* **Atomic publish**: leaves land in ``_tmp_step_<n>`` first, the
  manifest last, then the directory is renamed to ``step_<n>``, so a
  half-written checkpoint is never restorable; a reused ``_tmp_step_<n>``
  (a save of that step died mid-write) is cleared of its files first.
  Saves of one step into one directory are serialised within the process
  (a lock per target directory): two of them would otherwise share the
  temporary directory, and one could clear or rename it under the other.
* **Parallel codec**: the leaves are compressed and written, and read
  and decompressed, by a pool of threads (the codecs release the GIL),
  one leaf a task; the bytes are those of a sequential save.
* **Async save**: :func:`save_async` copies the tree to the host in the
  caller's thread (the device reads queued together, one synchronisation,
  host arrays copied so later mutation cannot reach the snapshot) and
  writes in a background thread; its :class:`AsyncSave` handle re-raises
  a background failure from ``result()``/``join()``.
* **Integrity**: the manifest records a CRC32 of each compressed
  payload. :func:`restore` raises :class:`CheckpointCorruptError` on a
  mismatch or a missing leaf, and ``latest_step(..., verified=True)``
  returns the newest step that passes :func:`verify_step`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.parallel import dist
from repro_torch.parallel.sharding import ShardedTensor, device_put

try:
    import zstandard
except ModuleNotFoundError:
    zstandard = None

M32 = 0xFFFFFFFF


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (CRC mismatch, missing
    leaf file, or an unreadable manifest). ``latest_step(verified=True)``
    lets callers fall back to the previous good step instead."""


def _compressor(level: int):
    if zstandard is not None:
        # a compressor a call: one instance is not safe across threads
        return "zstd", lambda data: zstandard.ZstdCompressor(
            level=level).compress(data)
    # zstd accepts levels up to 22; zlib tops out at 9
    return "zlib", lambda data: zlib.compress(data, min(level, 9))


def _pool_map(fn, items: list) -> list:
    """``[fn(x) for x in items]`` on a pool of threads, in order."""
    workers = min(len(items), os.cpu_count() or 1, 8)
    if workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


def _decompress(codec: str, payload: bytes) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the 'zstandard' "
                "package is not installed in this environment")
        return zstandard.ZstdDecompressor().decompress(payload)
    if codec == "zlib":
        return zlib.decompress(payload)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic,
                          ShardedTensor))


def _leaf_paths(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """(name, leaf) pairs in the reference's flattening order."""
    if _is_leaf(tree):
        return [("_".join(prefix), tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f, v in zip(tree._fields, tree)
                for p in _leaf_paths(v, prefix + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, prefix + (str(i),))]
    raise TypeError(f"checkpoint: unsupported leaf {type(tree).__name__} "
                    f"at {'_'.join(prefix) or '<root>'}")


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if _is_leaf(tree):
        return next(leaves)
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    return type(tree)(_rebuild(v, leaves) for v in tree)


BF16 = "bfloat16"


def _disk_array(leaf) -> tuple[np.ndarray, str]:
    """A host leaf as the array the reference's format stores, and its
    manifest dtype (a bfloat16 tensor as its raw 2-byte words)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype == np.int64:
        if arr.size and (arr.min() < 0 or arr.max() > M32):
            raise ValueError("checkpoint: an int64 leaf holds values "
                             "outside uint32 (only PRNG keys are int64)")
        arr = arr.astype(np.uint32)
    return arr, str(arr.dtype)


def _groups(tree):
    """The mesh groups of ``tree``'s leaves split over a process group's
    mesh, or None."""
    return next((x.sharding.mesh.groups for _, x in _leaf_paths(tree)
                 if isinstance(x, ShardedTensor) and x.local is not None),
                None)


def _host_copy(tree):
    """The tree on the host: tensors copied without a synchronisation
    each (to pinned memory from a CUDA device), then one synchronisation
    per device; host arrays copied. A tree split over a process group's
    mesh is gathered to rank 0 (every rank calls this), and the other
    ranks get None."""
    leaves = [leaf for _, leaf in _leaf_paths(tree)]
    groups = _groups(tree)
    root = groups is None or groups.rank == 0
    out, devices = [], set()
    for leaf in leaves:
        if isinstance(leaf, ShardedTensor):
            leaf = leaf.gather() if leaf.local is None else leaf.gather_on(0)
        if not root:
            continue
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            devices.add(leaf.device)
            out.append(leaf.detach().to("cpu", non_blocking=True))
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf.detach().clone())
        else:
            out.append(np.array(leaf, copy=True))
    for d in devices:
        torch.cuda.synchronize(d)
    return _rebuild(tree, iter(out)) if root else None


_STEP_LOCKS: dict[str, threading.Lock] = {}
_STEP_LOCKS_GUARD = threading.Lock()


def _step_lock(final: Path) -> threading.Lock:
    """The process-wide lock of one target step directory."""
    key = str(final.resolve())
    with _STEP_LOCKS_GUARD:
        return _STEP_LOCKS.setdefault(key, threading.Lock())


def save(tree, directory: str | Path, step: int, *, level: int = 3) -> Path:
    """Write ``tree`` as step ``step`` under ``directory``; returns the
    published ``step_<step>`` directory (see the module docstring for a
    tree split over processes)."""
    groups = _groups(tree)
    if groups is not None:
        host = _host_copy(tree)
        exc = None
        if host is not None:
            try:
                save(host, directory, step, level=level)
            except BaseException as e:     # raised below, after the others
                exc = e                    # have heard of it
        _published(groups, step, exc is None)
        if exc is not None:
            raise exc
        return Path(directory) / f"step_{step}"
    if any(isinstance(x, ShardedTensor) for _, x in _leaf_paths(tree)):
        tree = _host_copy(tree)
    directory = Path(directory)
    tmp = directory / f"_tmp_step_{step}"
    final = directory / f"step_{step}"
    with _step_lock(final):
        if tmp.exists():
            # a previous save of this step died mid-write: clear its
            # leftovers so orphaned leaf files can't ride along under the
            # new manifest
            for stale in tmp.iterdir():
                if stale.is_file():
                    stale.unlink()
        tmp.mkdir(parents=True, exist_ok=True)
        codec_name, compress = _compressor(level)

        def write(item) -> dict:
            name, leaf = item
            arr, dtype = _disk_array(leaf)
            payload = compress(np.ascontiguousarray(arr).tobytes())
            (tmp / f"{name}.bin").write_bytes(payload)
            return {
                "name": name, "shape": list(arr.shape), "dtype": dtype,
                # CRC of the compressed payload as written: what
                # verify_step/restore re-hash straight off disk
                "crc32": zlib.crc32(payload) & M32,
                "nbytes": len(payload),
            }

        manifest = {"step": step, "codec": codec_name,
                    "leaves": _pool_map(write, _leaf_paths(tree))}
        # atomic publish: manifest written into tmp, then dir renamed
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    return final


def _published(groups, step: int, ok: bool) -> None:
    """Every rank learns whether rank 0 published ``step``; a rank other
    than 0 raises where it did not."""
    if not dist.agree(ok, groups.world) and groups.rank != 0:
        raise RuntimeError(f"rank 0 failed to publish checkpoint step "
                           f"{step}")


class AsyncSave:
    """Handle for a background ``save``; failures re-raise in the caller.

    ``join()``/``result()`` block for the writer thread and re-raise
    whatever it raised; ``result()`` returns the published checkpoint
    directory. For a tree split over processes (``groups``) every rank
    holds a handle, rank 0's thread writes, and the first ``join`` of
    each rank returns once rank 0's has published the step."""

    def __init__(self, thread: threading.Thread, step: int, groups=None):
        self._thread = thread
        self.step = step
        self._exc: BaseException | None = None
        self._path: Path | None = None
        self._groups = groups

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"async save of step {self.step} still running")
        if self._groups is not None:
            groups, self._groups = self._groups, None
            try:
                _published(groups, self.step, self._exc is None)
            except RuntimeError as e:
                self._exc = e
        if self._exc is not None:
            raise self._exc

    def result(self, timeout: float | None = None) -> Path:
        self.join(timeout)
        assert self._path is not None
        return self._path


def save_async(tree, directory: str | Path, step: int, *,
               level: int = 3) -> AsyncSave:
    """Copy the tree to the host now (in the caller's thread, one
    synchronisation a device), compress and write it in a background
    thread. Returns an :class:`AsyncSave` whose ``result()``/``join()``
    re-raise any background failure."""
    groups = _groups(tree)
    host_tree = _host_copy(tree)
    handle: AsyncSave

    def _work():
        if host_tree is None:      # a rank other than 0: rank 0 writes
            handle._path = Path(directory) / f"step_{step}"
            return
        try:
            handle._path = save(host_tree, directory, step, level=level)
        except BaseException as e:  # surfaced via join()/result()
            handle._exc = e

    t = threading.Thread(target=_work, daemon=True)
    handle = AsyncSave(t, step, groups)
    t.start()
    return handle


def verify_step(directory: str | Path, step: int) -> list[str]:
    """Integrity-check one published checkpoint; returns the violations
    (empty ⇒ verified): manifest readable, every leaf file present, and,
    where the manifest records CRCs, each payload hashing to its
    ``crc32``."""
    d = Path(directory) / f"step_{step}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"step {step}: unreadable manifest: {e}"]
    errs: list[str] = []
    for meta in manifest.get("leaves", []):
        name = meta.get("name", "?")
        path = d / f"{name}.bin"
        try:
            payload = path.read_bytes()
        except OSError as e:
            errs.append(f"step {step}: leaf {name!r} unreadable: {e}")
            continue
        want = meta.get("crc32")
        if want is None:
            continue  # pre-CRC checkpoint: presence is all we can check
        got = zlib.crc32(payload) & M32
        if got != int(want):
            errs.append(f"step {step}: leaf {name!r} CRC mismatch "
                        f"(manifest {int(want):#010x}, disk {got:#010x})")
    return errs


def latest_step(directory: str | Path,
                verified: bool = False) -> int | None:
    """Newest published step (manifest present). With ``verified=True``
    steps are scanned newest first and the first one passing
    :func:`verify_step` wins."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.glob("step_*"):
        if (d / "manifest.json").exists():
            try:
                steps.append(int(d.name.split("_")[1]))
            except ValueError:
                continue
    if not verified:
        return max(steps) if steps else None
    for step in sorted(steps, reverse=True):
        if not verify_step(directory, step):
            return step
    return None


def _sharding_leaves(example, shardings) -> list:
    """The leaves of ``shardings`` (a tree of ``NamedSharding`` shaped as
    ``example``), in ``example``'s leaf order."""
    if _is_leaf(example):
        return [shardings]
    if example is None:
        return []
    if isinstance(example, dict):
        return [s for k in sorted(example)
                for s in _sharding_leaves(example[k], shardings[k])]
    return [s for v, sh in zip(example, shardings)
            for s in _sharding_leaves(v, sh)]


def restore(example_tree, directory: str | Path, step: int, *,
            device: str | torch.device = DEFAULT_DEVICE, shardings=None):
    """Restore step ``step`` into the structure of ``example_tree``: every
    leaf comes back as a tensor on ``device`` (uint32 leaves as int64),
    or, with ``shardings`` (a tree of ``NamedSharding`` shaped as
    ``example_tree``), placed by its sharding (``device_put``: split over
    that sharding's mesh, whatever mesh it was saved from; on a process
    group's mesh each rank reads the file and keeps its own shard)."""
    if shardings is not None:
        host = restore(example_tree, directory, step, device="cpu")
        return _rebuild(example_tree, iter(
            device_put(t, sh) for (_, t), sh in zip(
                _leaf_paths(host),
                _sharding_leaves(example_tree, shardings))))
    dev = resolve_device(device)
    directory = Path(directory) / f"step_{step}"
    try:
        manifest = json.loads((directory / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"step {step}: unreadable manifest: {e}") from e
    codec_name = manifest.get("codec", "zstd")  # pre-codec: zstd
    by_name = {m["name"]: m for m in manifest["leaves"]}

    def read(name: str) -> torch.Tensor:
        meta = by_name[name]
        try:
            payload = (directory / f"{name}.bin").read_bytes()
        except OSError as e:
            raise CheckpointCorruptError(
                f"step {step}: leaf {name!r} unreadable: {e}") from e
        want = meta.get("crc32")
        if want is not None:
            got = zlib.crc32(payload) & M32
            if got != int(want):
                raise CheckpointCorruptError(
                    f"step {step}: leaf {name!r} CRC mismatch (manifest "
                    f"{int(want):#010x}, disk {got:#010x}); use "
                    f"latest_step(verified=True) to fall back to the "
                    f"newest verified step")
        raw = bytearray(_decompress(codec_name, payload))
        if meta["dtype"] == BF16:
            if not raw:
                return torch.empty(meta["shape"], dtype=torch.bfloat16)
            return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(
                meta["shape"])
        arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(
            meta["shape"])
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        return torch.from_numpy(arr)

    host = _pool_map(read, [n for n, _ in _leaf_paths(example_tree)])
    return _rebuild(example_tree, iter(t.to(dev) for t in host))
