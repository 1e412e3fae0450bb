"""Fault-tolerant checkpointing: npz shards + msgpack manifest.

The JAX package's checkpoint format (``repro.checkpoint``), written and
read with numpy and torch, so each package reads the other's files:

  * **Layout**: ``step_XXXXXXXX/{arrays.npz, manifest.msgpack}``.  Array
    ``arr_i`` is the i-th leaf of the saved tree in JAX's leaf order (dict
    keys sorted, lists and tuples in order, ``None`` no leaf); the
    manifest holds ``step``, ``n_arrays``, ``treedef`` (informational),
    ``time``, ``extra``, each array's ``dtypes`` name and its CRC32
    (``checksums``).  bfloat16 and float8 arrays are stored as their raw
    ``uint16`` / ``uint8`` bits and restored by the manifest's dtype name.
  * **Atomic**: writes go to ``step_XXXXXXXX.tmp/``, each file is fsynced,
    then the directory is renamed and its parent fsynced — a process dying
    mid-write can never corrupt the latest checkpoint.  Restart picks the
    newest *complete* step.
  * **Async**: ``CheckpointManager.save_async`` copies the tree to host
    memory synchronously and writes it on a daemon thread.
  * **Retention**: keeps the last ``keep`` checkpoints; older ones are
    deleted after a successful save.

The manifest is written by the package's own msgpack codec
(`repro_torch.checkpoint._msgpack`), byte for byte what ``msgpack.packb``
writes.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack as msgpack

# dtypes numpy cannot hold: stored as raw bits, named in the manifest
_BITS_DTYPES = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.int8, np.uint8),
}
_BY_NAME = {name: dt for dt, (name, _, _) in _BITS_DTYPES.items()}


class CorruptCheckpoint(RuntimeError):
    """The checkpoint on disk fails verification: unreadable manifest/npz,
    an array checksum mismatch, or a missing member.  Typed so recovery
    code can fall back to an older step instead of dying on a cold numpy/
    zipfile error."""


def _array_crc(a: np.ndarray) -> int:
    """Content checksum of one stored (encoded) array: CRC32 of its
    C-order bytes, read in place."""
    return zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"))


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename within it is durable (POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                           # pragma: no cover (platform)
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host(x, copy: bool = False) -> Tuple[np.ndarray, str]:
    """One leaf as (stored host array, dtype name): a device tensor is
    copied to the host once, host memory is shared unless ``copy``;
    bfloat16 / float8 become their raw bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if copy and not t.is_cuda:
            t = t.clone()
        bits = _BITS_DTYPES.get(t.dtype)
        if bits is not None:
            name, as_int, as_np = bits
            return t.view(as_int).cpu().numpy().view(as_np), name
        a = t.cpu().numpy()
    else:
        a = np.array(x, copy=True) if copy else np.asarray(x)
    return a, str(a.dtype)


def _decode(a: np.ndarray, dtype_name: str):
    """A stored array back to its dtype: numpy for numpy dtypes, a CPU
    tensor for bfloat16 / float8 (raw bits reinterpreted)."""
    if dtype_name in _BY_NAME and a.dtype.name != dtype_name:
        signed = a.view(np.int16 if a.itemsize == 2 else np.int8)
        return torch.from_numpy(np.ascontiguousarray(signed)).view(
            _BY_NAME[dtype_name])
    return a


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _leaves(tree) -> Tuple[List[Any], str]:
    """(leaves in JAX's flatten order, the tree's ``PyTreeDef(...)``
    string): dicts by sorted key, lists, tuples and ``NamedTuple``s in
    order, ``None`` an empty subtree, anything else a leaf.  A
    ``NamedTuple`` prints as JAX prints it, ``CustomNode(namedtuple[Name],
    [...])``."""
    leaves: List[Any] = []

    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            parts = [f"{k!r}: {walk(t[k])}" for k in sorted(t)]
            return "{" + ", ".join(parts) + "}"
        if isinstance(t, (list, tuple)):
            parts = [walk(v) for v in t]
            if _is_namedtuple(t):
                return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                        + ", ".join(parts) + "])")
            if isinstance(t, list):
                return "[" + ", ".join(parts) + "]"
            return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") \
                + ")"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(tree, leaves: List[Any]):
    """``tree`` with its leaves replaced, in ``_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _flatten(tree, copy: bool = False
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, str], str]:
    """(``arr_i`` -> stored host array, ``arr_i`` -> dtype name, treedef)."""
    leaves, treedef = _leaves(tree)
    arrs, dtypes = {}, {}
    for i, x in enumerate(leaves):
        arrs[f"arr_{i}"], dtypes[f"arr_{i}"] = _host(x, copy)
    return arrs, dtypes, treedef


def _write(ckpt_dir: str, step: int, arrs: Dict[str, np.ndarray],
           dtypes: Dict[str, str], treedef: str, extra: Optional[dict],
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # npz through an explicit handle so it can be fsync'd: np.savez(path)
    # alone leaves the array bytes in the page cache, and a crash after the
    # rename could surface a "complete" checkpoint with torn arrays
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrs)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "n_arrays": len(arrs),
        "treedef": treedef,
        "time": time.time(),
        "extra": extra or {},
        "dtypes": dtypes,
        # per-array content CRCs: load verifies them, so silent on-disk
        # corruption becomes a typed CorruptCheckpoint (recovery falls back
        # to the previous step) instead of wrong search results
        "checksums": {k: _array_crc(v) for k, v in arrs.items()},
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)                  # make the rename itself durable

    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically save ``tree`` (nested dict / list / tuple of tensors or
    arrays) under ``ckpt_dir/step_{step:08d}``."""
    arrs, dtypes, treedef = _flatten(tree)
    return _write(ckpt_dir, step, arrs, dtypes, treedef, extra, keep)


def save_arrays(ckpt_dir: str, step: int, arrays: Dict[str, Any], *,
                extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically save a *named* flat dict of tensors or arrays
    (self-describing restore).

    `save_checkpoint` needs a matching target tree at restore time;
    serving-side state (e.g. a built retrieval index) has none on a fresh
    process, so the names are recorded in the manifest and `load_arrays`
    reconstructs the dict without a target.  Same atomic tmp-dir + fsynced
    manifest protocol.
    """
    named = dict(sorted(arrays.items()))
    extra = {"array_names": list(named), **(extra or {})}
    return save_checkpoint(ckpt_dir, step, named, extra=extra, keep=keep)


def _read_step(path: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Read + verify one checkpoint dir; returns (manifest, raw arrays).

    Every failure mode — unreadable manifest, bad zip, missing member,
    checksum mismatch — raises ``CorruptCheckpoint``, so callers can treat
    "this step is unusable" uniformly and fall back to an older one.
    """
    try:
        with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
            manifest = msgpack.unpackb(f.read())
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrs = {k: z[k] for k in z.files}
    except Exception as e:                 # zipfile/msgpack/OSError/KeyError
        raise CorruptCheckpoint(f"{path}: unreadable checkpoint: {e}") from e
    n = manifest.get("n_arrays")
    if n is not None and n != len(arrs):
        raise CorruptCheckpoint(
            f"{path}: manifest promises {n} arrays, npz holds {len(arrs)}")
    checksums = manifest.get("checksums")
    if checksums:                          # absent on pre-checksum ckpts
        for key, want in checksums.items():
            got = arrs.get(key)
            if got is None:
                raise CorruptCheckpoint(f"{path}: missing array {key!r}")
            if _array_crc(got) != want:
                raise CorruptCheckpoint(
                    f"{path}: checksum mismatch on {key!r} — the array "
                    f"bytes on disk are corrupt")
    return manifest, arrs


def load_arrays(ckpt_dir: str, *, step: Optional[int] = None):
    """Restore a `save_arrays` checkpoint without a target tree.

    Returns (name -> array dict, manifest ``extra`` dict, step), or
    (None, None, None) when no checkpoint exists.  Arrays are numpy,
    except bfloat16 / float8 ones, which numpy cannot hold: those are CPU
    tensors.  Raises ``CorruptCheckpoint`` when the step exists but fails
    verification.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None, None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest, arrs = _read_step(path)
    extra = manifest.get("extra", {})
    names = extra.get("array_names")
    if names is None:
        raise ValueError(
            f"{path} was not written by save_arrays (no array_names); "
            f"use restore_checkpoint with a target tree")
    dtypes = manifest.get("dtypes", {})
    # flatten order of a dict is sorted-key order — the order save_arrays
    # fixed by sorting the names
    arrays = {
        name: _decode(arrs[f"arr_{i}"], dtypes.get(f"arr_{i}",
                                                   str(arrs[f"arr_{i}"].dtype)))
        for i, name in enumerate(names)
    }
    return arrays, extra, step


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.msgpack")):
                out.append(int(name[5:]))
    return sorted(out)  # listdir order is filesystem-dependent


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _as_tensor(a, like, device) -> torch.Tensor:
    """A restored array as a tensor of ``like``'s dtype on ``device``
    (``like``'s device when None)."""
    # ascontiguousarray makes a 0-d array 1-d: the shape is put back
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a)).reshape(a.shape)
    if isinstance(like, torch.Tensor):
        dtype, dev = like.dtype, like.device
    else:
        dtype = torch.from_numpy(np.zeros(0, np.asarray(like).dtype)).dtype
        dev = torch.device("cpu")
    return t.to(device=dev if device is None else device, dtype=dtype)


def restore_checkpoint(ckpt_dir: str, target_tree, *,
                       step: Optional[int] = None, device=None):
    """Restore into the structure of ``target_tree`` (values replaced).

    Each leaf comes back as a tensor of the target leaf's dtype, on
    ``device`` (the target tensor's device when None; the CPU for a numpy
    target).  Returns (tree, step) or (None, None) when no checkpoint
    exists.
    """
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest, raw = _read_step(path)
    dtypes = manifest.get("dtypes", {})
    arrs = {k: _decode(v, dtypes.get(k, str(v.dtype)))
            for k, v in raw.items()}
    leaves, _ = _leaves(target_tree)
    if len(leaves) != len(arrs):
        raise ValueError(
            f"checkpoint has {len(arrs)} arrays, target expects {len(leaves)}")
    new_leaves = []
    for i, tgt in enumerate(leaves):
        a = arrs[f"arr_{i}"]
        if tuple(a.shape) != tuple(tgt.shape):
            raise ValueError(f"arr_{i}: {tuple(a.shape)} vs "
                             f"{tuple(tgt.shape)}")
        new_leaves.append(_as_tensor(a, tgt, device))
    return _unflatten(target_tree, new_leaves), step


class CheckpointManager:
    """Async save + restart-aware restore."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree, *, extra: Optional[dict] = None):
        """Copy to host now; write on a daemon thread."""
        self.wait()
        # copied to host now, so the caller may go on mutating the tree
        arrs, dtypes, treedef = _flatten(tree, copy=True)

        def _write_thread():
            try:
                _write(self.ckpt_dir, step, arrs, dtypes, treedef, extra,
                       self.keep)
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write_thread, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, target_tree, *, device=None):
        return restore_checkpoint(self.ckpt_dir, target_tree, device=device)
