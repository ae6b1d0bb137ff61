"""Checkpointing: npz leaf files, atomic commit, async save and
resume-from-latest (port of ``repro.checkpoint.manager``, one process).

Layout, the reference's:
  <dir>/step_<n>/proc_<i>.npz     flattened leaves (leaf_00000 ...)
  <dir>/step_<n>/meta.json        step, structure description, leaf count
  <dir>/step_<n>/COMMITTED        written last; uncommitted dirs are ignored

Fault-tolerance contract: save is atomic (tmp dir + rename + marker), so a
kill at any point leaves either the previous or the new checkpoint valid.

A checkpoint written by either package restores in the other. Trees
flatten in JAX's order for the same structure (:func:`tree_flatten`:
NamedTuple and tuple/list children in order, dict children by sorted key,
``None`` holds no leaf), and every leaf is saved as a numpy array: a
tensor through the host, bfloat16 as its uint16 bits. ``meta.json``'s
``treedef`` field holds :func:`describe`'s text where ``repro`` writes
``str(treedef)``; neither package's ``restore`` reads it (both take the
structure from ``like``). Restored leaves take the dtype and device of
``like``'s leaves, bit patterns kept: ``repro``'s uint32 codes land in the
port's int32 code tensors and back.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


# ---------------------------------------------------------------------------
# trees: JAX's flatten order over the port's containers
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    """(children, rebuild) of a container node, else None for a leaf."""
    if _is_namedtuple(x):
        return list(x), lambda cs: type(x)(*cs)
    if isinstance(x, (tuple, list)):
        return list(x), lambda cs: type(x)(cs)
    if isinstance(x, dict):
        keys = sorted(x)
        return [x[k] for k in keys], lambda cs: dict(zip(keys, cs))
    return None


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, structure) in ``jax.tree_util.tree_flatten``'s order."""
    leaves: list = []

    def walk(x):
        if x is None:
            return None
        node = _children(x)
        if node is None:
            leaves.append(x)
            return "*"
        cs, rebuild = node
        return (rebuild, [walk(c) for c in cs])

    return leaves, walk(tree)


def tree_unflatten(structure: Any, leaves: list) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == "*":
            return next(it)
        rebuild, cs = s
        return rebuild([build(c) for c in cs])

    return build(structure)


def describe(tree: Any) -> str:
    """A one-line text of ``tree``'s structure (``*`` per leaf), what
    ``meta.json`` records."""
    if tree is None:
        return "None"
    node = _children(tree)
    if node is None:
        return "*"
    cs, _ = node
    inner = ", ".join(describe(c) for c in cs)
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    return f"[{inner}]" if isinstance(tree, list) else f"({inner})"


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _to_savable(leaf) -> np.ndarray:
    """A leaf as the numpy array npz stores (bfloat16 as uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name in ("bfloat16",
                                                   "float8_e4m3fn",
                                                   "float8_e5m2"):
        return arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8)
    return arr


def _from_savable(arr: np.ndarray, ref, device=None):
    """A loaded array in the dtype, shape and place of ``like``'s leaf."""
    if isinstance(ref, torch.Tensor):
        dev = ref.device if device is None else torch.device(device)
        if ref.dtype == torch.bfloat16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 .copy()).view(torch.bfloat16)
            return t.reshape(ref.shape).to(dev)
        want = torch.empty((), dtype=ref.dtype).numpy().dtype
        return torch.from_numpy(_as_dtype(arr, want).reshape(
            tuple(ref.shape)).copy()).to(dev)
    ref_arr = np.asarray(ref)
    return _as_dtype(arr, ref_arr.dtype).reshape(ref_arr.shape)


def _as_dtype(arr: np.ndarray, dtype) -> np.ndarray:
    """Same-width integers keep their bits (uint32 <-> int32 codes)."""
    dtype = np.dtype(dtype)
    if (arr.dtype != dtype and arr.dtype.kind in "ui" and dtype.kind in "ui"
            and arr.dtype.itemsize == dtype.itemsize):
        return np.ascontiguousarray(arr).view(dtype)
    return np.asarray(arr, dtype=dtype)


class SaveHandle:
    """Handle for an async ``save``. ``result()`` (alias ``join()``) blocks
    until the writer thread finishes and RE-RAISES any exception it hit."""

    def __init__(self, thread: threading.Thread, errbox: dict):
        self._thread = thread
        self._errbox = errbox

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        exc = self._errbox.get("exc")
        if exc is not None:
            raise exc

    join = result

    def is_alive(self) -> bool:
        return self._thread.is_alive()


def save(root: str, step: int, tree: Any, process_index: int = 0,
         blocking: bool = True,
         fault_hook: Optional[Any] = None) -> Optional[SaveHandle]:
    """Atomically write ``tree`` (a tree of tensors or arrays) for
    ``step``. The leaves are copied to the host before this returns, also
    for a non-blocking save.

    ``fault_hook`` (zero-arg callable) runs mid-write — after the tmp dir
    is populated, before the rename — i.e. at the point a kill leaves an
    orphaned ``step_*.tmp*`` dir and the PREVIOUS committed step intact.
    Non-blocking saves return a ``SaveHandle`` whose ``result()``
    re-raises writer exceptions."""
    leaves, _ = tree_flatten(tree)
    host_leaves = [_to_savable(l) for l in leaves]
    structure = describe(tree)

    def _write():
        final = _step_dir(root, step)
        tmp = final + f".tmp{process_index}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"proc_{process_index}.npz"),
                 **{f"leaf_{i:05d}": l for i, l in enumerate(host_leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(host_leaves),
                       "leaves": [{"shape": list(l.shape),
                                   "dtype": str(l.dtype)}
                                  for l in host_leaves],
                       "treedef": structure, "time": time.time()}, f)
        if fault_hook is not None:
            fault_hook()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(final, "COMMITTED"), "w") as f:
            f.write("ok")

    if blocking:
        _write()
        return None
    errbox: dict = {}

    def _guarded_write():
        try:
            _write()
        except BaseException as e:  # noqa: BLE001 — delivered via result()
            errbox["exc"] = e

    t = threading.Thread(target=_guarded_write, daemon=False)
    t.start()
    return SaveHandle(t, errbox)


def committed_steps(root: str) -> list:
    """All committed steps, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and ".tmp" not in name:
            path = os.path.join(root, name)
            if os.path.exists(os.path.join(path, "COMMITTED")):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed verification against its meta.json
    (missing/truncated leaf file, wrong leaf count, or shape drift)."""


def _read_verified_leaves(root: str, step: int, process_index: int,
                          n_expected: Optional[int] = None) -> list:
    """Load a step's leaves, verified against meta.json — restore must
    never trust leaf files blindly: a truncated npz or a shape that
    drifted from what save() recorded raises :class:`CheckpointCorrupt`
    (callers like ``restore_latest`` then fall back to the PREVIOUS
    committed step instead of blowing up mid-serve)."""
    sdir = _step_dir(root, step)
    if not os.path.isdir(sdir):
        # a step that was never written is a caller error, not corruption
        raise FileNotFoundError(sdir)
    try:
        with open(os.path.join(sdir, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupt(f"step {step}: unreadable meta.json: {e}")
    n_leaves = meta.get("n_leaves")
    if not isinstance(n_leaves, int):
        raise CheckpointCorrupt(f"step {step}: meta.json lacks n_leaves")
    try:
        data = np.load(os.path.join(sdir, f"proc_{process_index}.npz"))
        loaded = [data[f"leaf_{i:05d}"] for i in range(n_leaves)]
    except Exception as e:  # zipfile/KeyError/OSError: truncated or short
        raise CheckpointCorrupt(f"step {step}: bad leaf file: {e}")
    if n_expected is not None and n_leaves != n_expected:
        raise CheckpointCorrupt(
            f"step {step}: {n_leaves} leaves saved, {n_expected} expected")
    for i, (l, m) in enumerate(zip(loaded, meta.get("leaves") or [])):
        if list(l.shape) != m["shape"] or str(l.dtype) != m["dtype"]:
            raise CheckpointCorrupt(
                f"step {step}: leaf {i} is {l.shape}/{l.dtype}, meta says "
                f"{tuple(m['shape'])}/{m['dtype']}")
    return loaded


def restore(root: str, step: int, like: Any, device=None,
            process_index: int = 0, fault_hook: Optional[Any] = None) -> Any:
    """Load ``step`` into the structure of ``like``: each leaf takes the
    dtype of ``like``'s leaf, and a tensor leaf its device (``device``
    overrides it). ``fault_hook`` runs before the read (injection seam).
    Raises :class:`CheckpointCorrupt` when the step fails verification
    against its meta.json."""
    if fault_hook is not None:
        fault_hook()
    leaves, structure = tree_flatten(like)
    loaded = _read_verified_leaves(root, step, process_index,
                                   n_expected=len(leaves))
    loaded = [_from_savable(l, ref, device) for l, ref in zip(loaded, leaves)]
    return tree_unflatten(structure, loaded)


def restore_latest(root: str, like: Any, device=None,
                   fault_hook: Optional[Any] = None):
    """Restore the newest committed step that VERIFIES — a corrupt or
    truncated newest checkpoint falls back to the previous committed step
    (mid-serve robustness: stale data beats a crash), exhausting all of
    them returns (None, None)."""
    last_err = None
    for step in reversed(committed_steps(root)):
        try:
            return step, restore(root, step, like, device,
                                 fault_hook=fault_hook)
        except CheckpointCorrupt as e:
            last_err = e
    if last_err is not None:
        logging.getLogger(__name__).warning(
            "no verifiable checkpoint under %s (last: %s)", root, last_err)
    return None, None


def restore_latest_arrays(root: str, process_index: int = 0,
                          fault_hook: Optional[Any] = None):
    """Structure-free restore: the newest VERIFIED committed step's leaves
    as a flat list of host arrays, falling back past corrupt steps like
    ``restore_latest``. For state whose shapes change over its lifetime
    (the mutable store's arena grows/shrinks), where no ``like`` template
    can exist ahead of the load; meta.json's recorded shapes/dtypes are
    the verification reference instead."""
    if fault_hook is not None:
        fault_hook()
    for step in reversed(committed_steps(root)):
        try:
            with open(os.path.join(_step_dir(root, step),
                                   "meta.json")) as f:
                n = json.load(f)["n_leaves"]
            return step, _read_verified_leaves(root, step, process_index,
                                               n_expected=n)
        except (CheckpointCorrupt, OSError, json.JSONDecodeError,
                KeyError):
            continue
    return None, None


def garbage_collect(root: str, keep: int = 3):
    """Trim to the newest ``keep`` committed steps AND sweep orphaned
    ``step_*.tmp*`` dirs left by crashed/failed saves. A tmp dir is only
    stale — hence removable — when its step does not exceed the newest
    COMMITTED step: anything newer could be an in-flight async save."""
    if not os.path.isdir(root):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(root)
        if n.startswith("step_") and "." not in n
        and os.path.exists(os.path.join(root, n, "COMMITTED")))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
    newest = steps[-1] if steps else None
    if newest is None:
        return
    for n in os.listdir(root):
        if not (n.startswith("step_") and ".tmp" in n):
            continue
        try:
            s = int(n.split(".")[0].split("_")[1])
        except (IndexError, ValueError):
            continue
        if s <= newest:
            shutil.rmtree(os.path.join(root, n), ignore_errors=True)
