"""Sharded, preemption-safe checkpointing: the counterpart of
``repro/checkpoint/manager.py``, in its file format key for key.

Layout:  <dir>/step_<n:08d>/
            shard_<proc>.npz     flattened param/opt leaves (this process)
            metadata.json        the caller's metadata, when given
            COMMIT               written last, by process 0; a step
                                 without COMMIT is torn and ignored

Atomicity: each shard is written to a temporary file, fsynced and
``os.replace``d; COMMIT comes after the shard.  ``keep`` bounds disk
usage.  Restore picks the newest committed step -- the restart path a
preempted or failed node takes (``repro_torch.runtime``).

**The format is the reference's.**  Its keys join a leaf's path with
``/``: a NamedTuple field is ``.name`` (``.params``, ``.opt/.mu``), a
dict key itself, a sequence index its number; ``__dtypes__`` is a JSON
map from key to dtype name (uint8 bytes) for the leaves npz cannot hold,
stored as their raw unsigned bits (bfloat16 as uint16).  The reference
stacks a layer's weights into ``[L, ...]`` arrays; the port's tree keeps
a list of per-layer dictionaries (``convert.py``), so here a **list is a
layer stack**: each of its leaves is written as one array stacked over
the list, on the host, under the reference's key (``.params/layers/wq``
``[L, ...]``, the MoE's ``.params/layers/dense_mlp/wg``, the hybrid's
``.params/cycles/b0/w_x`` ``[n_cycles, ...]``), while a tuple (the
hybrid's ``tail``) keeps its indices (``.params/tail/0/wq``).  An int
(AdamW's ``count``) is a 0-d int32.  bfloat16 crosses through
``Tensor.view(torch.int16)`` and numpy ``uint16``, with no
``ml_dtypes``.  So a file written by either package restores in the
other, bit for bit.

**Asynchronous saves.**  The reference hands its live tree to the
writer thread, which is safe only because JAX arrays are immutable.  The
port's AdamW updates the parameters and moments in place, so a thread
reading them while the next step runs would write a checkpoint mixing
two steps.  ``save(..., block=False)`` therefore copies every leaf into
host memory before it returns (a synchronous device-to-host copy on the
caller's stream); only the file write goes to the thread.  ``history``
keeps each save's and restore's bytes and walls.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

_TMP_COUNTER = itertools.count()

#: dtypes npz cannot hold: their name, the integer view the bits cross
#: through (torch and numpy), and the unsigned dtype the file stores (the
#: reference's raw views)
_RAW_DTYPES = {
    torch.bfloat16: ("bfloat16", torch.int16, np.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8, np.uint8)}
_RAW_BY_NAME = {raw[0]: (dtype, raw[2])
                for dtype, raw in _RAW_DTYPES.items()}


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _entries(node, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, value) pairs in the reference's flatten order.  A value is a
    leaf, or for a list (a layer stack) the list of its layers' values
    under one key."""
    if node is None:
        return []
    if isinstance(node, list):
        cols = [_entries(layer, prefix) for layer in node]
        if not cols:
            return []
        keys = [k for k, _ in cols[0]]
        if any([k for k, _ in col] != keys for col in cols[1:]):
            raise ValueError(f"{prefix}: the layers of a list differ in "
                             f"structure")
        return [(k, [col[j][1] for col in cols]) for j, k in enumerate(keys)]
    if _is_namedtuple(node):
        kids = [(f".{f}", getattr(node, f)) for f in node._fields]
    elif isinstance(node, dict):
        kids = [(str(k), node[k]) for k in sorted(node)]
    elif isinstance(node, tuple):
        kids = [(str(i), v) for i, v in enumerate(node)]
    else:
        return [(prefix, node)]
    out = []
    for name, kid in kids:
        out.extend(_entries(kid, f"{prefix}/{name}" if prefix else name))
    return out


def _as_leaf(leaf):
    """A tensor or numpy array for ``leaf`` (a Python int is a 0-d int32,
    as the reference's count is; a float a float32)."""
    if torch.is_tensor(leaf) or isinstance(leaf, np.ndarray):
        return leaf
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _layers(value) -> List[Any]:
    """A value's leaves in stacking order."""
    if isinstance(value, list):
        return [leaf for v in value for leaf in _layers(v)]
    return [_as_leaf(value)]


def _stack_dims(value) -> Tuple[int, ...]:
    dims = []
    while isinstance(value, list):
        dims.append(len(value))
        value = value[0]
    return tuple(dims)


def _to_host(key: str, value) -> Tuple[np.ndarray, Optional[str]]:
    """The stored array of one key (the layers stacked on the host, each
    copied once into its slot) and its raw dtype name, if any."""
    leaves = _layers(value)
    first = leaves[0]
    shape, dtype = tuple(first.shape), first.dtype
    for leaf in leaves[1:]:
        if tuple(leaf.shape) != shape or leaf.dtype != dtype:
            raise ValueError(f"leaf {key}: layers of shapes / dtypes "
                             f"{shape} {dtype} and {tuple(leaf.shape)} "
                             f"{leaf.dtype} cannot stack")
    raw = _RAW_DTYPES.get(dtype) if isinstance(dtype, torch.dtype) else None
    if raw is not None:
        np_dtype = raw[3]
    elif isinstance(dtype, torch.dtype):
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    else:
        np_dtype = dtype
    out = np.empty(_stack_dims(value) + shape, np_dtype)
    rows = out.reshape(len(leaves), -1)
    for row, leaf in zip(rows, leaves):
        if not torch.is_tensor(leaf):
            row[...] = np.asarray(leaf).reshape(-1)
        elif raw is not None:
            torch.from_numpy(row.view(raw[2])).copy_(
                leaf.detach().view(raw[1]).reshape(-1))
        else:
            torch.from_numpy(row).copy_(leaf.detach().reshape(-1))
    return out, (raw[0] if raw is not None else None)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """The reference's flat dict of ``tree``, every leaf copied to host
    memory (synchronously: the tree may change as soon as this returns)."""
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, value in _entries(tree):
        flat[key], raw = _to_host(key, value)
        if raw is not None:
            dtypes[key] = raw
    flat["__dtypes__"] = np.frombuffer(
        json.dumps(dtypes).encode(), dtype=np.uint8).copy()
    return flat


def _unflatten_into(template, flat: Dict[str, np.ndarray],
                    device: DeviceLike = None):
    """A tree shaped like ``template`` holding the checkpoint's values:
    each tensor leaf on ``device`` (default: the template leaf's) in the
    template leaf's dtype, a list's layers cut from the stacked array."""
    dtypes = {}
    if "__dtypes__" in flat:
        dtypes = json.loads(bytes(flat["__dtypes__"]).decode())

    def leaf(node, key, index, dims):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        want = _as_leaf(node)
        if tuple(arr.shape) != dims + tuple(want.shape):
            raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                             f"{dims + tuple(want.shape)}")
        arr = np.asarray(arr[index], order="C")
        if isinstance(node, (bool, int, float)):
            return type(node)(arr.item())
        if key in dtypes:
            dtype, view = _RAW_BY_NAME[dtypes[key]]
            t = torch.from_numpy(arr.view(view)).view(dtype)
        else:
            t = torch.from_numpy(arr)
        if torch.is_tensor(node):
            dev = node.device if device is None else torch.device(device)
            devices.add(dev)
            return t.to(device=dev, dtype=node.dtype)
        if t.dtype in _RAW_DTYPES:
            raise TypeError(f"leaf {key}: a numpy template cannot hold "
                            f"{dtypes[key]}")
        return t.numpy().astype(node.dtype)

    devices = set()

    def build(node, key, index, dims):
        if node is None:
            return None
        if isinstance(node, list):
            return [build(layer, key, index + (i,), dims + (len(node),))
                    for i, layer in enumerate(node)]
        join = (lambda name: f"{key}/{name}" if key else name)
        if _is_namedtuple(node):
            return type(node)(*[build(getattr(node, f), join(f".{f}"),
                                      index, dims) for f in node._fields])
        if isinstance(node, dict):
            return {k: build(v, join(str(k)), index, dims)
                    for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(build(v, join(str(i)), index, dims)
                         for i, v in enumerate(node))
        return leaf(node, key, index, dims)

    tree = build(template, "", (), ())
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)     # the copies have landed
    return tree


def _nbytes(flat: Dict[str, np.ndarray]) -> int:
    return sum(a.nbytes for a in flat.values())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.proc = process_index
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: one dict a save (``step``, ``bytes``, ``blocked_s``: the
        #: caller's wall in ``save``, ``write_s``) or restore (``step``,
        #: ``bytes``, ``read_s``: file to tensors on the device)
        self.history: List[Dict[str, Any]] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def committed_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, metadata: Optional[dict] = None,
             block: bool = True) -> None:
        """Write ``tree`` as ``step``.  The tree is copied to the host,
        then the previous asynchronous save is waited for, so steps commit
        in order; with ``async_save`` and ``block=False`` the file write
        runs in a thread and this returns."""
        t0 = time.perf_counter()
        flat = _flatten(tree)       # overlaps the write in flight, if any
        self.wait()
        record = {"op": "save", "step": step, "bytes": _nbytes(flat)}
        self.history.append(record)
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, flat, metadata,
                                                record))
            self._thread.start()
            record["blocked_s"] = time.perf_counter() - t0
        else:
            self._write(step, flat, metadata, record)
            record["blocked_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        """Wait for the asynchronous save in flight, if any; re-raise
        what failed it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint save failed") \
                from err

    def _write_async(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as err:    # surfaced by wait()
            self._error = err

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               metadata: Optional[dict], record: dict) -> None:
        t0 = time.perf_counter()
        sdir = self._step_dir(step)
        os.makedirs(sdir, exist_ok=True)
        tmp = os.path.join(
            sdir, f".tmp_shard_{self.proc}.{next(_TMP_COUNTER)}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(sdir, f"shard_{self.proc}.npz"))
        if metadata is not None:
            with open(os.path.join(sdir, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        # single-controller commit (process 0)
        if self.proc == 0:
            with open(os.path.join(sdir, "COMMIT"), "w") as f:
                f.write("ok")
        self._gc()
        record["write_s"] = time.perf_counter() - t0

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def restore(self, template, step: Optional[int] = None, *,
                device: DeviceLike = None
                ) -> Tuple[int, Any, Optional[dict]]:
        """(step, tree, metadata) of ``step`` (default: the newest
        committed).  The tree is shaped like ``template``; each tensor
        leaf is new, in its template leaf's dtype, on ``device`` (default:
        the template leaf's device -- pass one for a template of meta
        tensors)."""
        steps = self.committed_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        t0 = time.perf_counter()
        sdir = self._step_dir(step)
        with np.load(os.path.join(sdir, f"shard_{self.proc}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten_into(template, flat, device)
        meta = None
        mpath = os.path.join(sdir, "metadata.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                meta = json.load(f)
        self.history.append({"op": "restore", "step": step,
                             "bytes": _nbytes(flat),
                             "read_s": time.perf_counter() - t0})
        return step, tree, meta


__all__ = ["CheckpointManager"]
