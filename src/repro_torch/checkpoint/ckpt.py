"""Checkpointing: async, atomic (port of ``repro.checkpoint.ckpt``).

* **Async**: ``save()`` snapshots every leaf to host memory before it
  returns and hands the write to a background thread; training continues
  at once, and may update the tensors in place meanwhile.
* **Atomic**: writes land in ``step_XXXXXXXX.tmp`` and are renamed only
  when complete, so a preemption mid-write never corrupts the latest
  checkpoint.  Older checkpoints are removed down to ``keep``.
* **The reference's files**: ``arrays.npz`` holds one array per leaf
  under its '/'-joined path (a tuple index as ``[i]``, as ``jax.tree_util``
  prints it) and ``meta.json`` the caller's metadata with ``step`` and
  ``time``, so an f32 checkpoint written by either package restores in the
  other.  numpy has no bfloat16 of its own: a bf16 leaf is stored as its
  raw 16 bits (``uint16``) and named in ``meta.json`` under ``dtypes``; a
  bf16 leaf that the reference wrote (``ml_dtypes``' type, which numpy
  reads back as ``V2``) restores as bf16 too.

``restore()`` returns host (CPU) tensors shaped like the template; the
caller copies them where it keeps its state.  ``restore_sharded()``
places each leaf on a mesh as a DTensor; a DTensor leaf is saved whole
(gathered), so a checkpoint restores onto any mesh ("elastic").
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.sharding.rules import place

#: the ``meta.json`` entry naming the leaves stored as raw bf16 bits
DTYPES_KEY = "dtypes"


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of nested dicts, tuples and lists, in the order and
    with the keys of ``jax.tree_util``'s paths: dict keys sorted, a
    sequence index as ``[i]``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else k)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copies of every leaf by path, and the paths of bf16 leaves
    (stored as their raw bits)."""
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            dtypes[key] = "bfloat16"
            flat[key] = t.numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat, dtypes


def _host_tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16 or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _unflatten(template, flat: Dict[str, np.ndarray],
               dtypes: Dict[str, str], prefix: str = ""):
    """``template``'s structure with the stored arrays as CPU tensors;
    raises on a missing leaf or another shape."""
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, dtypes,
                              f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(
            _unflatten(v, flat, dtypes,
                       f"{prefix}/[{i}]" if prefix else f"[{i}]")
            for i, v in enumerate(template))
    arr = flat[prefix]
    want = tuple(torch.as_tensor(template).shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"{prefix}: ckpt {arr.shape} vs model {want}")
    return _host_tensor(arr, dtypes.get(prefix) == "bfloat16")


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved_step: Optional[int] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, meta: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()                         # one in-flight write at a time
        host, dtypes = _flatten(state)      # synchronous copies to host
        meta = dict(meta or {}, step=step, time=time.time())
        if dtypes:
            meta[DTYPES_KEY] = dtypes

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            np.savez(tmp / "arrays.npz", **host)
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():              # same step already published
                shutil.rmtree(tmp)
            else:
                os.replace(tmp, final)      # atomic publish
            self.last_saved_step = step
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return max(s) if s else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """The checkpoint of ``step`` (default the latest) as CPU tensors in
        ``template``'s structure, and its meta."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        with np.load(d / "arrays.npz") as npz:
            arrays = dict(npz)
        meta = json.loads((d / "meta.json").read_text())
        return _unflatten(template, arrays, meta.get(DTYPES_KEY, {})), meta

    def restore_sharded(self, template: Any, placements, mesh,
                        step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Restore and place with the mesh's placements (elastic):
        ``placements`` mirrors ``template`` with a list of placements per
        leaf (``sharding.rules.to_placements``) or ``None`` for a
        replicated leaf.  Every rank reads the files and copies only its
        own chunk of each leaf to the mesh's device
        (``sharding.rules.place``), with no communication."""
        host, meta = self.restore(template, step)
        rep = [Replicate()] * mesh.ndim

        def put(x, pl):
            if isinstance(x, dict):
                return {k: put(v, pl[k] if pl is not None else None)
                        for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(put(v, pl[i] if pl is not None else None)
                               for i, v in enumerate(x))
            return place(x, rep if pl is None else pl, mesh)
        return put(host, placements), meta
