"""Atomic, resumable checkpoints on disk (counterpart of
``repro.train.checkpoint``; ``save_to_session`` / ``restore_from_session``,
which stream through the host FanStore engine, wait for its copy, ROADMAP
Queue 1 item 5).

Layout: ``<dir>/step_<N>/`` holding one ``arrays.npz`` (every leaf, keyed by
its path joined with ``/``) and ``manifest.json`` (``step``, ``keys``,
``time``, ``extra``: the sampler cursor). Writes go to ``step_<N>.tmp`` and
are renamed into place, so a crash mid-write never leaves a partial
checkpoint that ``list_checkpoints`` would return. ``CheckpointManager``
copies the state to the host, then writes it from a thread and keeps the
newest ``keep``.

A state is a tree of dicts, lists, tuples and dataclasses (``TrainState``)
whose leaves are tensors or arrays. bf16 tensors, which NumPy has no type
for, are stored as their uint16 bit patterns. ``restore_checkpoint`` copies
into the target's own tensors in place (on their device) where the
reference returns a new tree.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of ``tree`` in a fixed order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        yield prefix, tree
        return
    for key, val in items:
        yield from _leaves(val, f"{prefix}/{key}" if prefix else str(key))


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def host_copy(state: Any) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host array, keyed by its path."""
    return {name: _to_numpy(leaf) for name, leaf in _leaves(state)}


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *,
                    extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint write; returns the final directory path. ``state``
    is a tree or the ``host_copy`` of one (which is its own host copy)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = host_copy(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays),
                "time": time.time(), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(full, "manifest.json")):
            out.append((int(name.split("_")[1]), full))
    return sorted(out)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, target: Any, *,
                       step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into ``target``'s tensors in place; returns (target, manifest).
    The newest checkpoint unless ``step`` names one."""
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if step is None:
        step, path = ckpts[-1]
    else:
        match = [p for s, p in ckpts if s == step]
        if not match:
            raise FileNotFoundError(f"step {step} not in {ckpt_dir}")
        path = match[0]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for name, leaf in _leaves(target):
            if name not in arrays:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = arrays[name]
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"{name}: restore fills tensors, got {type(leaf)}")
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(leaf.shape)}")
            src = torch.from_numpy(arr)
            if leaf.dtype == torch.bfloat16:
                src = src.view(torch.bfloat16)
            leaf.copy_(src)
    return target, manifest


class CheckpointManager:
    """Async writer + retention. ``save()`` returns once the state is copied
    to the host; a thread writes it."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, step: int, state: Any, *, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        arrays = host_copy(state)

        def _write():
            try:
                save_checkpoint(self.ckpt_dir, step, arrays, extra=extra)
                self._gc()
            except BaseException as e:
                self._err = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _gc(self) -> None:
        ckpts = list_checkpoints(self.ckpt_dir)
        for _, path in ckpts[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        ckpts = list_checkpoints(self.ckpt_dir)
        return ckpts[-1][0] if ckpts else None
