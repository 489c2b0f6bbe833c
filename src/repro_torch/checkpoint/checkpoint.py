"""Checkpointing of the port: snapshots of nested dicts and lists of tensors
(or numpy arrays), with an asynchronous writer.

The reference package's ``checkpoint/checkpoint.py`` on one host, with
``torch.save`` in place of msgpack (which the card's machine lacks):

* a file holds the leaves (as CPU tensors, in the tree's sorted-key order),
  the step and ``extra`` (the data cursor), so a restart is exact;
* writes are atomic (a temporary file, then a rename), so a crash mid-save
  never corrupts the latest checkpoint;
* ``AsyncCheckpointer`` copies device to host synchronously, then writes in
  a background thread and keeps the newest ``keep`` files.

Files are ``step-<n>.pt``, read back with ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import os
import threading
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

SUFFIX = ".pt"


def _leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(like, Mapping):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(item, leaves) for item in like)
    return next(leaves)


def _to_host(x) -> torch.Tensor:
    """A CPU copy of a leaf (a tensor, numpy array or scalar) as a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


def save_pytree(path: str, tree: Any, *, step: int | None = None,
                extra: dict | None = None) -> None:
    payload = {
        "leaves": [_to_host(leaf) for leaf in _leaves(tree)],
        "step": -1 if step is None else int(step),
        "extra": dict(extra or {}),
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic


def load_pytree(path: str, like: Any) -> tuple[Any, int, dict]:
    """(tree, step, extra) from ``path``, laid out as ``like``.  A leaf whose
    ``like`` is a tensor comes back as a tensor on that tensor's device;
    any other comes back as a numpy array.  Raises :class:`ValueError` if
    the leaf count or a shape differs from ``like``'s."""
    payload = torch.load(path, weights_only=True)
    saved, want = payload["leaves"], _leaves(like)
    if len(saved) != len(want):
        raise ValueError(f"{path} holds {len(saved)} leaves, the tree has {len(want)}")
    out = []
    for i, (got, ref) in enumerate(zip(saved, want)):
        if tuple(got.shape) != tuple(np.shape(ref)):
            raise ValueError(f"{path}: leaf {i} has shape {tuple(got.shape)}, the tree "
                             f"has {tuple(np.shape(ref))}")
        out.append(got.to(ref.device) if isinstance(ref, torch.Tensor) else got.numpy())
    return _rebuild(like, iter(out)), int(payload["step"]), payload["extra"]


def _steps(ckpt_dir: str) -> list[int]:
    steps = []
    for n in os.listdir(ckpt_dir):
        if n.startswith("step-") and n.endswith(SUFFIX):
            try:
                steps.append(int(n[len("step-"):-len(SUFFIX)]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step-{step}{SUFFIX}")


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one pending save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()  # serialize pending write (bounded memory)
        # device->host copy happens *now* (synchronously), IO in background
        host = _rebuild(tree, iter([_to_host(leaf) for leaf in _leaves(tree)]))

        def _write():
            try:
                save_pytree(step_path(self.ckpt_dir, step), host, step=step, extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[: -self.keep]:
            try:
                os.remove(step_path(self.ckpt_dir, s))
            except OSError:
                pass

    def restore(self, like: Any, step: int | None = None):
        s = latest_step(self.ckpt_dir) if step is None else step
        if s is None:
            return None
        return load_pytree(step_path(self.ckpt_dir, s), like)
