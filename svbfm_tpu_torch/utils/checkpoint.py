"""Checkpoint/resume of the learners' states.

Counterpart of ``svbfm_tpu/utils/checkpoint.py:33-122``, with its file
format: one ``.npz`` written atomically (a temporary file, then
``os.replace``) holding the leaves as ``leaf_<i>``, their names as
``__names__``, the iteration as ``__step__`` and a JSON metadata dict as
``__meta__``.  The reference has no checkpoints of its own (its
``num_complete_iter`` resume hooks were never built,
``fm_learn_vb_simultaneous.h:20``).

A state is a tree of dataclasses, dicts, lists/tuples and leaves, named
by field (``.mu_v``), key (``['psum_all']``) and index (``[0]``).  A leaf
is a tensor, a numpy array or a number, or a ``Draws`` source: that is
saved as its generator's ``get_state()`` and restored into a new generator
on the template's device (a CUDA generator's state too), so a resumed
Gibbs chain or SGD run draws the numbers the uninterrupted one would.
Loading restores into the structure of a template (the learner's fresh
state) and refuses a file whose leaf names or shapes differ.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from svbfm_tpu_torch.learners.draws import Draws

_GEN = ".generator"  # the name suffix of a Draws source's generator state


def _items(tree, prefix: str):
    """(name, leaf) of ``tree``'s leaves in a fixed order."""
    if isinstance(tree, Draws):
        yield prefix + _GEN, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), f"{prefix}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, f"{prefix}[{i}]")
    elif isinstance(tree, (torch.Tensor, np.ndarray, int, float, np.number)):
        yield prefix, tree
    else:
        raise TypeError(f"checkpoint: cannot save {prefix or 'the state'} "
                        f"of type {type(tree).__name__}")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, Draws):
        return leaf.generator.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken in order from ``it``
    (numpy arrays), each put where the template's leaf was."""
    if isinstance(tree, Draws):
        gen = torch.Generator(device=tree.generator.device)
        gen.set_state(torch.from_numpy(next(it)))
        return Draws(gen, tree.device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _rebuild(getattr(tree, f.name), it)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    a = next(it)
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(tree.device, tree.dtype)
    if isinstance(tree, np.ndarray):
        return a.astype(tree.dtype)
    return type(tree)(a)


def _flatten_with_names(tree):
    names, leaves = [], []
    for name, leaf in _items(tree, ""):
        names.append(name)
        leaves.append(_host(leaf))
    return names, leaves


def save_checkpoint(path: str, state: Any, step: int,
                    meta: Optional[dict] = None) -> None:
    """Atomically write ``state`` (+ step + meta) to ``path`` (.npz)."""
    names, leaves = _flatten_with_names(state)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["__names__"] = np.asarray(names)
    payload["__step__"] = np.asarray(step)
    payload["__meta__"] = np.asarray(json.dumps(meta or {}))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, template: Any) -> Tuple[Any, int, dict]:
    """Restore a checkpoint into the structure of ``template``; leaf names
    and shapes must match the template's (guarded)."""
    with np.load(path, allow_pickle=False) as z:
        names = [str(n) for n in z["__names__"]]
        step = int(z["__step__"])
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(len(names))]
    t_names, t_leaves = _flatten_with_names(template)
    if t_names != names:
        raise ValueError(
            f"checkpoint structure mismatch: {names[:3]}... vs {t_names[:3]}...")
    for name, a, b in zip(names, leaves, t_leaves):
        if a.shape != b.shape:
            raise ValueError(f"checkpoint leaf {name} shape {a.shape} != "
                             f"expected {b.shape}")
    return _rebuild(template, iter(leaves)), step, meta


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """Path of the highest-step ``<prefix>_<step>.npz`` in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for fn in os.listdir(ckpt_dir):
        if fn.startswith(prefix + "_") and fn.endswith(".npz"):
            try:
                step = int(fn[len(prefix) + 1:-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(ckpt_dir, fn), step
    return best


def resume(learner, ckpt, state) -> Tuple[Any, int]:
    """(state, iterations done) from ``ckpt``'s latest checkpoint, restored
    into ``state``'s structure; ``(state, 0)`` without ``ckpt`` or a
    checkpoint.  Refuses a learner whose class sets ``resumable = False``
    (the windowed learners, whose row caches live in windows)."""
    if ckpt is None:
        return state, 0
    if not getattr(learner, "resumable", True):
        raise ValueError(f"{type(learner).__name__} does not resume from "
                         "checkpoints")
    restored = ckpt.restore_latest(state)
    if restored is None:
        return state, 0
    state, step, _meta = restored
    return state, step


class CheckpointManager:
    """Keeps the ``max_to_keep`` newest ``ckpt_<step>.npz`` files."""

    def __init__(self, ckpt_dir: str, prefix: str = "ckpt",
                 max_to_keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.prefix = prefix
        self.max_to_keep = max_to_keep

    def save(self, state: Any, step: int, meta: Optional[dict] = None) -> str:
        path = os.path.join(self.ckpt_dir, f"{self.prefix}_{step}.npz")
        save_checkpoint(path, state, step, meta)
        self._gc()
        return path

    def restore_latest(self, template: Any):
        path = latest_checkpoint(self.ckpt_dir, self.prefix)
        if path is None:
            return None
        return load_checkpoint(path, template)

    def _gc(self) -> None:
        entries = []
        for fn in os.listdir(self.ckpt_dir):
            if fn.startswith(self.prefix + "_") and fn.endswith(".npz"):
                try:
                    entries.append((int(fn[len(self.prefix) + 1:-4]), fn))
                except ValueError:
                    pass
        entries.sort()
        for _step, fn in entries[:-self.max_to_keep or None]:
            os.unlink(os.path.join(self.ckpt_dir, fn))
