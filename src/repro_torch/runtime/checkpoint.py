"""Atomic checkpoints with keep-K GC (the port of `repro.runtime.checkpoint`,
one device; the same layout, so a checkpoint the JAX package wrote
restores here bit for bit).

Layout per step:
    <dir>/step_000042/
        manifest.json    — step, leaf paths, shapes, dtypes, extra (the
                           data-pipeline cursor), time
        arrays.npz       — all leaves, copied to the host
        _COMMITTED       — written last; restore ignores dirs without it

Leaf paths are the JAX package's: dict keys sorted and joined by "/", an
`OptState` field as ".step", ".mu", ".nu". A bfloat16 leaf is stored as
its raw 2-byte words (numpy has no bfloat16; the JAX package's
ml_dtypes arrays land in the file the same way) with "bfloat16" in the
manifest, and restored by its bits.

Fault-tolerance properties:
  * atomicity: write to step_X.tmp-<pid>-<thread>, fsync, rename, then
    touch _COMMITTED — a preempted save can never shadow a good one;
  * keep-K GC, never GC'ing the newest committed step;
  * async: `save_async` copies the tree to the host (a consistent
    snapshot) and hands it to a writer thread, so the train loop doesn't
    stall on disk;
  * restore places each leaf on the device and in the dtype of the tree
    it is given.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.runtime.optimizer import OptState

# Serializes every writer — async *and* blocking saves. Without it, two
# concurrent saves of the same step race: one writer's _gc sweeps the
# other's in-flight .tmp dir before its rename (the train loop hits this
# when steps % ckpt_every == 0 fires an async save and the end-of-run
# blocking save immediately follows for the same step). Re-entrant so
# save_async's writer thread, which already holds it, can call save().
_WRITER_LOCK = threading.RLock()


def _leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) in the JAX package's flatten order and path strings."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, OptState):
        return [p for name in OptState._fields
                for p in _leaf_paths(getattr(tree, name), join(f".{name}"))]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _leaf_paths(v, join(i))]
    return [(prefix, tree)]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf on the host as numpy; bfloat16 as 2-byte raw words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _host_tree(tree: Any):
    """The tree with every tensor leaf copied to the host."""
    if isinstance(tree, OptState):
        return OptState(*(_host_tree(getattr(tree, n)) for n in OptState._fields))
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Blocking save. Returns the committed directory path."""
    with _WRITER_LOCK:
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)

        arrays = {}
        manifest = {"step": step, "leaves": [], "extra": extra or {}, "time": time.time()}
        for i, (name, leaf) in enumerate(_leaf_paths(tree)):
            arr = _to_numpy(leaf)
            key = f"a{i}"
            arrays[key] = arr
            manifest["leaves"].append({"path": name, "key": key, "shape": list(arr.shape),
                                       "dtype": _dtype_name(leaf, arr)})
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())

        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(final, "_COMMITTED"), "w") as f:
            f.write(str(step))
        _gc(ckpt_dir, keep)
        return final


def save_async(ckpt_dir: str, step: int, tree: Any, *,
               extra: Optional[dict] = None, keep: int = 3) -> threading.Thread:
    """Non-blocking save: the copy to the host happens here (a consistent
    snapshot), the disk IO on the writer thread."""
    snapshot = _host_tree(tree)

    def run():
        with _WRITER_LOCK:
            save(ckpt_dir, step, snapshot, extra=extra, keep=keep)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, d, "_COMMITTED")):
            try:
                steps.append(int(d.split("_")[1].split(".")[0]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _leaf_from(arr: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    """A stored array as a tensor in like's dtype on like's device."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore(ckpt_dir: str, tree_like: Any, *,
            step: Optional[int] = None) -> tuple[Any, dict]:
    """Restore into the structure of `tree_like` (nested dicts and
    `OptState`s of tensors), each leaf on its like's device and dtype."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    by_path = {leaf["path"]: (data[leaf["key"]], leaf["dtype"]) for leaf in manifest["leaves"]}

    def build(tree, prefix):
        join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
        if isinstance(tree, OptState):
            return OptState(*(build(getattr(tree, n), join(f".{n}"))
                              for n in OptState._fields))
        if isinstance(tree, dict):
            return {k: build(v, join(k)) for k, v in tree.items()}
        if prefix not in by_path:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        return _leaf_from(*by_path[prefix], tree)

    return build(tree_like, ""), manifest


def _gc(ckpt_dir: str, keep: int) -> None:
    committed = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
        and os.path.exists(os.path.join(ckpt_dir, d, "_COMMITTED")))
    for d in committed[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # drop orphaned tmp dirs from preempted saves
    for d in os.listdir(ckpt_dir):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
