"""Atomic, elastic checkpoints with keep-K GC (the port of
`repro.runtime.checkpoint`; the same layout, so a checkpoint the JAX
package wrote restores here bit for bit).

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
    it is given;
  * sharded trees (`shardings=`, a tree of `distributed.sharding.
    NamedSharding` like the tree; None for a replicated leaf): `save`
    gathers every leaf whole to the host, one leaf at a time (a collective
    of every rank), rank 0 writes, and a blocking save's other ranks wait
    for its commit; `restore` reads the whole arrays and cuts each rank's
    slice by its spec, so a checkpoint saved on one device, on any mesh or
    by the JAX package restores onto any mesh.
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
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.runtime.optimizer import named_leaves, tree_map, tree_map_with_path

# Serializes every writer — async *and* blocking saves. Without it, two
# concurrent saves of the same step race: one writer's _gc sweeps the
# other's in-flight .tmp dir before its rename (the train loop hits this
# when steps % ckpt_every == 0 fires an async save and the end-of-run
# blocking save immediately follows for the same step). Re-entrant so
# save_async's writer thread, which already holds it, can call save().
_WRITER_LOCK = threading.RLock()


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
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)


def _whole_on_host(tree: Any, shardings: Any, keep: bool):
    """The tree with its sharded leaves gathered whole to the host of rank
    0, the writer (`keep`; None elsewhere), its replicated ones copied."""
    def one(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        if sh is None:
            return x.detach().to("cpu", copy=True) if keep else None
        return sharding.gather_to_root(x, sh.spec, sh.mesh)
    return tree_map(one, tree, shardings)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         keep: int = 3, shardings: Any = None) -> str:
    """Blocking save. Returns the committed directory path. With
    `shardings` every rank calls it and gets the path after rank 0's
    commit."""
    if shardings is not None:
        writer = sharding.world_rank() == 0
        host = _whole_on_host(tree, shardings, writer)
        final = save(ckpt_dir, step, host, extra=extra, keep=keep) if writer else None
        dist.barrier()
        return final or os.path.join(ckpt_dir, f"step_{step:08d}")
    with _WRITER_LOCK:
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)

        arrays = {}
        manifest = {"step": step, "leaves": [], "extra": extra or {}, "time": time.time()}
        for i, (name, leaf) in enumerate(named_leaves(tree)):
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


def save_async(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
               keep: int = 3, shardings: Any = None) -> Optional[threading.Thread]:
    """Non-blocking save: the copy to the host happens here (a consistent
    snapshot), the disk IO on the writer thread. With `shardings` every
    rank calls it (the gather is a collective); rank 0 gets the writer
    thread, the others None."""
    if shardings is not None:
        if sharding.world_rank() != 0:
            _whole_on_host(tree, shardings, False)
            return None
        snapshot = _whole_on_host(tree, shardings, True)
    else:
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


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of `tree_like` (nested dicts and
    `OptState`s of tensors), each leaf on its like's device and dtype; a
    leaf with a sharding becomes this rank's slice by its spec."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    by_path = {leaf["path"]: (leaf["key"], leaf["dtype"]) for leaf in manifest["leaves"]}

    def build(path, like, sh):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        key, dtype_name = by_path[path]
        arr = data[key]            # read one leaf at a time
        if sh is not None:
            arr = sharding.shard_of(arr, sh.spec, sh.mesh)
        return _leaf_from(arr, dtype_name, like)

    return tree_map_with_path(build, tree_like, shardings), manifest


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
