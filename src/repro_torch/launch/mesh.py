"""Mesh construction and rank processes (the port of `repro.launch.mesh`).

`make_production_mesh` and `make_test_mesh` build a `DeviceMesh` over the
ranks of an initialised process group (`init_device_mesh`; `init_from_env`
joins the group a launcher such as `torchrun` describes); importing this
module touches no device and no process group, as the reference's does not.
A JAX program is one controller over every device; a PyTorch mesh program
is one process a rank, each running the same code, so `World` spawns those
processes: each joins a process group through a `FileStore` and runs
`fn(rank, *args)`, and `World.join` gives back what each returned. `fn`
must be importable by the spawned processes (a module's function, the
caller's main module guarded by `if __name__ == "__main__"`).
"""
from __future__ import annotations

import datetime
import os
import pathlib
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_test_mesh(shape, axes, device_type=device_type)


def init_from_env(world_size: int, *, backend: str = "gloo") -> None:
    """Join the process group that a launcher such as `torchrun` describes
    in the environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), unless
    one is initialised already. Raises, naming `world_size`, when there is
    no such group or it has another size."""
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"this mesh needs a process group of {world_size} ranks, "
                               f"one a device (e.g. torchrun --nnodes ... --nproc-per-node "
                               f"...): {', '.join(missing)} not set")
        dist.init_process_group(backend, init_method="env://")
    if dist.get_world_size() != world_size:
        raise RuntimeError(f"this mesh needs a process group of {world_size} ranks, "
                           f"not {dist.get_world_size()}")


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *, device_type: str = "cuda"):
    """A mesh of `shape` named `axes` over the process group's ranks in
    row-major order; the group's world size must be the shape's product."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def _rank_main(fn, rank: int, world_size: int, workdir: str, backend: str,
               timeout_s: float, args: tuple) -> None:
    out = pathlib.Path(workdir)
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, store=dist.FileStore(str(out / "store"), world_size),
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            torch.save(fn(rank, *args), out / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


class World:
    """`world_size` spawned rank processes running `fn`; `join` waits for
    them and returns their results in rank order."""

    def __init__(self, fn, world_size: int, args: tuple = (), *, workdir=None,
                 backend: str = "gloo", timeout_s: float = 600.0):
        # workdir (default: the temporary directory) holds the store and
        # the results; it is removed by join.
        self.dir = pathlib.Path(tempfile.mkdtemp(prefix="world", dir=workdir))
        self.timeout_s = timeout_s
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world_size, str(self.dir), backend, timeout_s,
                                        tuple(args)))
                      for r in range(world_size)]
        for p in self.procs:
            p.start()

    def _stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def join(self) -> list:
        """Results in rank order. A rank that fails (or a world that outlives
        its timeout) stops every rank and raises with the ranks' tracebacks."""
        deadline = time.monotonic() + self.timeout_s
        try:
            while any(p.is_alive() for p in self.procs):
                if any(p.exitcode not in (None, 0) for p in self.procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        finally:
            self._stop()
        try:
            codes = [p.exitcode for p in self.procs]
            if any(c != 0 for c in codes):
                errs = "\n".join(f.read_text() for f in sorted(self.dir.glob("rank*.err")))
                raise RuntimeError(f"rank exit codes {codes}\n{errs}")
            return [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                    for r in range(len(self.procs))]
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)

