"""Starts the ranks of a mesh: N spawned processes over one process group.

Replaces the JAX package's single controller. `launch(world, target, args)`
spawns `world` processes (the spawn start method: CUDA may already be
initialised in the caller, where fork is unsafe), each of which

  * sets LOCAL_RANK, one torch thread, and for NCCL its card
    (torch.cuda.set_device before init_process_group);
  * joins the default process group through a file:// store under a fresh
    directory, with a finite timeout;
  * calls target(*args), named "package.module:function" so that the child
    imports only torch and this package, and writes its result (or its
    traceback) to the run directory.

The caller waits at most `timeout` seconds. A rank that fails or does not
finish in time makes the caller kill every rank and raise LaunchError.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Sequence

import torch


class LaunchError(RuntimeError):
    pass


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank: int, world: int, run_dir: str, backend: str, timeout: float,
               target: str, args: tuple) -> None:
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    out = os.path.join(run_dir, f"rank{rank}")
    try:
        if backend == "nccl":  # NCCL binds the current card at init; make_mesh sets it again
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{run_dir}/store", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            result = _resolve(target)(*args)
        finally:
            dist.destroy_process_group()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".pkl")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(world: int, target: str, args: Sequence = (), backend: str = "gloo",
           timeout: float = 600.0) -> list:
    """Runs target(*args) in `world` ranks; returns their results in rank
    order. backend: "gloo" or "nccl". timeout bounds the whole run and each
    rank's collectives. The run's store lives in a fresh directory under
    the system's temporary directory (TMPDIR)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    run_dir = tempfile.mkdtemp(prefix="zk_mesh_")
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, name=f"zk-rank{r}", daemon=True,
                    args=(r, world, run_dir, backend, timeout, target, tuple(args)))
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise LaunchError(_failure(run_dir, procs, failed, "failed"))
            if time.monotonic() > deadline:
                hung = [r for r, p in enumerate(procs) if p.is_alive()]
                raise LaunchError(_failure(run_dir, procs, hung, f"ran past {timeout:.0f} s"))
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise LaunchError(_failure(run_dir, procs, failed, "failed"))
        results = []
        for r in range(world):
            with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(run_dir, ignore_errors=True)


def _failure(run_dir: str, procs, ranks, what: str) -> str:
    lines = [f"rank(s) {ranks} {what}; exit codes {[p.exitcode for p in procs]}"]
    for r in range(len(procs)):
        path = os.path.join(run_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"--- rank {r}:\n{f.read()[-4000:]}")
    return "\n".join(lines)
