"""One process a device (the port's side of the JAX package's "one
controller, N devices").

`run(fn, nprocs, device)` starts `nprocs` ranks with the `spawn` start
method (CUDA cannot fork), each with its device set and joined to one
process group, calls `fn(*args)` on every rank and returns their results in
rank order:

  * `device="cuda"`: rank r on `cuda:r`, NCCL; more ranks than cards raise;
  * `device="cuda:i"`: every rank on `cuda:i`. NCCL refuses two ranks on
    one card, so more than one rank there needs `backend="gloo"`: the way
    a multi-rank path is checked on a machine with one card;
  * `device="cpu"`: gloo.

The ranks meet through a `file://` rendezvous in a fresh temporary
directory, so concurrent runs (test workers) never race for a TCP port; the
group is torn down when `fn` returns or raises. The CUDA kernels are built
in the parent before the ranks start, so no two ranks compile at once.
Under `torchrun` (`WORLD_SIZE` set) `run` joins the launcher's group in
this process instead of spawning, and returns this rank's result alone.
"""

import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_device: Optional[torch.device] = None


def local_device() -> Optional[torch.device]:
    """This rank's device inside `run`; None outside it."""
    return _device


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank` for a `run(..., device=device)` call."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def check_devices(nprocs: int, device, backend: str):
    """Raise unless `nprocs` ranks can run on `device` with `backend`; no
    quiet fallback to the CPU."""
    dev = torch.device(device)
    if nprocs < 1:
        raise ValueError(f"need at least one rank, got {nprocs}")
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"CPU ranks run on gloo, not {backend}")
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    cards = torch.cuda.device_count()
    if dev.index is None and nprocs > cards:
        raise ValueError(f"{nprocs} ranks need {nprocs} cards (one a rank); this machine has "
                         f"{cards}")
    if dev.index is not None and nprocs > 1 and backend == "nccl":
        raise ValueError(f"NCCL refuses two ranks on one card: {nprocs} ranks on {dev} need "
                         "backend='gloo'")


def _init(rank: int, world: int, device: torch.device, backend: str, init_method: str,
          threads: int):
    global _device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    _device = device


def _finish():
    global _device
    _device = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _worker(rank, world, tmp, device, backend, fn, args, quiet, threads):
    if quiet and rank > 0:
        sys.stdout = open(os.devnull, "w")
    try:
        _init(rank, world, rank_device(device, rank), backend,
              "file://" + os.path.join(tmp, "rendezvous"), threads)
        out = fn(*args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        _finish()


def run(fn: Callable, nprocs: int, device="cuda", backend: Optional[str] = None,
        args: Sequence = (), quiet: bool = False) -> List:
    """`fn(*args)` on `nprocs` ranks; the list of their return values (each
    pickled back), in rank order. `fn` must be importable by name (a
    module-level function) and its arguments picklable. `quiet` silences
    the standard output of every rank but 0. A rank that fails makes the
    others stop, and `run` raises with its traceback."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != nprocs:
            raise ValueError(f"torchrun started {world} ranks; this run asks for {nprocs}")
        local = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
        check_devices(int(os.environ.get("LOCAL_WORLD_SIZE", world)), device, backend)
        if quiet and rank > 0:
            sys.stdout = open(os.devnull, "w")
        _init(rank, world, local, backend, "env://", max(1, torch.get_num_threads() // world))
        try:
            return [fn(*args)]
        finally:
            _finish()
    check_devices(nprocs, dev, backend)
    if dev.type == "cuda":
        from coastline_torch.kernels import _build

        _build.build_all()
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="coastline_ranks_")
    threads = max(1, torch.get_num_threads() // nprocs)
    procs = [ctx.Process(target=_worker, args=(r, nprocs, tmp, str(dev), backend, fn,
                                               tuple(args), quiet, threads), daemon=False)
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                time.sleep(2.0)  # let the failing rank's peers fail on their own
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        errors = []
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                path = os.path.join(tmp, f"error_{r}.txt")
                tb = open(path).read() if os.path.exists(path) else "(no traceback)"
                errors.append(f"--- rank {r} exited with code {p.exitcode}\n{tb}")
        if errors:
            raise RuntimeError(f"{len(errors)} of {nprocs} ranks failed:\n" + "\n".join(errors))
        results = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
