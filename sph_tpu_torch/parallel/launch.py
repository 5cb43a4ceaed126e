"""Run a rank function on a few local ranks: the port's counterpart of a
``shard_map`` call over a small mesh.

    results = run_ranks(fn, world, backend, devices, *args)

spawns ``world`` processes (the ``spawn`` start method, never ``fork``: a
caller may hold threads, JAX's among them), joins them in a process group
over a ``FileStore`` in a temporary directory, and calls
``fn(comm, *args)`` in each, ``comm`` being the rank's
:class:`~sph_tpu_torch.parallel.comm.Comm`. It returns the list of the
ranks' return values in rank order, every tensor in them turned into a
NumPy array. A rank that raises fails the call with that rank's traceback;
the other ranks are then ended.

Hangs are bounded twice. The process group's collectives time out after
``GROUP_TIMEOUT`` (a collective whose peer never comes fails its rank:
gloo raises, NCCL's watchdog ends the process), and the call itself has a
deadline (``timeout_s`` after the ranks start): when it passes, every
rank still running is ended and the call raises ``TimeoutError`` naming
them.

``fn`` must be importable by name (a module-level function of a module
that imports no more than the ranks need). The kernels are built here,
before the ranks start, when a device is CUDA: the ranks load the cached
library and never run ``nvcc`` at once.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch

TIMEOUT_S = 900.0
# a collective's limit in every process group the package starts
GROUP_TIMEOUT = datetime.timedelta(minutes=3)


def run_ranks(fn, world: int, backend: str, devices, *args,
              timeout_s: float = TIMEOUT_S):
    """``fn(comm, *args)`` on ``world`` ranks; their results in rank order.

    ``backend``: "gloo" or "nccl" (never chosen here). ``devices``: one
    device for every rank (e.g. "cpu" or "cuda:0"), or a list of one a
    rank. The ranks share this process's torch threads. ``timeout_s``
    seconds after the ranks start, those that have not returned are ended
    and the call raises ``TimeoutError`` naming them."""
    from .comm import BACKENDS

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * world
    devices = [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend == "nccl" and len(set(devices)) < world:
        raise ValueError(f"nccl needs a distinct card a rank, got {devices}; "
                         "use gloo to share a card")
    if any(d.startswith("cuda") for d in devices):
        if not torch.cuda.is_available():
            raise RuntimeError(f"ranks on {sorted(set(devices))}, but CUDA "
                               "is not available: name the CPU (\"cpu\")")
        from ..ops import _build

        _build.build()
    threads = max(1, torch.get_num_threads() // world)

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="sph_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, backend, devices[rank],
                               threads, store, args, results))
             for rank in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        out = [None] * world
        pending = set(range(world))
        while pending:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if not procs[r].is_alive()]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    late = ", ".join(map(str, sorted(pending)))
                    raise TimeoutError(
                        f"rank(s) {late} of {world} did not return within "
                        f"{timeout_s:g} s; ended")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():        # a rank stuck in a CUDA call
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(fn, rank, world, backend, device, threads, store, args,
               results):
    import torch.distributed as dist

    from .comm import Comm

    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                **group_options(backend, dev))
        try:
            value = fn(Comm(device=dev, backend=backend), *args)
            results.put((rank, True, to_numpy(value)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def group_options(backend: str, device) -> dict:
    """``init_process_group``'s keywords for a rank on ``device``: the
    collectives' timeout, and under nccl the rank's card, so that the
    communicator forms at once among every rank (a batch of point-to-point
    ops that only some ranks post is then never the group's first
    call)."""
    kw = dict(timeout=GROUP_TIMEOUT)
    if backend == "nccl":
        kw["device_id"] = torch.device(device)
    return kw


def to_numpy(value):
    """``value`` with every tensor (in dicts, lists and tuples) turned into
    a NumPy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_numpy(v) for v in value)
    return value
