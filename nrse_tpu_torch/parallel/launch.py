"""Run a function on N ranks of a fresh group, each in its own process.

What a launcher (torchrun) does for an entry point, for a function: N
processes started with ``spawn``, each joining one group at
``tcp://127.0.0.1:<a free port>`` as its rank, calling ``fn(rank, world,
*args)`` and sending back its result (numpy and Python values only: a
tensor would travel through shared memory that dies with its process).
A rank that raises or dies fails the whole run: the others are stopped
and the launcher raises with the rank's traceback.  Used by
:mod:`nrse_tpu_torch.parallel.dryrun`, the CPU tests of the data-parallel
path and ``chip_smoke.py``'s two-rank phase.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from nrse_tpu_torch.parallel.distributed import TIMEOUT


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend: str,
               threads: int, args, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, timeout=TIMEOUT)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              backend: str = "gloo", threads: int = 1,
              timeout: float = 600.0) -> List[Any]:
    """``[fn(r, world, *args) for r in range(world)]``, each rank in its
    own process inside one ``backend`` group (``threads`` torch threads
    each, 0 to keep torch's default).  ``fn`` must be importable by name
    (a module-level function).  Raises ``RuntimeError`` with the traceback
    of the first rank that failed, or after ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend, threads,
                               tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    outs, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(outs) < world and failure is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in outs]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = f"the ranks ran past {timeout:g} s"
                continue
            if ok:
                outs[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [outs[r] for r in range(world)]
