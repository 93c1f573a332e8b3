"""Collectives over a ``torch.distributed`` process group, and a helper
that starts a world of ranks.

The JAX package runs its sharded code as one program over a device mesh
(``shard_map``; ``jax.lax`` collectives over a named axis).  This package
runs one process per rank instead: each rank holds its own ``(C, ...)``
shard, and the shards concatenated in rank order are the JAX package's
global array.  ``Comm`` is the handful of collectives the balancer, the
migration executor and the halo exchange need, tiled along dim 0 as
``jax.lax`` tiles them:

  all_gather      (C, ...) per rank -> (p*C, ...) on every rank
  psum/pmin/pmax  elementwise all-reduce
  all_to_all      (p*C, ...) -> (p*C, ...): block d of rank s lands as
                  block s of rank d (and an async form)
  broadcast       one rank's tensor on every rank
  barrier         every rank has reached it

The caller picks the group's backend.  ``"nccl"`` runs the collectives
on the card (one card per rank).  ``"gloo"`` runs them in host memory:
on CPU tensors directly, and for CUDA tensors (ranks sharing one card)
each payload is copied to the host and back explicitly, and the bytes
so copied are counted in ``staged_bytes``.  ``all_to_all_bytes`` counts
the send buffers a rank hands to ``all_to_all`` (its own block
included), on either backend; ``reduce_bytes`` and ``reduce_s`` count
the tensors a rank hands to the all-reduces (``psum`` / ``pmin`` /
``pmax``) and the host seconds spent in them (a gloo collective returns
when it is done, so those are its seconds; under nccl, the time to
enqueue it).  Compute stays on the rank's device either way.  Nothing switches backend when something fails.
"""
from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

BACKENDS = ("nccl", "gloo")


class Comm:
    """The collectives of one rank of a process group.

    ``group=None`` is the default group.  ``device`` is where this rank
    computes (default CUDA: a CPU rank asks for ``"cpu"``); the tensors
    handed to the collectives live there."""

    def __init__(self, group=None, *, device=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.device = resolve_device(device)
        self.staged_bytes = 0          # host round trips of the gloo route
        self.all_to_all_bytes = 0      # send buffers handed to all_to_all
        self.reduce_bytes = 0          # tensors handed to the all-reduces
        self.reduce_s = 0.0            # host seconds in the all-reduces

    # -- staging ---------------------------------------------------------------
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend can take: a host copy of a CUDA tensor
        under gloo (counted), else the tensor itself."""
        if t.is_cuda and self.backend == "gloo":
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _unstage(self, host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if host.device == like.device:
            return host
        self.staged_bytes += host.numel() * host.element_size()
        return host.to(like.device)

    # -- collectives -----------------------------------------------------------
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(C, ...) on every rank -> (p*C, ...) in rank order."""
        t = t.contiguous()
        x = self._stage(t)
        bufs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(bufs, x, group=self.group)
        return self._unstage(torch.cat(bufs), t)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        t = torch.as_tensor(t).contiguous()
        self.reduce_bytes += t.numel() * t.element_size()
        x = self._stage(t)
        x = x.clone() if x is t else x
        dist.all_reduce(x, op=op, group=self.group)
        out = self._unstage(x, t)
        self.reduce_s += time.perf_counter() - t0
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The tensor of this group's rank ``src`` on every rank (same
        shape and type on all)."""
        t = t.contiguous()
        x = self._stage(t)
        x = x.clone() if x is t else x
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        dist.broadcast(x, src=src, group=self.group)
        return self._unstage(x, t)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """(p*C, ...) -> (p*C, ...), tiled along dim 0: rows
        [d*C, (d+1)*C) go to rank d, and arrive as rows [s*C, (s+1)*C) of
        the result for source rank s."""
        return self.all_to_all_async(t).wait()

    def all_to_all_async(self, t: torch.Tensor) -> "PendingAllToAll":
        """Start ``all_to_all``; ``.wait()`` gives its result.  Under gloo
        the host copy is made before the exchange starts."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: {t.shape[0]} rows do not split "
                             f"into {self.size} ranks")
        t = t.contiguous()
        self.all_to_all_bytes += t.numel() * t.element_size()
        x = self._stage(t)
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.group,
                                      async_op=True)
        return PendingAllToAll(self, work, out, t)


class PendingAllToAll:
    """An ``all_to_all`` in flight."""

    def __init__(self, comm: Comm, work, out: torch.Tensor,
                 like: torch.Tensor):
        self._comm, self._work, self._out, self._like = comm, work, out, like

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._comm._unstage(self._out, self._like)


# ---------------------------------------------------------------------------
# Starting a world
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, size: int, backend: str, init_file: str,
               timeout_s: float, devices: Optional[Sequence[str]], args,
               results) -> None:
    torch.set_num_threads(1)
    try:
        device = devices[rank]
        if str(device).startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(Comm(device=device), *args)))
        except Exception:       # reported before the group goes down, so
            # the parent hears of the first failure before its echoes
            results.put((rank, False, traceback.format_exc()))
        finally:
            dist.destroy_process_group()
    except Exception:           # the parent raises it
        results.put((rank, False, traceback.format_exc()))


def _other_failures(results, procs, first: int, wait_s: float = 5.0) -> str:
    """The other ranks' failures that arrive within ``wait_s`` or before
    every rank has exited: a rank that fails often takes its peers'
    collectives down with it."""
    text = ""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            rank, ok, out = results.get(timeout=0.2)
        except queue.Empty:
            if all(p.exitcode is not None for p in procs):
                break
            continue
        if not ok and rank != first:
            text += f"\nrank {rank} failed too:\n{out}"
    return text


def run_world(fn: Callable, size: int, *args, backend: str = "gloo",
              init_file: str, devices: Optional[Sequence[str]] = None,
              timeout_s: float = 60.0, join_s: float = 120.0) -> List[Any]:
    """Run ``fn(comm, *args)`` on ``size`` ranks; return their results in
    rank order.

    Each rank is a process of the ``spawn`` start method with one CPU
    thread, joined to a group of ``backend`` by a ``file://`` rendezvous
    at ``init_file`` (a path that must not exist yet; no network port).
    ``devices[r]`` is rank r's device.  Omitted, the ranks go on the
    card: ``cuda:r`` under nccl, all on ``cuda:0`` under gloo; without a
    card that raises, and CPU ranks ask for ``["cpu"] * size``.  The group's
    collectives time out after ``timeout_s``; if the ranks have not all
    answered within ``join_s``, every child is killed and this raises,
    so a hung collective never hangs the caller.  ``fn`` and ``args``
    must be picklable; so must the results.

    ``backend="nccl"`` needs one card per rank and raises otherwise."""
    import torch.multiprocessing as mp
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if cards < size:
            raise ValueError(f"backend='nccl' needs one card per rank: "
                             f"{size} ranks, {cards} cards")
        if devices is None:
            devices = [f"cuda:{r}" for r in range(size)]
        if len({str(d) for d in devices}) < size:
            raise ValueError("backend='nccl' needs a distinct card per rank")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu'] * size to run the ranks on "
                               "the CPU")
        devices = ["cuda:0"] * size
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for {size} ranks")
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists already")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, backend, init_file, timeout_s,
                               devices, args, results), daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + join_s
    try:
        while len(got) < size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_world: {size - len(got)} of {size} "
                                   f"ranks gave no result within {join_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"run_world: rank(s) {dead} exited "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_world: rank {rank} failed:\n{out}"
                                   + _other_failures(results, procs, rank))
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(size)]
