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
  psum_scatter    (p*C, ...) per rank -> block r of the sum on rank r
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
``pmax``, and the input of ``psum_scatter``) and the host seconds spent
in them (a gloo collective returns when it is done, so those are its
seconds; under nccl, the time to enqueue it).  Compute stays on the
rank's device either way.  Nothing switches backend when something
fails.

``bytes_by_kind`` counts every collective by kind with the result-shape
accounting of the JAX package's ``launch/hlo_analysis.py``: an
all-reduce its full buffer, an all-gather its gathered output, a
reduce-scatter its scattered output, an all-to-all its buffer, a
broadcast its buffer; an async all-to-all once, when it starts.
``seconds_by_kind`` holds the host seconds spent in each kind.

``DryComm`` is a rank of a group whose other ranks do not exist: the
dry-run's stand-in (``launch/dryrun.py``), which counts the same bytes.
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
#: the JAX package's collective kinds (``launch/hlo_analysis.py``)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: the kinds ``Comm`` counts: those, and the broadcast
KINDS = COLLECTIVES + ("broadcast",)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counted:
    """The per-kind counters ``Comm`` and ``DryComm`` share."""

    def _zero_counts(self) -> None:
        self.bytes_by_kind = dict.fromkeys(KINDS, 0)
        self.seconds_by_kind = dict.fromkeys(KINDS, 0.0)

    def _count(self, kind: str, n: int, t0: float) -> None:
        self.bytes_by_kind[kind] += n
        self.seconds_by_kind[kind] += time.perf_counter() - t0


class Comm(_Counted):
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
        self._zero_counts()

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
        t0 = time.perf_counter()
        t = t.contiguous()
        x = self._stage(t)
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.detach(), group=self.group)
        out = self._unstage(out, t)
        self._count("all-gather", nbytes(out), t0)
        return out

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        t = torch.as_tensor(t).contiguous()
        self.reduce_bytes += nbytes(t)
        x = self._stage(t)
        x = x.clone() if x is t else x
        dist.all_reduce(x, op=op, group=self.group)
        out = self._unstage(x, t)
        self.reduce_s += time.perf_counter() - t0
        self._count("all-reduce", nbytes(out), t0)
        return out

    def psum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """(p*C, ...) on every rank -> rows [r*C, (r+1)*C) of their sum on
        rank r (a reduce-scatter)."""
        if t.shape[0] % self.size:
            raise ValueError(f"psum_scatter: {t.shape[0]} rows do not split "
                             f"into {self.size} ranks")
        t0 = time.perf_counter()
        t = t.contiguous()
        self.reduce_bytes += nbytes(t)
        x = self._stage(t)
        out = torch.empty((x.shape[0] // self.size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.detach(), group=self.group)
        out = self._unstage(out, t)
        self.reduce_s += time.perf_counter() - t0
        self._count("reduce-scatter", nbytes(out), t0)
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
        t0 = time.perf_counter()
        t = t.contiguous()
        x = self._stage(t)
        x = x.clone() if x is t else x
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        dist.broadcast(x, src=src, group=self.group)
        out = self._unstage(x, t)
        self._count("broadcast", nbytes(out), t0)
        return out

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
        t0 = time.perf_counter()
        t = t.contiguous()
        self.all_to_all_bytes += nbytes(t)
        x = self._stage(t)
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.group,
                                      async_op=True)
        self._count("all-to-all", nbytes(t), t0)
        return PendingAllToAll(self, work, out, t)


class PendingAllToAll:
    """An ``all_to_all`` in flight."""

    def __init__(self, comm: Comm, work, out: torch.Tensor,
                 like: torch.Tensor):
        self._comm, self._work, self._out, self._like = comm, work, out, like

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._comm._unstage(self._out, self._like)


#: HLO's names of the types a collective carries
_HLO_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
              torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
              torch.int64: "s64", torch.bool: "pred"}


def hlo_shape(t: torch.Tensor) -> str:
    """``t``'s type and dims as HLO writes a result shape: ``bf16[4,128]``."""
    return f"{_HLO_TYPES[t.dtype]}[{','.join(str(d) for d in t.shape)}]"


class DryComm(_Counted):
    """Rank ``rank`` of a group of ``size`` ranks whose other ranks do not
    exist: the dry-run's stand-in for ``Comm`` (only
    ``launch/dryrun.py`` uses it; training and serving never fall back to
    it).  Each collective returns a tensor of the shape the real one
    returns and counts the same bytes by kind (``bytes_by_kind``,
    ``reduce_bytes``, ``all_to_all_bytes``).  On the meta device it
    carries no data.  Elsewhere it returns loopback data: an all-reduce
    (and a broadcast, an all-to-all) a copy of its input, an all-gather
    its input tiled ``size`` times, a reduce-scatter the rank's block of
    its input.  Those values mean nothing: a step over ``DryComm`` has a
    real step's shapes, collectives and memory, not its numbers.

    Under the profiler each collective is one ``record_function`` span
    named ``dry_comm::<kind> <result shape>`` (``hlo_shape``), which
    ``launch.hlo_analysis.collective_bytes`` reads as it reads a real
    group's c10d events."""

    backend = "dry"

    def __init__(self, rank: int, size: int, *, device=None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.rank, self.size, self.group = rank, size, None
        self.device = None if device is None else torch.device(device)
        self.staged_bytes = 0
        self.all_to_all_bytes = 0
        self.reduce_bytes = 0
        self.reduce_s = 0.0
        self._zero_counts()

    def _done(self, kind: str, out: torch.Tensor, t0: float
              ) -> torch.Tensor:
        self._count(kind, nbytes(out), t0)
        return out

    def _span(self, kind: str, out_shape, dtype):
        shape = ",".join(str(d) for d in out_shape)
        return torch.profiler.record_function(
            f"dry_comm::{kind} {_HLO_TYPES[dtype]}[{shape}]")

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        t = t.contiguous()
        shape = (self.size * t.shape[0],) + tuple(t.shape[1:])
        with self._span("all-gather", shape, t.dtype):
            out = t.repeat((self.size,) + (1,) * (t.dim() - 1))
        return self._done("all-gather", out, t0)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        t = torch.as_tensor(t).contiguous()
        self.reduce_bytes += nbytes(t)
        with self._span("all-reduce", t.shape, t.dtype):
            out = t.clone()
        self.reduce_s += time.perf_counter() - t0
        return self._done("all-reduce", out, t0)

    psum = pmin = pmax = _all_reduce

    def psum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % self.size:
            raise ValueError(f"psum_scatter: {t.shape[0]} rows do not split "
                             f"into {self.size} ranks")
        t0 = time.perf_counter()
        t = t.contiguous()
        self.reduce_bytes += nbytes(t)
        n = t.shape[0] // self.size
        with self._span("reduce-scatter", (n,) + tuple(t.shape[1:]),
                        t.dtype):
            out = t.narrow(0, self.rank * n, n).clone()
        self.reduce_s += time.perf_counter() - t0
        return self._done("reduce-scatter", out, t0)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        t0 = time.perf_counter()
        with self._span("broadcast", t.shape, t.dtype):
            out = t.contiguous().clone()
        return self._done("broadcast", out, t0)

    def barrier(self) -> None:
        pass

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_to_all_async(t).wait()

    def all_to_all_async(self, t: torch.Tensor) -> "_Ready":
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: {t.shape[0]} rows do not split "
                             f"into {self.size} ranks")
        t0 = time.perf_counter()
        self.all_to_all_bytes += nbytes(t)
        with self._span("all-to-all", t.shape, t.dtype):
            out = t.contiguous().clone()
        return _Ready(self._done("all-to-all", out, t0))


class _Ready:
    """A ``DryComm`` all-to-all: done when it starts."""

    def __init__(self, out: torch.Tensor):
        self._out = out

    def wait(self) -> torch.Tensor:
        return self._out


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
