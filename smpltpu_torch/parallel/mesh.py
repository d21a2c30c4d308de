"""The frames mesh over ``torch.distributed`` (port of
``smpltpu/parallel/mesh.py``).

The reference shards the leading frame (or window) axis of its arrays over
a ``jax.sharding.Mesh`` inside one program. Here every rank runs the same
program and holds a :class:`FramesMesh`: its rank, the world size, its
device and its own process group. Every collective goes through that
group, never through torch.distributed's default group, so several ranks
can live in one process as threads (the tests) as well as one per process
(the CLIs on the card: an eager fit is bound by the host's launches, and
threads would share one interpreter lock).

A rank on CUDA owns one card and talks over NCCL; ranks on the CPU talk
over gloo through the loopback interface. A group that fails to start is
an error: nothing falls back to one device.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from collections import Counter

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0   # a collective that waits longer ends the run


def mesh_size(n: int, device) -> int:
    """Ranks of a mesh asked for as ``--mesh n``: on CUDA one a card,
    ``min(n, cards)`` (the reference takes ``jax.devices()[:n]``), every
    card for n = 0; on the CPU n ranks, one for n = 0."""
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        return cards if n <= 0 else min(n, cards)
    return max(n, 1)


class FramesMesh:
    """One rank of a mesh of ``size`` ranks over ``store``, on ``device``
    (CUDA: the card ``cuda:rank`` unless an index is given). ``calls``
    counts the collectives this rank issued, by kind."""

    def __init__(self, store, rank: int, size: int, device):
        device = torch.device(device)
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self.group = dist.ProcessGroupNCCL(store, rank, size, opts)
        elif device.type == "cpu":
            opts = dist.ProcessGroupGloo._Options()
            opts._devices = [dist.ProcessGroupGloo.create_device(
                hostname="127.0.0.1")]
            opts._timeout = timeout
            self.group = dist.ProcessGroupGloo(store, rank, size, opts)
        else:
            raise ValueError(f"no collective backend for {device}")
        self.rank, self.size, self.device = rank, size, device
        self.calls: Counter = Counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Release the group's communicators."""
        self.group.shutdown()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (``psum``); every rank gets
        the same bits. One gloo rank returns ``t`` as it is: its all_reduce
        computes nothing and costs a host round trip (~0.6 ms); NCCL runs
        even at one rank, so the card's path is the many-rank one."""
        if self.size == 1 and self.device.type == "cpu":
            return t
        self.calls["all_reduce"] += 1
        self.group.allreduce([t]).wait()
        return t

    def exchange(self, row: torch.Tensor, step: int) -> torch.Tensor:
        """The ring shift of ``ppermute``: send ``row`` to rank + step and
        return the one rank - step sent. Where the partner is this rank
        (one rank), that is ``row`` itself: no backend sends to its own
        rank. Even ranks send first and odd ranks receive first, so two
        ranks that are each other's partners pair their calls."""
        if self.size == 1:
            return row
        row = row.contiguous()
        got = torch.empty_like(row)
        dst, src = (self.rank + step) % self.size, (self.rank - step) % self.size
        tag = 1 if step > 0 else 2
        self.calls["send"] += 1
        self.calls["recv"] += 1
        if self.rank % 2 == 0:
            sent = self.group.send([row], dst, tag)
            recv = self.group.recv([got], src, tag)
        else:
            recv = self.group.recv([got], src, tag)
            sent = self.group.send([row], dst, tag)
        sent.wait()
        recv.wait()
        return got

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0, in
        rank order, on every rank."""
        self.calls["all_gather"] += 1
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self.group.allgather([outs], [t]).wait()
        return torch.cat(outs)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of the leading axis (``P(axis)``)."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"leading axis {n} not divisible by the mesh "
                             f"size {self.size}; pad it")
        k = n // self.size
        return x[self.rank * k:(self.rank + 1) * k]


def frames_mesh(n: int, device, rank: int = 0, store=None) -> FramesMesh:
    """The rank ``rank`` of a mesh of ``mesh_size(n, device)`` ranks. A
    mesh of more than one rank needs the store its ranks share
    (:func:`run_ranks` and ``parallel/launch.py`` make one); a one-rank
    mesh makes its own."""
    size = mesh_size(n, device)
    if store is None:
        if size > 1:
            raise ValueError(f"a mesh of {size} ranks needs the store its "
                             "ranks share")
        store = dist.HashStore()
    return FramesMesh(store, rank, size, device)


def shard_frames(mesh: FramesMesh, x: torch.Tensor) -> torch.Tensor:
    """The rank's block of the leading axis of ``x``."""
    return mesh.shard(x)


def run_ranks(n: int, fn, device="cpu") -> list:
    """``fn(mesh)`` on each rank of an n-rank mesh, the ranks as threads of
    this process over one in-memory store: [rank 0's result, ...]. A rank
    that raises ends the call with its exception (the others, blocked in
    a collective, are left to their group's timeout)."""
    store = dist.HashStore()
    results, errors = [None] * n, [None] * n
    # on the CPU every rank thread runs on one core, with one OpenMP
    # thread: each small torch op hands the interpreter lock to another
    # rank, and across cores those hand-offs dominate (four ranks' fits:
    # 4.7 s spread over the cores, 1.05 s on one)
    core = ({min(os.sched_getaffinity(0))}
            if torch.device(device).type == "cpu" else None)
    if core is None:
        # CUDA's linear-algebra library loads on first use, and two
        # threads loading it at once fail ("lazy wrapper should be called
        # at most once"): load it here, before the ranks start
        torch.linalg.inv_ex(torch.eye(2, device=device))

    def rank_main(r):
        try:
            with FramesMesh(store, r, n, device) as mesh:
                if core is not None:
                    # this thread only: the group's own threads, started
                    # above, keep every core (on one core the ring's sends
                    # wait ~4 ms each for them)
                    os.sched_setaffinity(0, core)
                    torch.set_num_threads(1)
                results[r] = fn(mesh)
        except BaseException as e:  # handed to the caller below
            errors[r] = e

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + TIMEOUT_S
    while any(t.is_alive() for t in threads):
        if any(e is not None for e in errors):
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"run_ranks: ranks still running after "
                               f"{TIMEOUT_S} s")
        time.sleep(0.005)
    for e in errors:
        if e is not None:
            raise e
    return results
