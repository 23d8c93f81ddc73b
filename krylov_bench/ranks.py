"""Cells on more than one card: one rank process a card under
``torch.distributed``.

The process that the benchmark's command starts is rank 0, on ``cuda:0``.
It builds the port's kernels once, then starts ``chips - 1`` followers of
the same entry point (its own arguments, with ``--rank r --rendezvous
<dir>``), rank r on ``cuda:r``.  The ranks meet through a file store in a
temporary directory under ``TMPDIR``.  The solves run on the port's own
``row_mesh("nccl")``.  A separate gloo group carries the harness's flags
(continue or stop after each timed solve, whether a trace is taken again,
the memory peak), so that none of them enters a device trace.

Failure: rank 0 watches its followers, and one that exits with another
code than 0 makes rank 0 kill the others and exit with ``FOLLOWER_FAILED``
at once.  A follower exits as soon as rank 0, its parent, is gone.  Every
collective gives up after ``COLLECTIVE_TIMEOUT`` seconds.  On the CPU (the
tests) the same ranks run over gloo alone.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = 120.0      # seconds a collective may wait
POLL_S = 0.2                    # how often a watchdog looks
FOLLOWER_FAILED = 4             # rank 0's exit code when a follower fails
PARENT_GONE = 5                 # a follower's exit code when rank 0 is gone


def rank_device(device: str, rank: int) -> str:
    """Rank ``rank``'s device: its own card, or the CPU for every rank."""
    return f"cuda:{rank}" if device == "cuda" else device


class Followers:
    """Ranks 1 to ``world - 1``: processes of ``script`` with ``argv`` and
    their rank, whose standard output goes to rank 0's standard error (only
    rank 0 prints a result); and the watchdog that ends rank 0 when one of
    them fails."""

    def __init__(self, script, argv, world: int):
        self._dir = tempfile.TemporaryDirectory(prefix="kb_ranks_")
        self.rendezvous = self._dir.name
        sys.stderr.flush()
        self.procs = [subprocess.Popen(
            [sys.executable, str(script), *argv, "--rank", str(r),
             "--rendezvous", self.rendezvous], stdout=sys.stderr.fileno())
            for r in range(1, world)]
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code not in (None, 0):
                    print(f"rank {r} exited with code {code}: the run fails",
                          file=sys.stderr, flush=True)
                    self.stop()
                    os._exit(FOLLOWER_FAILED)

    def wait(self, timeout: float = COLLECTIVE_TIMEOUT):
        """Wait until every follower has ended; raise where one failed or
        is still running after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        for r, p in enumerate(self.procs, 1):
            code = p.wait(timeout=max(deadline - time.monotonic(), POLL_S))
            if code != 0:
                raise RuntimeError(f"rank {r} exited with code {code}")

    def stop(self):
        """End the watchdog, kill every follower still running and wait for
        each; remove the rendezvous directory."""
        self._done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        self._dir.cleanup()


def watch_parent():
    """In a follower: exit at once when rank 0, the parent, is gone."""
    parent = os.getppid()

    def loop():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(PARENT_GONE)

    threading.Thread(target=loop, daemon=True).start()


class Ranks:
    """This rank's place in the team: the port's mesh (NCCL between cards,
    gloo on the CPU), the gloo group of the harness's flags, and the
    harness's few collectives."""

    def __init__(self, rank: int, world: int, rendezvous: str, device: str):
        from iterativesolvers_tpu_torch.parallel import row_mesh

        self.rank, self.world = int(rank), int(world)
        self.device = device
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.set_device(torch.device(device))
        self.mesh = row_mesh(
            "nccl" if cuda else "gloo", device,
            init_method=f"file://{rendezvous}/store", rank=self.rank,
            world_size=self.world, timeout=COLLECTIVE_TIMEOUT)
        self.control = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def _reduce(self, value: int, op) -> int:
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=op, group=self.control)
        return int(t)

    def share(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank (the others' is ignored)."""
        t = torch.tensor([int(go)], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.control)
        return bool(t)

    def largest(self, value: int) -> int:
        return self._reduce(value, dist.ReduceOp.MAX)

    def all(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank."""
        return bool(self._reduce(flag, dist.ReduceOp.MIN))

    def local_rows(self, pool):
        """This rank's rows of each right-hand side of ``pool`` (one a
        row), as one contiguous ``(pool, rows / world)`` tensor."""
        lo, hi = self.mesh.rows(pool.shape[1])
        return pool[:, lo:hi].contiguous()

    def gather(self, x):
        """The whole vector from every rank's rows (each rank gets it)."""
        from iterativesolvers_tpu_torch.parallel import gather_vector

        return gather_vector(x, self.mesh)

    def close(self):
        dist.barrier(group=self.control)
        self.mesh.close()


def team_run(script, argv, world: int, device: str, rank: int, rendezvous,
             body):
    """``body(ranks)`` on this rank of a team of ``world`` ranks.  Rank 0
    (``rank`` 0) builds the port's kernels on a card, starts the followers,
    and after ``body`` waits until each has ended; a follower (``rank`` > 0,
    started with the ``rendezvous`` directory) watches its parent.  Returns
    what ``body`` returns."""
    if rank:
        watch_parent()
        return body(Ranks(rank, world, rendezvous, rank_device(device, rank)))
    if device == "cuda":
        from iterativesolvers_tpu_torch.ops import _build

        _build.build_all()          # once here, not in every rank
    team = Followers(script, argv, world)
    try:
        value = body(Ranks(0, world, team.rendezvous, rank_device(device, 0)))
        team.wait()
    finally:
        team.stop()
    return value
