"""Party processes joined by a gloo process group (three by default).

The reference runs one party's program on each device of a size-3 ``Mesh``
under ``shard_map`` (``repro/core/secure_model.py::make_secure_infer_mesh``,
``repro/core/secure_transformer.py::make_secure_lm_mesh``); this module is
its counterpart here: one process a party, rank = party id, started with
``torch.multiprocessing`` (``spawn``) and joined by ``torch.distributed``
with the gloo backend.  The parent is the dealer: it hands each rank its
work as a task (a module-level function and its arguments, pickled through
a queue), and collects every rank's answer.

* NCCL refuses two ranks on one card, so on a GPU all three ranks put their
  tensors on the same ``cuda:0``.  Gloo's point-to-point and all-gather take
  CPU tensors only; :class:`~.transport.MeshTransport` stages CUDA tensors
  through pinned host buffers and reports that time apart.
* The group is initialised through a ``file://`` store in a fresh temporary
  directory (no fixed TCP port: concurrent groups never collide), and init
  and every collective carry ``timeout`` seconds.
* A task has a deadline (``deadline`` seconds, or the one passed to
  :meth:`PartyGroup.run`).  A rank that raises sends its traceback back,
  and the parent kills every rank and raises :class:`RankError`; a rank
  that dies, or a task past its deadline, does the same.  A rank blocked in
  a receive from a dead peer is killed with the others, so no failure can
  leave the parent waiting or exit 0.

A task is ``fn(state, *args)``: ``state`` is the rank's dict that lives as
long as the group (``state["rank"]``, ``state["device"]``), where a task
keeps what later tasks need (a model's pairs, a KV cache).  Tensors cross
the queues as CPU tensors in shared memory; a task moves what it receives
to ``state["device"]`` itself.
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
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["PartyGroup", "RankError", "PARTIES"]

PARTIES = 3


class RankError(RuntimeError):
    """A party process failed, died or missed its deadline."""

    def __init__(self, msg: str, rank: int | None = None):
        super().__init__(msg)
        self.rank = rank


def _rank_main(rank: int, world: int, init_file: str, device: str,
               timeout: float, threads: int, tasks, results) -> None:
    """One party's process: join the group, then run tasks until ``None``."""
    try:
        torch.set_num_threads(threads)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: {device} requested and no "
                                   f"CUDA device is visible")
            torch.cuda.set_device(dev)
        state = {"rank": rank, "world": world, "device": dev}
        results.put((rank, "ready", None))
    except BaseException:   # noqa: BLE001 (sent to the parent)
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            out = fn(state, *args)
        except BaseException:   # noqa: BLE001 (sent to the parent)
            results.put((rank, "error", traceback.format_exc()))
            return
        results.put((rank, "ok", out))
    try:
        dist.destroy_process_group()
    except Exception:   # noqa: BLE001 (leaving anyway)
        pass


class PartyGroup:
    """``ranks`` processes (three party processes by default) on
    ``device`` (``"cpu"`` or ``"cuda"``, all ranks on ``cuda:0``), joined
    by a gloo group.  A mesh of 3 x d ranks serves a batch over d data
    shards (``secure_model.make_secure_infer_mesh(..., data=d)``); the
    plaintext launchers run any count (``launch.train --mesh host8``).

    ``timeout``: seconds for the group's init and each collective;
    ``deadline``: default seconds a task may take before every rank is
    killed.  Each rank runs torch with a ``ranks``-th of this process's
    intra-op threads (at least one).  Use as a context manager, or call
    :meth:`close`."""

    def __init__(self, device="cpu", timeout: float = 60.0,
                 deadline: float | None = None, ranks: int = PARTIES):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", 0)
        self.timeout = float(timeout)
        self.deadline = float(deadline if deadline is not None
                              else 2 * timeout)
        if ranks < 1:
            raise ValueError(f"a group of {ranks} ranks")
        self.ranks = int(ranks)
        threads = max(1, torch.get_num_threads() // self.ranks)
        if self.device.type == "cuda":
            # every kernel built here first: the ranks only load the .so
            from ..kernels import build
            build.build_all()
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="party_group_")
        init_file = os.path.join(self._dir, "store")
        self._tasks = [ctx.Queue() for _ in range(self.ranks)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.ranks, init_file, str(self.device),
                              self.timeout, threads, self._tasks[r],
                              self._results))
            for r in range(self.ranks)]
        self.closed = False
        for p in self._procs:
            p.start()
        try:
            self._collect("ready", self.deadline + 60.0)
        except BaseException:
            self.kill()
            raise

    # -- tasks -------------------------------------------------------------
    def run(self, fn, args=None, deadline: float | None = None) -> list:
        """Run ``fn(state, *args[r])`` on every rank ``r`` (``args`` a list
        of a tuple a rank, or one tuple for all); returns the results in
        rank order.  Raises :class:`RankError` (every rank killed) if a
        rank raises, dies or the task outlives its deadline."""
        if self.closed:
            raise RankError("the party group is closed")
        if args is None:
            args = ()
        per_rank = (list(args) if isinstance(args, list)
                    else [tuple(args)] * self.ranks)
        if len(per_rank) != self.ranks:
            raise ValueError(f"args for {len(per_rank)} ranks, expected "
                             f"{self.ranks}")
        for r in range(self.ranks):
            self._tasks[r].put((fn, tuple(per_rank[r])))
        return self._collect("ok", self.deadline if deadline is None
                             else float(deadline))

    def _collect(self, kind: str, deadline: float) -> list:
        out: list = [None] * self.ranks
        got = set()
        end = time.monotonic() + deadline
        while len(got) < self.ranks:
            left = end - time.monotonic()
            if left <= 0:
                self.kill()
                missing = sorted(set(range(self.ranks)) - got)
                raise RankError(f"ranks {missing} missed the "
                                f"{deadline:.0f} s deadline; all ranks "
                                f"killed")
            try:
                rank, status, val = self._results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    codes = [self._procs[r].exitcode for r in dead]
                    self.kill()
                    raise RankError(f"rank(s) {dead} exited (codes {codes}) "
                                    f"without an answer; all ranks killed",
                                    dead[0])
                continue
            if status == "error":
                self.kill()
                raise RankError(f"rank {rank} failed:\n{val}", rank)
            if status != kind:
                self.kill()
                raise RankError(f"rank {rank} answered {status!r}, expected "
                                f"{kind!r}", rank)
            out[rank] = val
            got.add(rank)
        return out

    # -- shutdown ----------------------------------------------------------
    def close(self, wait: float = 20.0) -> None:
        """Stop the ranks (join with ``wait`` seconds, then kill)."""
        if self.closed:
            return
        for q in self._tasks:
            try:
                q.put(None)
            except Exception:   # noqa: BLE001 (killed below if stuck)
                pass
        end = time.monotonic() + wait
        for p in self._procs:
            p.join(max(0.0, end - time.monotonic()))
        self.kill()

    def kill(self) -> None:
        """Kill every rank still alive and drop the store directory."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(5.0)
        self.closed = True
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            if not self.closed:
                self.kill()
        except Exception:   # noqa: BLE001 (interpreter shutdown)
            pass
