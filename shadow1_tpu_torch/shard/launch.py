"""Running a function on D ranks of a ``torch.distributed`` world.

The sharded engine (``shard/engine.py``) runs one rank per process. Under
``torchrun`` the world comes from its environment (:func:`init_from_env`);
the tools and the tests start their own ranks here:

* :class:`RankGroup` spawns D processes (``torch.multiprocessing``,
  ``spawn``), each of which joins one process group and then serves calls:
  ``group.call(fn, *args)`` runs ``fn(rank, world, *args)`` on every rank
  and returns rank 0's result. The ranks keep whatever ``fn`` leaves in
  :data:`SLOTS` between calls, so a caller can build an engine once and
  drive it chunk by chunk. A world of one runs in the calling process.
* :func:`launch` is one call on a fresh group.

The rendezvous is a ``FileStore`` in a temporary directory, never a fixed
TCP port, so any number of groups can run side by side on one machine.
The process group gets a timeout (:data:`GROUP_TIMEOUT_S`), so a
collective that some rank never joins fails instead of hanging (rank 0's
writes are waited for at a barrier of their own, :data:`WRITE_TIMEOUT_S`),
and every call has a deadline: when it passes, or when any rank raises,
the parent kills every rank and raises, with the rank's traceback where
there is one.

Backends are chosen by the caller and never by a failure: ``gloo`` on CPU
ranks (``device="cpu"``) or on ranks that share one card
(``device="cuda"``: every rank on ``cuda:0``, the collectives' buffers
copied through host memory), ``nccl`` with one card per rank
(``cuda:RANK``).
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

# A collective that some rank never joins fails after this long.
GROUP_TIMEOUT_S = 30.0
# The ranks that wait for rank 0's host-only work (a snapshot, a state
# file: ``ShardedEngine.on_root``) wait this long.
WRITE_TIMEOUT_S = 3600.0
# A call on a group fails after this long (every rank is then killed).
CALL_DEADLINE_S = 600.0

# Per-process state that a rank's functions keep between calls.
SLOTS: dict = {}


class RankError(RuntimeError):
    """A rank raised, or a call passed its deadline; the ranks are gone."""


def rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, the one card every gloo rank
    shares (``cuda:0``), or the rank's own card under NCCL."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return torch.device("cuda", dev.index or 0)


def check_backend(backend: str, device, world: int) -> None:
    """Refuse a backend that cannot serve ``world`` ranks on ``device``:
    NCCL needs a card per rank, gloo is the way to put several ranks on
    one card. Nothing is redirected."""
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend 'nccl' runs on CUDA ranks; device "
                             f"{dev} needs backend 'gloo'")
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(
                f"backend 'nccl' puts one rank on one card: {world} ranks "
                f"on {n} card(s) would share a device; use backend 'gloo' "
                f"to run {world} ranks on one card")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")


def init_world(backend: str, rank: int, world: int, store_path: str,
               timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join the default process group through a FileStore at
    ``store_path`` (every rank passes the same path)."""
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(backend: str, timeout_s: float = GROUP_TIMEOUT_S
                  ) -> tuple[int, int, int, str | None]:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or, launched alone,
    a world of one rank through a FileStore in a temporary directory.
    Returns (rank, world, local_rank, tmpdir-to-remove-or-None)."""
    import torch.distributed as dist

    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        return rank, world, local, None
    tmp = tempfile.mkdtemp(prefix="shadow1_world_")
    init_world(backend, 0, 1, os.path.join(tmp, "store"), timeout_s)
    return 0, 1, 0, tmp


def _worker(rank, world, backend, device, store_path, timeout_s, threads,
            cmdq, resq):
    """A rank's process: join the group, then serve calls until None."""
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_world(backend, rank, world, store_path, timeout_s)
    except BaseException:  # noqa: BLE001 — reported to the parent
        resq.put((rank, False, traceback.format_exc()))
        return
    resq.put((rank, True, "ready"))
    while True:
        item = cmdq.get()
        if item is None:
            break
        fn, args = item
        try:
            val = fn(rank, world, *args)
            resq.put((rank, True, val if rank == 0 else None))
        except BaseException:  # noqa: BLE001 — reported to the parent
            resq.put((rank, False, traceback.format_exc()))
    SLOTS.clear()
    dist.destroy_process_group()


class RankGroup:
    """D ranks that serve calls (see the module docstring). ``threads``
    sets each rank's intra-op thread count (0: torch's default)."""

    def __init__(self, world: int, backend: str = "gloo",
                 device: str = "cpu", timeout_s: float = GROUP_TIMEOUT_S,
                 deadline_s: float = CALL_DEADLINE_S, threads: int = 1):
        check_backend(backend, device, world)
        self.world, self.backend, self.device = world, backend, device
        self.deadline_s = deadline_s
        self._dir = tempfile.mkdtemp(prefix="shadow1_shard_")
        store = os.path.join(self._dir, "store")
        self._procs: list = []
        self._inproc = world == 1
        if self._inproc:
            # A world of one needs no process of its own.
            import torch.distributed as dist

            if dist.is_initialized():
                raise RuntimeError("a process group already runs in this "
                                   "process")
            init_world(backend, 0, 1, store, timeout_s)
            return
        mp = torch.multiprocessing.get_context("spawn")
        self._cmd = [mp.Queue() for _ in range(world)]
        self._res = mp.Queue()
        for r in range(world):
            p = mp.Process(target=_worker, daemon=True, args=(
                r, world, backend, device, store, timeout_s, threads,
                self._cmd[r], self._res))
            p.start()
            self._procs.append(p)
        self._collect(deadline_s, "start")

    def _collect(self, deadline_s: float, what: str):
        """Every rank's answer to one call; rank 0's value."""
        end = time.monotonic() + deadline_s
        got: dict[int, object] = {}
        while len(got) < self.world:
            left = end - time.monotonic()
            if left <= 0:
                self.close(kill=True)
                raise RankError(f"{what}: ranks {sorted(set(range(self.world)) - set(got))} "
                                f"did not answer within {deadline_s:.0f} s")
            try:
                rank, ok, val = self._res.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in self._procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    self.close(kill=True)
                    raise RankError(f"{what}: a rank exited with code "
                                    f"{dead[0]} without an answer")
                continue
            if not ok:
                self.close(kill=True)
                raise RankError(f"{what}: rank {rank} raised:\n{val}")
            got[rank] = val
        return got[0]

    def call(self, fn, *args, deadline_s: float | None = None):
        """``fn(rank, world, *args)`` on every rank; rank 0's result."""
        if self._inproc:
            return fn(0, 1, *args)
        if not self._procs:
            raise RankError("the rank group is closed")
        for q in self._cmd:
            q.put((fn, args))
        return self._collect(deadline_s or self.deadline_s,
                             getattr(fn, "__name__", "call"))

    def close(self, kill: bool = False) -> None:
        """Stop every rank (at once with ``kill``) and remove the store."""
        if self._inproc:
            import torch.distributed as dist

            SLOTS.clear()
            if dist.is_initialized():
                dist.destroy_process_group()
            self._inproc = False
        procs, self._procs = self._procs, []
        if procs and not kill:
            for q in self._cmd:
                q.put(None)
            for p in procs:
                p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def launch(fn, world: int, *args, backend: str = "gloo",
           device: str = "cpu", timeout_s: float = GROUP_TIMEOUT_S,
           deadline_s: float = CALL_DEADLINE_S, threads: int = 1):
    """One call of ``fn(rank, world, *args)`` on a fresh group of
    ``world`` ranks; rank 0's result."""
    with RankGroup(world, backend, device, timeout_s, deadline_s,
                   threads) as g:
        return g.call(fn, *args)
