"""The trainer service's ranks: one process group for the life of a service.

``RankGroup(n, device=...)`` makes the calling process rank 0 of an
``n``-rank group and spawns ranks 1…n-1 as child processes, joined
through a ``FileStore`` in a fresh directory under ``store_dir`` (no
fixed port).  Each rank holds the ``(n × 1)`` data-parallel mesh
(``parallel.mesh.create_mesh``) and a ``TrainerService`` on it; rank 0's
is the caller's, which holds the server and the registry.  A round
(``run_round``) goes:

1. rank 0 wakes every helper over its pipe and broadcasts the session
   (the staged shard paths, the run's key and scheduler id) in one
   ``broadcast_object``;
2. every rank runs ``TrainerService._train_models`` on the same shards
   with the same seeds, so every rank makes the same collectives in the
   same order and the same skip decisions (the row counts every rank
   reads decide them); each trainer takes this rank's slice of every
   global batch;
3. one ``all_gather_object`` hands rank 0 every rank's summary
   (``summary``: rows, metrics, losses, registry calls, kernel launches
   and the digests of its trained parameters), which lands in
   ``TrainRun.ranks``.

A helper whose round raises sends its error over its pipe and exits; the
collective rank 0 is in then fails, and the round fails on rank 0 with
the helper's error.  Any failure of a round tears the group down (the
helpers are terminated, the process group destroyed) and the next round
starts a new one, so no rank is ever left inside a collective that
another skipped.  Rounds run one at a time on the group's own thread in
rank 0's process.  ``close()`` sends the stop message and destroys the
group.  Helpers ask the kernel to SIGKILL them when rank 0 dies
(``PR_SET_PDEATHSIG``) and also watch its pid, so none outlives rank 0
holding a card.

The backend is NCCL when each rank has a card of its own and gloo
otherwise: on the CPU, and for more ranks than cards, where every rank
shares ``cuda:0`` (NCCL refuses two ranks on one device).  Helpers idle
between rounds on their pipe, not in a collective, so a serving group
never reaches the group's timeout while it waits for an upload.
"""

from __future__ import annotations

import ctypes
import datetime
import logging
import os
import queue
import shutil
import signal
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from . import mesh as pm

logger = logging.getLogger(__name__)

_STOP = "stop"
_TRAIN = "train"
_WAKE = "wake"
_PR_SET_PDEATHSIG = 1


@dataclass(frozen=True)
class RankPlan:
    """How ``world`` ranks sit on the machine: ``backend`` for the group
    and ``devices[r]`` for rank ``r``."""

    world: int
    backend: str
    devices: tuple


def plan_ranks(device="cuda", nproc: Optional[int] = None) -> RankPlan:
    """One rank per visible card (``torch.cuda.device_count()``) for a
    CUDA ``device``, one rank for the CPU, unless ``nproc`` names the
    count.  NCCL when every rank has a card of its own, else gloo (all
    ranks on ``cuda:0``, or on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        world = nproc if nproc else max(cards, 1)
        if world <= cards:
            return RankPlan(world, "nccl", tuple(f"cuda:{r}" for r in range(world)))
        return RankPlan(world, "gloo", tuple("cuda:0" for _ in range(world)))
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    world = nproc if nproc else 1
    return RankPlan(world, "gloo", tuple("cpu" for _ in range(world)))


class _RankRegistry:
    """A helper rank's registry: it publishes nothing; it counts the calls
    a helper should never make (rank 0 alone registers)."""

    def __init__(self) -> None:
        self.calls = 0

    def create_model(self, **kwargs):
        self.calls += 1
        from types import SimpleNamespace

        return SimpleNamespace(id=f"rank-local-{self.calls}", **kwargs)


def _die_with_parent() -> None:
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except (OSError, AttributeError):
        pass  # not Linux: the pid watch below still ends the helper


def _wait_for_wake(conn, parent: int) -> bool:
    """Block until rank 0 wakes this helper; False once rank 0 is gone."""
    while not conn.poll(1.0):
        if os.getppid() != parent:
            return False
    try:
        return conn.recv() == _WAKE
    except EOFError:
        return False


def _helper_main(rank: int, world: int, device: str, backend: str, store_path: str,
                 timeout_s: float, conn, service_kwargs: dict,
                 rank_init: Optional[Callable]) -> None:
    """Rank ``rank`` of a ``RankGroup``: join, then train each session
    rank 0 broadcasts until the stop message."""
    _die_with_parent()
    parent = os.getppid()
    dev = torch.device(device)
    if dev.type == "cpu":
        # The ranks share the host's cores.
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    try:
        conn.send(("up", rank))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        )
        mesh = pm.create_mesh(pm.MeshSpec(data=world, model=1), device=dev, backend=backend)
        if rank_init is not None:
            rank_init(rank)
        from ..trainer.service import TrainerService

        registry = _RankRegistry()
        service = TrainerService(registry, mesh=mesh, device=dev, **service_kwargs)
        while _wait_for_wake(conn, parent):
            msg = pm.broadcast_object(mesh, None)
            if msg["op"] == _STOP:
                break
            calls = registry.calls
            run = service.train_session(msg)
            pm.all_gather_object(mesh, service.summary(run, registry.calls - calls))
    except BaseException as exc:  # noqa: BLE001 — the helper's error goes to rank 0
        try:
            conn.send(("error", f"{type(exc).__name__}: {exc}"))
        finally:
            os._exit(1)
    dist.destroy_process_group()


class RankGroup:
    """Ranks 0…n-1 of a ``TrainerService``, rank 0 in this process (module
    docstring).  ``device`` is rank 0's device family (``"cuda"`` or
    ``"cpu"``); the ranks sit as ``plan_ranks(device, n)`` places them.
    ``store_dir`` holds the group's ``FileStore`` (a temporary directory
    when ``None``).  ``rank_init(rank)``, a module-level function, runs in
    each spawned rank once it has joined, before its service is made.  The
    group starts at the first round, or at ``start(service_kwargs)``; each
    helper's service is made from rank 0's ``rank_service_kwargs()`` (its
    ``train_config`` and ``gnn_model``)."""

    def __init__(self, n: int, *, device="cuda", store_dir: Optional[str] = None, timeout_s: float = 300.0,
                 rank_init: Optional[Callable] = None) -> None:
        if n < 2:
            raise ValueError(f"a RankGroup needs 2 or more ranks, got {n}")
        self.plan = plan_ranks(device, n)
        self.world = n
        self.store_dir = store_dir
        self.timeout_s = timeout_s
        self.rank_init = rank_init
        self.mesh: Optional[pm.Mesh] = None
        self.generation = 0
        # Rounds, the start and the close run one at a time on the group's
        # own thread (``_submit``): every collective rank 0 makes comes
        # from that one thread, in the order the jobs arrived, and no
        # caller holds a lock while it waits for them.
        self._jobs: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._worker_mu = threading.Lock()
        self._in_round = threading.Event()
        self._tmp: Optional[str] = None
        self._procs: list = []
        self._conns: list = []
        self._service_kwargs: dict = {}

    @property
    def device(self) -> torch.device:
        return torch.device(self.plan.devices[0])

    # -- lifecycle -----------------------------------------------------------

    def _submit(self, fn, *args):
        """Run ``fn(*args)`` on the group's thread; → its value, or raise
        what it raised."""
        with self._worker_mu:
            if self._worker is None:
                self._worker = threading.Thread(target=self._work, name="rank-group",
                                                daemon=True)
                self._worker.start()
        done = threading.Event()
        box: dict = {}

        def job():
            try:
                box["value"] = fn(*args)
            except BaseException as exc:  # noqa: BLE001 — re-raised in the caller
                box["error"] = exc
            finally:
                done.set()

        self._jobs.put(job)
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def _work(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job()

    def start(self, service_kwargs: Optional[dict] = None) -> pm.Mesh:
        """Spawn the helpers and join the group (a no-op while it is up)."""
        return self._submit(self._start, service_kwargs)

    def _start(self, service_kwargs: Optional[dict]) -> pm.Mesh:
        if self.mesh is not None:
            return self.mesh
        if dist.is_initialized():
            raise RuntimeError(
                "RankGroup makes this process rank 0 of the default process group, "
                "and one is initialized already"
            )
        import torch.multiprocessing as mp

        if service_kwargs is not None:
            self._service_kwargs = dict(service_kwargs)
        if self.store_dir is not None:
            os.makedirs(self.store_dir, exist_ok=True)
        self._tmp = tempfile.mkdtemp(prefix="df_ranks_", dir=self.store_dir)
        store_path = os.path.join(self._tmp, "store")
        ctx = mp.get_context("spawn")
        self.generation += 1
        try:
            for rank in range(1, self.world):
                ours, theirs = ctx.Pipe()
                proc = ctx.Process(
                    target=_helper_main, name=f"trainer-rank-{rank}", daemon=True,
                    args=(rank, self.world, self.plan.devices[rank], self.plan.backend,
                          store_path, self.timeout_s, theirs, self._service_kwargs,
                          self.rank_init),
                )
                proc.start()
                theirs.close()
                self._procs.append(proc)
                self._conns.append(ours)
            for rank, conn in enumerate(self._conns, start=1):
                msg = self._recv(conn, rank, self.timeout_s)
                if msg[0] != "up":
                    raise RuntimeError(f"rank {rank} failed to start: {msg[1]}")
            dev = self.device
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                self.plan.backend, store=dist.FileStore(store_path, self.world), rank=0,
                world_size=self.world, timeout=datetime.timedelta(seconds=self.timeout_s),
            )
            self.mesh = pm.create_mesh(pm.MeshSpec(data=self.world, model=1), device=dev,
                                       backend=self.plan.backend)
        except BaseException:
            self._teardown()
            raise
        return self.mesh

    def _recv(self, conn, rank: int, timeout_s: float):
        proc = self._procs[rank - 1]
        waited = 0.0
        while not conn.poll(0.5):
            waited += 0.5
            if not proc.is_alive() or waited >= timeout_s:
                return ("error", f"exited with code {proc.exitcode}"
                        if not proc.is_alive() else f"silent for {timeout_s:.0f} s")
        try:
            return conn.recv()
        except EOFError:
            proc.join(5.0)
            return ("error", f"exited with code {proc.exitcode}")

    def _helper_errors(self) -> List[str]:
        """Errors the helpers reported.  A helper whose round failed reports
        and exits at once; one blocked in a collective that rank 0 left is
        still alive after the short wait, and reports nothing."""
        errors = []
        deadline = time.monotonic() + 3.0
        for rank, (proc, conn) in enumerate(zip(self._procs, self._conns), start=1):
            proc.join(max(deadline - time.monotonic(), 0.0))
            msg = None
            if conn.poll(0):
                try:
                    msg = conn.recv()
                except EOFError:
                    pass  # dflint: disable=DF001 — the exit code below speaks
            if msg is not None and msg[0] == "error":
                errors.append(f"rank {rank}: {msg[1]}")
            elif not proc.is_alive() and proc.exitcode:
                errors.append(f"rank {rank}: exited with code {proc.exitcode}")
        return errors

    def _teardown(self) -> None:
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self._procs:
            proc.join(10.0)
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if self.mesh is not None or dist.is_initialized():
            try:
                dist.destroy_process_group()
            except (RuntimeError, ValueError):
                pass  # dflint: disable=DF001 — the group is gone either way
        self.mesh = None
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def close(self) -> None:
        """Stop the helpers and destroy the group.  A round still running
        on another thread is cut: its helpers are terminated, and the
        round fails on rank 0."""
        if self._in_round.is_set():
            for proc in list(self._procs):
                if proc.is_alive():
                    proc.terminate()
        with self._worker_mu:
            worker = self._worker
        if worker is None:
            return
        self._submit(self._close)
        self._jobs.put(None)
        worker.join()
        with self._worker_mu:
            self._worker = None

    def _close(self) -> None:
        if self.mesh is None:
            return
        try:
            for conn in self._conns:
                conn.send(_WAKE)
            pm.broadcast_object(self.mesh, {"op": _STOP})
            for proc in self._procs:
                proc.join(10.0)
        except (OSError, RuntimeError) as exc:
            logger.warning("rank group: stopping the helpers failed: %s", exc)
        self._teardown()

    @property
    def helper_pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    # -- rounds --------------------------------------------------------------

    def run_round(self, service, run, session) -> None:
        """Train ``session`` on every rank (module docstring); rank 0's
        share runs ``service._train_models``.  Raises (after tearing the
        group down) when any rank fails, naming the helper's error."""
        self._submit(self._round, service, run, session)

    def _round(self, service, run, session) -> None:
        mesh = self._start(service.rank_service_kwargs())
        msg = {
            "op": _TRAIN, "key": run.key, "scheduler_id": run.scheduler_id,
            "host_key": session.host_key,
            "download_shards": list(session.download_shards),
            "topology_shards": list(session.topology_shards),
        }
        self._in_round.set()
        try:
            for conn in self._conns:
                conn.send(_WAKE)
            pm.broadcast_object(mesh, msg)
            service._train_models(run, session, mesh)
            run.ranks = pm.all_gather_object(mesh, service.summary(run, len(run.models)))
        except BaseException as exc:
            errors = self._helper_errors()
            self._teardown()
            if errors:
                raise RuntimeError("; ".join(errors)) from exc
            raise
        finally:
            self._in_round.clear()
