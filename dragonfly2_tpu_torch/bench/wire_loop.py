"""The port's deployment over real sockets: manager REST, the trainer's
and the scheduler's serve compositions, peers as ``RemoteScheduler``
clients.

Every arrow is an HTTP wire, as in the JAX package's
``tests/test_rpc.py`` ``TestFullWireLoop`` without the peer daemons:

    peers (RemoteScheduler) ──HTTP──▶ scheduler serve mode (K1 ranks parents)
        → Download / topology records (DFC1) → Announcer
        ──HTTP chunked upload──▶ trainer serve mode (MLP + GAT with K3)
        ──RemoteRegistry──▶ manager REST (models, schedulers, topology)
        ◀──ModelSubscriber poll── the scheduler hot-swaps the trained scorer

``run(parse_args([...]))`` boots, in one process: a ``ManagerRESTServer``,
``cli.trainer.serve`` (``gnn_model="gat"``, models registered through
``RemoteRegistry``), ``cli.scheduler.serve`` with algorithm ``ml``, the
probe store, a seed-made 32→64→64→1 scorer blob (K1 ranks its announces
until a subscription swaps in the trained model), the manager link and
the trainer link, and a second, rule-ranking scheduler (algorithm
``default``) for the comparison.  Every server binds port 0.  Then:

1. downloads of ``SyntheticCluster`` hosts through one ``RemoteScheduler``
   per host (a daemon's client), from ``--clients`` threads: register
   (and set the task's length when the task is new), every piece from the
   scheduled parents with costs from the cluster's latent bandwidth
   (``sim/swarm.py``'s model; the source at half the child's capacity
   without parents) reported in one batched call, finished; each task is
   first seeded by 2 downloads, as ``SwarmSimulator.run_downloads`` does;
2. probe rounds through ``sync_probes_start`` / ``sync_probes_finished``
   with the cluster's RTTs; then the probe graph is snapshotted into the
   scheduler's record storage (``SwarmSimulator.snapshot_topology``'s
   step: the reference's serve mode has no collect loop that would);
3. the Announcer's next round after the snapshot uploads the shards; the
   trainer trains both models and registers them in the manager (rounds
   that started earlier, while the downloads ran, train on what was
   written by then and are reported apart); the Announcer is then stopped;
4. parent choice over ``--trials`` trials: each trial registers 8 random
   candidate hosts on a fresh task (each downloads and finishes), then a
   child host; the first parent ``register_peer`` returns is scored by
   the cluster's ground-truth bandwidth (MB/s).  Run on the ML scheduler
   with the seed-made K1 scorer, then after the trained MLP is activated
   over REST and the subscription has installed it, and on the rule
   scheduler.

With ``--lifecycle`` the same deployment closes its loop with no human
step (DESIGN.md §29): the trainer serves the lifecycle daemon
(``lifecycle.enable``, ``--lifecycle-interval``) for the scheduler's id,
which ``run`` fixes before either boots by reserving the scheduler's
port; the manager serves a ``RolloutController`` (the reference's
guardrails but the drift ceiling, which is off: PERF.md §4); the
scheduler shadow-scores
every announce into ``storage.dir/shadow_replay.dfc`` and reports every
``--report-interval``.  Steps 2-3 are replaced: after the seed-made
scorer's parent choice, downloads run until a candidate the daemon
registered has walked SHADOW → CANARY → ACTIVE (nobody calls
``:activate``) and the subscription has installed it; then the reporter,
the Announcer and the daemon stop, and parent choice runs on the
installed model and on the rules.  The summary's ``walk`` holds the
controller's decisions, the rollout row as ``GET /api/v1/rollouts:get``
showed it every 50 ms, what the subscriber attached for the promoted
version and the transition times; ``rows`` the rows uploaded, fed to the
daemon, and logged, on disk and read by the reporter; ``k1`` K1's
launches and the fused flushes before and after the install.

``boot_binary`` starts ``python -m dragonfly2_tpu_torch.cli.{scheduler,
trainer}`` in serve mode as a child process, waits for its URL, sends one
request and stops it with SIGINT (exit 0 expected).

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints one JSON line.

    python -m dragonfly2_tpu_torch.bench.wire_loop [--downloads 4000] [--lifecycle] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=1000)
    ap.add_argument("--downloads", type=int, default=4000)
    ap.add_argument("--tasks", type=int, default=64)
    ap.add_argument("--probe-rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=16, help="client threads")
    ap.add_argument("--sequential", type=int, default=256,
                    help="downloads from one client after the concurrent ones "
                         "(the uncontended per-request breakdown)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--train-interval", type=float, default=60.0,
                    help="the Announcer's upload interval (trainer.interval_s)")
    ap.add_argument("--model-poll", type=float, default=1.0,
                    help="the subscription's poll interval (scheduling.model_poll_interval_s)")
    ap.add_argument("--epochs", type=int, default=30, help="the trainer's training.epochs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for records and staging "
                    "(default: a fresh temporary directory, deleted after)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds any one wait of the run may take")
    ap.add_argument("--device", default="cuda")
    lc = ap.add_argument_group(
        "lifecycle", "--lifecycle: the trainer runs the lifecycle daemon, the manager "
        "a RolloutController, and the downloads run until a candidate of the daemon "
        "is ACTIVE and installed (--downloads and --timeout cap them)")
    lc.add_argument("--lifecycle", action="store_true")
    lc.add_argument("--lifecycle-interval", type=float, default=2.0,
                    help="the daemon's cycle (lifecycle.interval_s)")
    lc.add_argument("--report-interval", type=float, default=5.0,
                    help="scheduling.rollout_report_interval_s")
    return ap.parse_args(argv)


def seeded_k1_blob(seed: int) -> bytes:
    """A seed-made 32→64→64→1 scorer artifact (the one shape K1 serves),
    scale 0.3 / 0.05 as ``chip_smoke.weights_from_seed``."""
    from ..trainer.export import MLPScorer, scorer_to_bytes

    rng = np.random.default_rng(seed)
    dims = (32, 64, 64, 1)
    weights = [
        (rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
         rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
        for i in range(len(dims) - 1)
    ]
    return scorer_to_bytes(MLPScorer(weights=weights))


def _pool(n_threads: int, items, fn) -> None:
    """``fn(item)`` for every item over ``n_threads`` threads (item i on
    thread i % n_threads, in order); re-raises the first failure."""
    errors = []

    def worker(t: int) -> None:
        try:
            for item in items[t::n_threads]:
                fn(item)
        except Exception as exc:  # re-raised on the calling thread after join
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


class Swarm:
    """The peers: ``SyntheticCluster`` hosts, each with its own
    ``RemoteScheduler`` per scheduler URL, downloading over the wire."""

    def __init__(self, num_hosts: int, seed: int) -> None:
        from ..records.synthetic import PIECE_SIZE, SyntheticCluster
        from ..sim.swarm import host_from_latent

        self.piece_size = PIECE_SIZE
        self.cluster = SyntheticCluster(num_hosts=num_hosts, seed=seed)
        self.hosts = [host_from_latent(lh) for lh in self.cluster.hosts]
        self.index = {h.id: i for i, h in enumerate(self.hosts)}
        self.seed = seed
        self._clients = {}
        self._mu = threading.Lock()
        self.latency = {}  # method → client round trips (s)
        self.started = {}  # method → host times the calls started

    def client(self, url: str, i: int):
        from ..rpc import RemoteScheduler

        with self._mu:
            c = self._clients.get((url, i))
            if c is None:
                c = self._clients[(url, i)] = RemoteScheduler(url, timeout=60.0)
            return c

    def _timed(self, method: str, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        dt = time.perf_counter() - t0
        with self._mu:
            self.latency.setdefault(method, []).append(dt)
            self.started.setdefault(method, []).append(t0)
        return out

    def clear_latency(self) -> None:
        with self._mu:
            self.latency.clear()
            self.started.clear()

    def download(self, url: str, child: int, task_url: str, pieces: int, key) -> object:
        """One download of ``task_url`` by host ``child`` (``sim/swarm.py``'s
        ``simulate_download`` over the wire); ``key`` seeds its bandwidth
        noise.  Returns the register result."""
        from ..scheduler import ScheduleResultKind

        client = self.client(url, child)
        host = self.hosts[child]
        res = self._timed("register_peer", client.register_peer, host=host, url=task_url)
        peer = res.peer
        task = peer.task
        if task.content_length < 0:
            # The first peer learns the content length from the origin.
            self._timed("set_task_info", client.set_task_info, peer,
                        pieces * self.piece_size, pieces, self.piece_size)
        n = task.total_piece_count
        sched = res.schedule
        if sched is not None and sched.kind is ScheduleResultKind.PARENTS:
            parents = sched.parents
            p_idx = np.array([self.index[parents[k % len(parents)].host.id] for k in range(n)])
            bw = self.cluster._bandwidth_vec(
                p_idx, np.full(n, child), rng=np.random.default_rng(key))
            ids = [parents[k % len(parents)].id for k in range(n)]
        else:
            # Back to source: the origin serves at half the child's capacity.
            bw = np.full(n, float(self.cluster.down_cap[child]) * 0.5)
            ids = [""] * n
        pieces_done = [
            {"number": k, "parent_id": ids[k], "length": self.piece_size,
             "cost_ns": int(self.piece_size / max(float(bw[k]), 1e3) * 1e9)}
            for k in range(n)
        ]
        self._timed("report_pieces_finished", client.report_pieces_finished, peer, pieces_done)
        self._timed("report_peer_finished", client.report_peer_finished, peer)
        return res

    def announce_all(self, url: str, *, clients: int) -> float:
        """Every host announces itself once (a daemon at boot); → seconds."""
        t0 = time.perf_counter()
        _pool(clients, list(range(len(self.hosts))),
              lambda i: self._timed("announce_host", self.client(url, i).announce_host,
                                    self.hosts[i]))
        return time.perf_counter() - t0

    def plan(self, n: int, *, tasks: int, salt: int = 0):
        """The workload of ``SwarmSimulator.run_downloads``: ``tasks`` URLs,
        each task's piece count (2-16), 2 seeding downloads a task, then
        ``n`` (child, task) draws (``salt`` varies the draws only)."""
        r = np.random.default_rng(self.seed)
        urls = [f"https://origin.example.com/blob/{t}" for t in range(tasks)]
        pieces = [int(p) for p in r.integers(2, 17, size=tasks)]
        seeds = [(int(r.integers(0, len(self.hosts))), t) for t in range(tasks) for _ in range(2)]
        r = np.random.default_rng((self.seed, salt)) if salt else r
        draws = [(int(r.integers(0, len(self.hosts))), int(r.integers(0, tasks)))
                 for _ in range(n)]
        return urls, pieces, seeds, draws

    def seed_tasks(self, url: str, plan) -> float:
        """The plan's seeding downloads, one at a time; → seconds."""
        urls, pieces, seeds, _ = plan
        t0 = time.perf_counter()
        for q, (child, t) in enumerate(seeds):
            self.download(url, child, urls[t], pieces[t], (self.seed, 0, q))
        return time.perf_counter() - t0

    def run_downloads(self, url: str, plan, *, clients: int, salt: int = 1) -> dict:
        """The plan's downloads over random tasks from ``clients`` threads
        (``salt`` keys their bandwidth noise)."""
        urls, pieces, _, draws = plan
        kinds = {}
        mu = threading.Lock()

        def one(q: int) -> None:
            child, t = draws[q]
            res = self.download(url, child, urls[t], pieces[t], (self.seed, salt, q))
            kind = res.schedule.kind.name if res.schedule is not None else "NONE"
            with mu:
                kinds[kind] = kinds.get(kind, 0) + 1

        t0 = time.perf_counter()
        _pool(clients, list(range(len(draws))), one)
        return {"downloads": len(draws), "seconds": time.perf_counter() - t0,
                "schedule_kinds": kinds}

    def run_until(self, url: str, plan, done, *, clients: int, salt: int = 1) -> dict:
        """The plan's downloads from ``clients`` threads, in order, until
        ``done()`` holds (checked between downloads) or the plan runs out."""
        urls, pieces, _, draws = plan
        next_q = iter(range(len(draws)))
        mu = threading.Lock()
        count = [0]

        def worker(_t: int) -> None:
            while not done():
                with mu:
                    q = next(next_q, None)
                if q is None:
                    return
                child, t = draws[q]
                self.download(url, child, urls[t], pieces[t], (self.seed, salt, q))
                with mu:
                    count[0] += 1

        t0 = time.perf_counter()
        _pool(clients, list(range(clients)), worker)
        return {"downloads": count[0], "seconds": time.perf_counter() - t0}

    def run_probe_rounds(self, url: str, rounds: int, *, clients: int) -> float:
        """``rounds`` probe rounds: every host asks for targets, pings them
        (the cluster's RTT with jitter) and reports; → seconds."""
        def one(item) -> None:
            rnd, i = item
            client = self.client(url, i)
            host = self.hosts[i]
            targets = self._timed("sync_probes_start", client.sync_probes_start, host)
            if not targets:
                return
            dst = np.array([self.index[t.id] for t in targets])
            rtt = self.cluster._rtt_vec(np.full(len(dst), i), dst,
                                        rng=np.random.default_rng((self.seed, 2, rnd, i)))
            self._timed("sync_probes_finished", client.sync_probes_finished, host,
                        [(t.id, int(v)) for t, v in zip(targets, rtt)])

        t0 = time.perf_counter()
        for rnd in range(rounds):
            _pool(clients, [(rnd, i) for i in range(len(self.hosts))], one)
        return time.perf_counter() - t0

    def parent_choice(self, url: str, label: str, n_trials: int, *, clients: int,
                      seed: int = 1234) -> dict:
        """Mean ground-truth bandwidth (MB/s) of the first parent
        ``register_peer`` returns, over ``n_trials`` fresh tasks of 8
        finished candidates each (the same draws for every ``label``)."""
        r = np.random.default_rng(seed)
        trials = []
        for _ in range(n_trials):
            picks = r.choice(len(self.hosts), size=9, replace=False)
            trials.append((int(picks[0]), [int(c) for c in picks[1:]]))
        got = [None] * n_trials

        def one(t: int) -> None:
            child, cands = trials[t]
            task_url = f"https://origin.example.com/trial-{label}/{t}"
            for k, c in enumerate(cands):
                self.download(url, c, task_url, 16, (seed, 3, t, k))
            res = self.client(url, child).register_peer(host=self.hosts[child], url=task_url)
            parents = res.schedule.parents if res.schedule is not None else []
            if parents:
                top = self.index[parents[0].host.id]
                got[t] = self.cluster.bandwidth(top, child, noise=False) / 1e6

        t0 = time.perf_counter()
        _pool(clients, list(range(n_trials)), one)
        scored = [g for g in got if g is not None]
        return {"mb_s": float(np.mean(scored)) if scored else 0.0, "trials": n_trials,
                "trials_with_parents": len(scored), "seconds": time.perf_counter() - t0}


def _ms(xs) -> dict:
    a = np.asarray(xs) * 1e3
    return {"calls": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "sum_s": float(a.sum() / 1e3)}


def _wire_breakdown(swarm: Swarm, stats, seconds: float) -> dict:
    """The wire's numbers for one download phase: announces/s (one
    ``register_peer``, the peer's announce, per download), the clients'
    round trips by method, the server's own time by method, and the
    service's share of the server's time and of the round trips."""
    register = swarm.latency["register_peer"]
    # A handler counts its request after writing the answer, so the last
    # ones may still be counting when their clients return.
    want = {m: len(v) for m, v in swarm.latency.items()}
    deadline = time.monotonic() + 5.0
    server = stats.snapshot()
    while time.monotonic() < deadline and any(
            server.get(m, {}).get("requests", 0) < n for m, n in want.items()):
        time.sleep(0.005)
        server = stats.snapshot()
    client_s = sum(sum(v) for v in swarm.latency.values())
    req_s = sum(m["request_s"] for m in server.values())
    svc_s = sum(m["service_s"] for m in server.values())
    return {
        "announces_per_s": len(register) / seconds,
        "register_peer": _ms(register),
        "client_calls": {m: _ms(v) for m, v in swarm.latency.items()},
        "server": server,
        "service_share_of_server_time": svc_s / req_s,
        "service_share_of_client_round_trip": svc_s / client_s,
    }


def _wait(cond, timeout: float, what: str, poll: float = 0.005) -> float:
    """Seconds until ``cond()`` holds; raises ``TimeoutError`` naming
    ``what`` after ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what}: not within {timeout:.0f} s")
        time.sleep(poll)
    return time.perf_counter() - t0


def _reserve_port(host: str) -> socket.socket:
    """A socket bound to a free port of ``host`` with ``SO_REUSEADDR``,
    not listening.  The scheduler binds the same port (its server sets
    ``SO_REUSEADDR`` too) before the caller closes this one, so its id
    (``sched-<hostname>-<port>``) is known before either binary boots and
    the trainer's lifecycle daemon can register models under it; while
    this socket is open no other bind to port 0 is given the port."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, 0))
    return sock


def _host_time(wall: float) -> float:
    """A ``time.time()`` stamp (the registry's ``created_at``, the
    controller's ``started_at``) on the ``perf_counter`` clock the run
    times with."""
    return wall - time.time() + time.perf_counter()


class _Walk:
    """What ``run`` reads of the lifecycle walk.  A sampler thread reads
    public state every ``poll`` s and keeps a row each time it changes:
    the evaluator's shadow engine and canary route, the subscriber's
    installed version and the daemon's trainer steps; every
    ``rest_every`` ticks it also reads the rollout row as ``GET
    /api/v1/rollouts:get`` shows it.  Two seams are wrapped, for what no
    object keeps: the controller's ``report`` (its decisions) and the
    manager's POST handler (the paths called)."""

    def __init__(self, manager, controller, sub, trainer, scheduler_id: str, name: str,
                 poll: float = 0.01, rest_every: int = 5) -> None:
        self.mu = threading.Lock()
        self.decisions, self.posts = [], []
        self.local, self.samples = [], []
        self.shadows = {}  # id → every shadow engine the evaluator held
        ev = sub.evaluator

        def stamp(into, **row):
            with self.mu:
                into.append({"t": time.perf_counter(), **row})

        report = controller.report

        def watched_report(scheduler_id, name, payload):
            out = report(scheduler_id, name, payload)
            row = controller.get(scheduler_id, name)
            stamp(self.decisions, model_id=row.model_id, version=row.version,
                  decision=out.get("decision"), phase=out.get("phase"),
                  reason=out.get("reason", ""), shadow_rows=payload.get("shadow_rows"),
                  joined_edges=payload.get("joined_edges"), psi_max=payload.get("psi_max"),
                  regret_at_k=payload.get("regret_at_k"),
                  inversion_rate=payload.get("inversion_rate"))
            return out

        controller.report = watched_report
        handler = manager._svc._httpd.RequestHandlerClass
        do_post = handler.do_POST

        def watched_post(h):
            stamp(self.posts, path=urllib.parse.urlsplit(h.path).path)
            return do_post(h)

        handler.do_POST = watched_post
        self._stop = threading.Event()
        url = manager.url + "/api/v1/rollouts:get?" + urllib.parse.urlencode(
            {"scheduler_id": scheduler_id, "name": name})

        def local_state() -> tuple:
            shadow, canary = ev.shadow, ev.canary
            if shadow is not None:
                self.shadows.setdefault(id(shadow), shadow)
            return (shadow.candidate_version if shadow is not None else None,
                    canary.version if canary is not None else None,
                    canary.percent if canary is not None else None,
                    sub._loaded_version, trainer.step)

        def rollout_row() -> dict:
            try:
                with urllib.request.urlopen(url, timeout=10) as resp:
                    row = json.loads(resp.read())
                return {"phase": row["phase"], "version": row["version"],
                        "started_at": row["started_at"]}
            except urllib.error.HTTPError as exc:
                # 404: no rollout row yet.
                return {"phase": None if exc.code == 404 else f"http {exc.code}",
                        "version": None}
            except OSError as exc:
                return {"phase": f"unreachable: {exc}", "version": None}

        def sample() -> None:
            last, tick = None, 0
            while True:
                stopping = self._stop.wait(poll)
                state = local_state()
                if state != last:
                    stamp(self.local, **dict(zip(
                        ("shadow", "canary", "canary_percent", "installed", "steps"), state)))
                    last = state
                if tick % rest_every == 0 or stopping:
                    stamp(self.samples, **rollout_row())
                tick += 1
                if stopping:
                    return

        self._sampler = threading.Thread(target=sample, name="rollout-sampler", daemon=True)
        self._sampler.start()

    def stop(self) -> None:
        """Stops the sampler after one last reading."""
        self._stop.set()
        self._sampler.join(timeout=30)

    def promoted(self):
        """(model id, version) of the first candidate the controller
        promoted, or None."""
        with self.mu:
            d = next((d for d in self.decisions if d["decision"] == "promote"), None)
            return (d["model_id"], d["version"]) if d else None

    def at(self, model_id: str, decision: str):
        """Host time of the controller's first ``decision`` for
        ``model_id`` (``advance``: SHADOW → CANARY, ``promote``: → ACTIVE)."""
        with self.mu:
            return next((d["t"] for d in self.decisions
                         if d["model_id"] == model_id and d["decision"] == decision), None)

    def began(self, version: int):
        """Host time the controller began ``version``'s rollout (its
        row's ``started_at``), or None if no sample showed the row."""
        with self.mu:
            wall = next((x["started_at"] for x in self.samples if x["version"] == version),
                        None)
        return _host_time(wall) if wall is not None else None

    def installed_at(self, version: int):
        """Host time of the first reading with ``version`` installed."""
        with self.mu:
            return next((x["t"] for x in self.local if x["installed"] == version), None)

    def steps_at(self, t: float) -> int:
        """The daemon's trainer steps as last read before ``t``."""
        with self.mu:
            return max((x["steps"] for x in self.local if x["t"] <= t), default=0)

    def serving(self, version: int) -> list:
        """What the evaluator held for ``version``, in order: a row each
        time the shadow engine or the canary route changed."""
        with self.mu:
            rows = [{"shadow": x["shadow"] == version,
                     "canary_percent": x["canary_percent"] if x["canary"] == version else None}
                    for x in self.local if version in (x["shadow"], x["canary"])]
        return [r for i, r in enumerate(rows) if i == 0 or r != rows[i - 1]]


def _segment(swarm: Swarm, t0, t1) -> dict:
    """``register_peer`` round trips that started in [t0, t1): announces/s,
    p50 / p99."""
    if t0 is None or t1 is None or t1 <= t0:
        return {"calls": 0}
    with swarm._mu:
        pairs = list(zip(swarm.started.get("register_peer", []),
                         swarm.latency.get("register_peer", [])))
    dts = [dt for s, dt in pairs if t0 <= s < t1]
    if not dts:
        return {"calls": 0, "seconds": t1 - t0}
    return {**_ms(dts), "seconds": t1 - t0, "announces_per_s": len(dts) / (t1 - t0)}


def run(args: argparse.Namespace, *, log=print) -> dict:
    """One wire loop (see the module docstring) → its summary."""
    import torch

    from ..cli import scheduler as scheduler_cli
    from ..cli import trainer as trainer_cli
    from ..config import SchedulerConfigFile, TrainerConfigFile
    from ..manager import ModelRegistry
    from ..manager.cluster import ClusterManager
    from ..manager.rest import ManagerRESTServer
    from ..ops import fused_score
    from ..records.columnar import ColumnarReader, concat_readers
    from ..rollout import RolloutController, RolloutGuardrails
    from ..rpc import RemoteRegistry
    from ..trainer.service import GNN_MODEL_NAME, MLP_MODEL_NAME
    from ..trainer.train import split_edges

    dev = torch.device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="wire_loop_")
    for sub in ("records", "rule_records", "staged"):
        shutil.rmtree(os.path.join(out, sub), ignore_errors=True)
    stack = contextlib.ExitStack()  # stops every server started, in reverse
    summary = {"device": str(dev), "hosts": args.hosts, "clients": args.clients,
               "lifecycle": args.lifecycle}
    try:
        # -- 1. the manager, the trainer, the two schedulers ----------------
        registry = ModelRegistry()
        # With --lifecycle the manager serves the rollout plane under the
        # reference's guardrail defaults but the drift ceiling, which is
        # off: over the wire it measures elapsed time (PERF.md §4).
        controller = RolloutController(
            registry, guardrails=RolloutGuardrails(max_psi=float("inf")),
        ) if args.lifecycle else None
        manager = ManagerRESTServer(registry, ClusterManager(), rollout=controller)
        manager.serve()
        stack.callback(manager.stop)

        reserved = _reserve_port("127.0.0.1") if args.lifecycle else None
        if reserved is not None:
            stack.callback(reserved.close)
        sched_port = reserved.getsockname()[1] if reserved is not None else 0
        scheduler_id = f"sched-{socket.gethostname()}-{sched_port}"
        tcfg = TrainerConfigFile()
        tcfg.server.host, tcfg.server.port = "127.0.0.1", 0
        tcfg.data_dir = os.path.join(out, "staged")
        tcfg.training.epochs = args.epochs
        tcfg.lifecycle.enable = args.lifecycle
        tcfg.lifecycle.interval_s = args.lifecycle_interval
        trainer = trainer_cli.serve(tcfg, device=dev, manager=manager.url, gnn_model="gat",
                                    scheduler_id=scheduler_id)
        stack.callback(trainer.stop)
        first_byte = {}  # session → host time of its first uploaded chunk
        receive = trainer.service.receive_shard_bytes

        def timed_receive(session, *a, **kw):
            first_byte.setdefault(id(session), time.perf_counter())
            return receive(session, *a, **kw)

        trainer.service.receive_shard_bytes = timed_receive

        scfg = SchedulerConfigFile()
        scfg.server.host, scfg.server.port = "127.0.0.1", sched_port
        scfg.storage.dir = os.path.join(out, "records")
        scfg.scheduling.algorithm = "ml"
        # As the reference simulator runs: a cold task's first registration
        # goes back to source without sleeping out the retry loop.
        scfg.scheduling.retry_interval_s = 0.0
        scfg.scheduling.model_poll_interval_s = args.model_poll
        # Every announce is shadow-scored (the binary's default: 10 %).
        scfg.scheduling.shadow_sample_rate = 1.0
        scfg.scheduling.rollout_report_interval_s = args.report_interval
        scfg.network_topology.enable = True
        scfg.manager_addr = manager.url
        scfg.trainer.enable, scfg.trainer.addr = True, trainer.url
        scfg.trainer.interval_s = args.train_interval
        t_boot = time.perf_counter()
        sched = scheduler_cli.serve(scfg, device=dev, scorer_blob=seeded_k1_blob(args.seed),
                                    rng=random.Random(args.seed))
        stack.callback(sched.stop)
        if reserved is not None:
            reserved.close()
        if args.lifecycle and sched.scheduler_id != scheduler_id:
            raise RuntimeError(f"the scheduler serves as {sched.scheduler_id}, the daemon "
                               f"registers for {scheduler_id}")
        ev = sched.service.scheduling.evaluator
        k1_scorer = ev._scorer
        rounds = []  # the Announcer's rounds: start, end, run key
        announce = sched.announcer.announce_to_trainer
        storage = sched.service.storage

        def timed_announce():
            r = {"start": time.perf_counter(), "key": None}
            rounds.append(r)
            try:
                r["key"] = announce()
            finally:
                r["end"] = time.perf_counter()
            return r["key"]

        sched.announcer.announce_to_trainer = timed_announce

        rcfg = SchedulerConfigFile()
        rcfg.server.host, rcfg.server.port = "127.0.0.1", 0
        rcfg.storage.dir = os.path.join(out, "rule_records")
        rcfg.scheduling.retry_interval_s = 0.0
        rcfg.network_topology.enable = False
        rule = scheduler_cli.serve(rcfg, device=dev, rng=random.Random(args.seed))
        stack.callback(rule.stop)

        swarm = Swarm(args.hosts, args.seed)
        plan = swarm.plan(args.downloads, tasks=args.tasks)
        fused_score.reset_launch_counts()
        batcher = ev.batcher
        calls0 = batcher.scorer_calls
        if args.lifecycle:
            summary.update(_lifecycle(
                args, swarm, plan, sched=sched, trainer=trainer, manager=manager,
                controller=controller, registry=registry, first_byte=first_byte, rounds=rounds, rule=rule, scheduler_id=scheduler_id,
                name=MLP_MODEL_NAME, t_boot=t_boot, log=log))
            return summary

        # -- 2. downloads and probes over the wire ---------------------------
        announce_s = swarm.announce_all(sched.url, clients=args.clients)
        seed_s = swarm.seed_tasks(sched.url, plan)
        sched.rpc_server.stats.reset()
        swarm.clear_latency()
        dl = swarm.run_downloads(sched.url, plan, clients=args.clients)
        summary["downloads"] = {
            **dl, **_wire_breakdown(swarm, sched.rpc_server.stats, dl["seconds"]),
            "announce_host_seconds": announce_s, "seed_downloads": len(plan[2]),
            "seed_seconds": seed_s,
        }
        sched.rpc_server.stats.reset()
        swarm.clear_latency()
        seq_plan = swarm.plan(args.sequential, tasks=args.tasks, salt=2)
        seq = swarm.run_downloads(sched.url, seq_plan, clients=1, salt=3)
        summary["downloads"]["sequential"] = {
            **seq, **_wire_breakdown(swarm, sched.rpc_server.stats, seq["seconds"])}
        log(json.dumps({"wire_loop": "downloads", **summary["downloads"]}))
        swarm.clear_latency()
        # The manager's view of the fleet while the Announcer ticks its
        # keepalive (it stops with the Announcer, below).
        summary["registered_schedulers"] = [
            s.id for s in manager.clusters.active_schedulers()]
        probe_s = swarm.run_probe_rounds(sched.url, args.probe_rounds, clients=args.clients)
        nt = sched.service.networktopology
        records = nt.snapshot()
        for rec in records:
            storage.create_network_topology(rec)
        storage.flush()
        t_snap = time.perf_counter()
        summary["probes"] = {"rounds": args.probe_rounds, "seconds": probe_s,
                             "edges": nt.edge_count(), "snapshot_records": len(records),
                             "client_calls": {m: _ms(v) for m, v in swarm.latency.items()}}
        log(json.dumps({"wire_loop": "probes", **summary["probes"]}))

        # -- 3. the Announcer's round after the snapshot ---------------------
        _wait(lambda: any(r["start"] >= t_snap and "end" in r for r in rounds), args.timeout,
              "the Announcer's round after the probe snapshot")
        sched.announcer.stop()
        measured = next(r for r in rounds if r["start"] >= t_snap)
        if measured["key"] is None:
            raise RuntimeError("the Announcer's round after the probe snapshot failed")
        # Nothing has written a record since the snapshot's flush.
        written = (sum(len(ColumnarReader(p)) for p in storage.download_columnar_paths()),
                   sum(len(ColumnarReader(p)) for p in storage.network_topology_columnar_paths()))
        run_rec = trainer.service.runs[measured["key"]]
        # Both models hold out the same 10 % of the uploaded download rows
        # (the service's MLP split is split_edges under seed 0, the GAT's
        # under the round's seed): the mean predictor's validation MAE.
        target = concat_readers(storage.download_columnar_paths())[:, -1]
        val_idx, train_idx = split_edges(len(target), trainer.service.train_config.seed)
        mean_mae = float(np.mean(np.abs(target[val_idx] - target[train_idx].mean())))
        run_models = {registry.get(mid).name: registry.get(mid) for mid in run_rec.models}
        first = min(t for t in first_byte.values() if t >= measured["start"])
        summary["train_round"] = {
            "rounds_before_snapshot": [
                {"seconds": r["end"] - r["start"],
                 "rows_staged": trainer.service.runs[r["key"]].download_rows}
                for r in rounds if r["start"] < t_snap and r["key"] is not None],
            "seconds_after_boot": measured["start"] - t_boot,
            "error": run_rec.error,
            "rows_written": {"download": written[0], "topology": written[1]},
            "rows_staged": {"download": run_rec.download_rows,
                            "topology": run_rec.topology_rows},
            "models": sorted(run_models),
            "first_byte_to_registered_s": (
                max(_host_time(m.created_at) for m in run_models.values()) - first
                if run_models else None),
            "round_seconds": measured["end"] - measured["start"],
            "metrics": {k: m.to_dict() for k, m in run_rec.metrics.items()},
            "mean_predictor_mae": mean_mae,
        }
        log(json.dumps({"wire_loop": "train_round", **summary["train_round"]}))
        if sorted(run_models) != sorted([MLP_MODEL_NAME, GNN_MODEL_NAME]):
            raise RuntimeError(f"the round registered {sorted(run_models)}")

        # -- 4. parent choice: seed K1 scorer, installed model, rules --------
        pre = swarm.parent_choice(sched.url, "k1-seed", args.trials, clients=args.clients)
        k1_launches = fused_score.LAUNCHES["fused_gather_mlp_score"]
        fused_flushes = batcher.scorer_calls - calls0
        remote = RemoteRegistry(manager.url)
        mlp = run_models[MLP_MODEL_NAME]
        t_act = time.perf_counter()
        remote.activate(mlp.id)
        _wait(lambda: ev._scorer is not k1_scorer, args.timeout, "the subscription's swap")
        swap_s = time.perf_counter() - t_act
        installed = type(ev._scorer).__name__
        post = swarm.parent_choice(sched.url, "installed", args.trials, clients=args.clients)
        rule_q = swarm.parent_choice(rule.url, "rule", args.trials, clients=args.clients)
        summary["parent_choice"] = {
            "k1_seed_scorer": pre, "installed": post, "rule": rule_q,
            "installed_scorer": installed, "activation_to_installed_s": swap_s,
        }
        summary["k1"] = {"launches": k1_launches, "fused_flushes": fused_flushes,
                         "launches_after_swap": fused_score.LAUNCHES["fused_gather_mlp_score"]
                         - k1_launches,
                         "batcher_fallbacks": batcher.fallbacks, "rule_degrades": ev.degrades}
        log(json.dumps({"wire_loop": "parent_choice", **summary["parent_choice"],
                        "k1": summary["k1"]}))
        return summary
    finally:
        stack.close()
        if not args.out:
            shutil.rmtree(out, ignore_errors=True)


def _lifecycle(args, swarm: Swarm, plan, *, sched, trainer, manager, controller, registry,
               first_byte, rounds, rule, scheduler_id, name, t_boot, log) -> dict:
    """``run`` with ``--lifecycle`` after the boot: the seed-made K1
    scorer's parent choice, then downloads until a candidate of the daemon
    has walked SHADOW → CANARY → ACTIVE and the subscription has installed
    it (candidates the controller rolls back before that are reported);
    then the reporter, the Announcer and the daemon stop, and parent
    choice runs on the installed model and on the rules."""
    from ..lifecycle import GLOBAL_KEY
    from ..manager.registry import ModelState
    from ..ops import fused_score
    from ..records.columnar import ColumnarReader
    from ..trainer.export import load_scorer

    ev = sched.service.scheduling.evaluator
    sub, reporter, daemon = sched.model_subscriber, sched.rollout_reporter, trainer.lifecycle_daemon
    gtrainer = daemon._trainers[GLOBAL_KEY]
    k1_scorer = ev._scorer
    k1_calls = [0]  # fused flushes: the K1 scorer's calls
    k1_score = k1_scorer.score

    def counted_k1(*a, **kw):
        k1_calls[0] += 1
        return k1_score(*a, **kw)

    k1_scorer.score = counted_k1
    walk = _Walk(manager, controller, sub, gtrainer, scheduler_id, name)
    try:
        announce_s = swarm.announce_all(sched.url, clients=args.clients)
        seed_s = swarm.seed_tasks(sched.url, plan)
        pre = swarm.parent_choice(sched.url, "k1-seed", args.trials, clients=args.clients)
        swarm.clear_latency()
        sched.rpc_server.stats.reset()

        def installed() -> bool:
            promoted = walk.promoted()
            if promoted is None:
                return False
            m = registry.get(promoted[0])
            return m.state is ModelState.ACTIVE and sub._loaded_version == promoted[1]

        deadline = time.perf_counter() + args.timeout
        t_loop = time.perf_counter()
        dl = swarm.run_until(sched.url, plan, lambda: installed()
                             or time.perf_counter() > deadline, clients=args.clients)
        t_end = time.perf_counter()
        walked = installed()
        launches_at_install = fused_score.LAUNCHES["fused_gather_mlp_score"]
        flushes_at_install = k1_calls[0]
        # Stop what would start or judge a second candidate: the reporter,
        # the Announcer (after its round in flight) and the daemon.
        reporter.stop()
        sched.announcer.stop()
        _wait(lambda: all("end" in r for r in rounds), args.timeout, "the Announcer's round")
        daemon.stop()
        for th in (reporter._thread, daemon._thread):
            th.join(timeout=args.timeout)
        walk.stop()
        # The daemon's candidates, from its lineage; their registration
        # times from the registry.
        daemon_models = [(e["version"], e["model_id"])
                         for e in daemon.store.row(GLOBAL_KEY)["history"]
                         if e["event"] == "registered"]
        if not walked:
            raise RuntimeError(
                f"no candidate of the daemon reached ACTIVE and installed within "
                f"{dl['downloads']} downloads / {args.timeout:.0f} s: candidates "
                f"{[v for v, _ in daemon_models]}, decisions "
                f"{[(d['version'], d['decision'], d['reason']) for d in walk.decisions]}")
        model_id, version = walk.promoted()
        registered = {mid: _host_time(registry.get(mid).created_at) for _, mid in daemon_models}
        t_reg = registered[model_id]
        t_shadow = walk.began(version)
        t_canary, t_active = walk.at(model_id, "advance"), walk.at(model_id, "promote")
        t_installed = walk.installed_at(version)
        first_upload = min(first_byte.values())
        with walk.mu:
            first_step = next((x["t"] for x in walk.local if x["steps"] > 0), None)

        # Parent choice on the installed model: its flushes are recorded
        # and held to the registry artifact's numpy scorer.
        scorer = ev._scorer
        flushes = []
        installed_score = scorer.score

        def recorded(features, **kw):
            out = installed_score(features, **kw)
            if len(flushes) < 256:
                flushes.append((np.array(features, np.float32, copy=True), np.array(out)))
            return out

        scorer.score = recorded
        post = swarm.parent_choice(sched.url, "installed", args.trials, clients=args.clients)
        rule_q = swarm.parent_choice(rule.url, "rule", args.trials, clients=args.clients)
        active = registry.active_model(scheduler_id, name)
        ref = load_scorer(registry.load_artifact(active))
        equal = bool(flushes) and all(np.array_equal(ref.score(f), o) for f, o in flushes)

        # Rows: the staged download shards (each the whole file as last
        # uploaded) against what reached the daemon; shadow rows on disk
        # against what the shadow engines logged and the reporter read.
        staged = sum(len(ColumnarReader(os.path.join(d, f)))
                     for d, _, files in os.walk(trainer.service.data_dir)
                     for f in files if f.startswith("download_"))
        log_path = sub.shadow_log_path
        on_disk = len(ColumnarReader(log_path)) if os.path.exists(log_path) else 0
        shadows = list(walk.shadows.values())
        daemon_ids = [mid for _, mid in daemon_models]
        mlps = registry.list(scheduler_id=scheduler_id, name=name)
        phases = [x["phase"] for x in walk.samples if x["version"] == version]
        result = {
            "downloads": {**dl, "announce_host_seconds": announce_s,
                          "seed_downloads": len(plan[2]), "seed_seconds": seed_s,
                          "before_first_upload": _segment(swarm, t_loop, first_upload),
                          "first_upload_to_shadow": _segment(swarm, first_upload, t_shadow),
                          "shadow": _segment(swarm, t_shadow, t_canary),
                          "canary": _segment(swarm, t_canary, t_active),
                          "after_active": _segment(swarm, t_active, t_end)},
            "walk": {
                "scheduler_id": scheduler_id, "model_id": model_id, "version": version,
                "candidates_before": [v for v, _ in daemon_models if v < version],
                "sampled_phases": [p for i, p in enumerate(phases)
                                   if i == 0 or p != phases[i - 1]],
                "samples": len(walk.samples),
                "sample_errors": sum(isinstance(x["phase"], str) and x["phase"] not in (
                    "shadow", "canary", "active", "rolled_back") for x in walk.samples),
                "decisions": [{k: v for k, v in d.items() if k != "t"}
                              for d in walk.decisions],
                "serving": walk.serving(version),
                "activate_posts": sum(p["path"].endswith(":activate") for p in walk.posts),
                "rollout_posts": sum(p["path"].endswith(":rollout") for p in walk.posts),
                "report_posts": sum(p["path"] == "/api/v1/rollouts:report"
                                    for p in walk.posts),
                "loop_start_after_boot_s": t_loop - t_boot,
                "first_upload_after_boot_s": first_upload - t_boot,
                "loop_start_to_shadow_s": t_shadow - t_loop,
                "first_byte_to_first_step_s": (first_step - first_upload
                                               if first_step is not None else None),
                "first_byte_to_first_registered_s": registered[daemon_ids[0]] - first_upload,
                "first_byte_to_registered_s": t_reg - first_upload,
                "registered_to_shadow_s": t_shadow - t_reg,
                "shadow_to_canary_s": t_canary - t_shadow,
                "canary_to_active_s": t_active - t_canary,
                "active_to_installed_s": t_installed - t_active,
            },
            "install": {"installed_version": sub._loaded_version,
                        "installed_scorer": type(ev._scorer).__name__,
                        "active_version": active.version, "active_id": active.id,
                        "active_is_daemons": active.id in daemon_ids,
                        "flushes_checked": len(flushes),
                        "scores_equal_registry_artifact": equal},
            "registrations": {
                "daemon": [{"version": v, "model_id": mid,
                            "after_first_byte_s": registered[mid] - first_upload,
                            "steps_before": walk.steps_at(registered[mid])}
                           for v, mid in daemon_models],
                "batch_round": [m.version for m in mlps if m.id not in daemon_ids],
                "announcer_rounds": [
                    {"after_boot_s": r["start"] - t_boot, "seconds": r["end"] - r["start"],
                     "rows_staged": (trainer.service.runs[r["key"]].download_rows
                                     if r["key"] else None)}
                    for r in rounds],
            },
            "rows": {"staged_download_rows": staged,
                     "fed_to_daemon": daemon.records_seen(GLOBAL_KEY),
                     "dropped_by_daemon": daemon.records_dropped(GLOBAL_KEY),
                     "shadow_rows_on_disk": on_disk,
                     "shadow_rows_logged": sum(sh.logged_rows for sh in shadows),
                     "shadow_rows_read_back": sum(
                         sh.replay_rows().shape[0] for sh in shadows[:1]),
                     "reporter_reads": [d["shadow_rows"] for d in walk.decisions]},
            "daemon": {"device": str(next(gtrainer.model.parameters()).device),
                       "steps": gtrainer.step, "records_seen": gtrainer.records_seen},
            "shadow_stats": [sh.stats() for sh in shadows],
            "parent_choice": {"k1_seed_scorer": pre, "installed": post, "rule": rule_q,
                              "installed_scorer": type(scorer).__name__},
            "k1": {"launches": launches_at_install, "fused_flushes": flushes_at_install,
                   "launches_after_swap": fused_score.LAUNCHES["fused_gather_mlp_score"]
                   - launches_at_install,
                   "fused_flushes_after_swap": k1_calls[0] - flushes_at_install,
                   "batcher_fallbacks": ev.batcher.fallbacks, "rule_degrades": ev.degrades},
        }
        log(json.dumps({"wire_loop": "lifecycle", **{k: result[k] for k in (
            "walk", "install", "registrations", "rows", "daemon")}}))
        return result
    finally:
        walk.stop()
        k1_scorer.__dict__.pop("score", None)


# ---------------------------------------------------------------------------
# The binaries in serve mode, as child processes
# ---------------------------------------------------------------------------


def boot_binary(kind: str, device: str, workdir: str, *, timeout: float = 120.0,
                argv=(), env=None) -> dict:
    """``python -m dragonfly2_tpu_torch.cli.<kind> --device <device>`` in
    serve mode (``kind`` is ``scheduler`` or ``trainer``), on an ephemeral
    port with its state under ``workdir``, with ``argv`` appended and
    ``env`` over the environment: wait for the line with its URL, send one
    request (``POST /rpc/announce_host`` or ``POST /train/open``), send
    SIGINT and wait for the exit.  → {"url", "response", "rc",
    "seconds_to_url", "seconds_to_exit", "stdout", "stderr"}; the process
    is killed if it outlives ``timeout``."""
    os.makedirs(workdir, exist_ok=True)
    extra_env = env
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_PARENT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if kind == "scheduler":
        env.update({"DRAGONFLY_SCHEDULER_SERVER_HOST": "127.0.0.1",
                    "DRAGONFLY_SCHEDULER_SERVER_PORT": "0",
                    "DRAGONFLY_SCHEDULER_STORAGE_DIR": os.path.join(workdir, "records")})
        marker = "scheduler: serving rpc on "
        path = "/rpc/announce_host"
        body = {"host": {"id": "boot-check-host", "hostname": "boot-check",
                         "ip": "127.0.0.1", "port": 8002, "download_port": 8001},
                "protocol_version": 2}
    elif kind == "trainer":
        env.update({"DRAGONFLY_TRAINER_SERVER_HOST": "127.0.0.1",
                    "DRAGONFLY_TRAINER_SERVER_PORT": "0",
                    "DRAGONFLY_TRAINER_DATA_DIR": os.path.join(workdir, "staged")})
        marker = "trainer: ingest on "
        path = "/train/open"
        body = {"ip": "127.0.0.1", "hostname": "boot-check", "scheduler_id": "boot-check"}
    else:
        raise ValueError(f"kind {kind!r} not in ('scheduler', 'trainer')")
    env.update(extra_env or {})
    t0 = time.perf_counter()
    err_path = os.path.join(workdir, f"{kind}.stderr")
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"dragonfly2_tpu_torch.cli.{kind}", "--device", device,
             *argv],
            stdout=subprocess.PIPE, stderr=err_file, text=True, env=env, cwd=workdir,
        )
    # A thread drains stdout line by line: the binary may print several
    # lines at once, which a select on the pipe would not see once read
    # into the reader's buffer.
    lines: "queue.Queue" = queue.Queue()
    stdout = []

    def pump() -> None:
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    reader = threading.Thread(target=pump, name=f"{kind}-stdout", daemon=True)
    reader.start()

    def stderr_tail() -> str:
        with open(err_path) as f:
            return f.read()[-2000:]

    out = {"rc": None, "url": None, "response": None}
    try:
        deadline = t0 + timeout
        while out["url"] is None:
            try:
                line = lines.get(timeout=max(deadline - time.perf_counter(), 0.0))
            except queue.Empty:
                raise TimeoutError(f"{kind}: no URL line within {timeout:.0f} s") from None
            if line is None:
                raise RuntimeError(f"{kind} exited before serving (rc {proc.wait()}): "
                                   f"{stderr_tail()}")
            stdout.append(line)
            if line.startswith(marker):
                out["url"] = line[len(marker):].split()[0].rstrip(",")
        out["seconds_to_url"] = time.perf_counter() - t0
        req = urllib.request.Request(out["url"] + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            out["response"] = json.loads(resp.read())
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        out["rc"] = proc.returncode
        out["seconds_to_exit"] = time.perf_counter() - t1
        reader.join(timeout=10)
        while (line := lines.get_nowait() if not lines.empty() else None) is not None:
            stdout.append(line)
        out["stdout"] = stdout
        out["stderr"] = stderr_tail()
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("wire_loop: no CUDA device", file=sys.stderr)
            return 2
    print(json.dumps(run(args, log=lambda line: print(line, file=sys.stderr))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
