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

``boot_binary`` starts ``python -m dragonfly2_tpu_torch.cli.{scheduler,
trainer}`` in serve mode as a child process, waits for its URL, sends one
request and stops it with SIGINT (exit 0 expected).

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints one JSON line.

    python -m dragonfly2_tpu_torch.bench.wire_loop [--downloads 4000] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
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
        return out

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
    from ..rpc import RemoteRegistry
    from ..trainer.service import GNN_MODEL_NAME, MLP_MODEL_NAME
    from ..trainer.train import split_edges

    dev = torch.device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="wire_loop_")
    for sub in ("records", "rule_records", "staged"):
        shutil.rmtree(os.path.join(out, sub), ignore_errors=True)
    stack = contextlib.ExitStack()  # stops every server started, in reverse
    summary = {"device": str(dev), "hosts": args.hosts, "clients": args.clients}
    try:
        # -- 1. the manager, the trainer, the two schedulers ----------------
        registry = ModelRegistry()
        registered = {}  # model id → host time of its registration
        create_model = registry.create_model

        def timed_create(**kw):
            m = create_model(**kw)
            registered[m.id] = time.perf_counter()
            return m

        registry.create_model = timed_create
        manager = ManagerRESTServer(registry, ClusterManager())
        manager.serve()
        stack.callback(manager.stop)

        tcfg = TrainerConfigFile()
        tcfg.server.host, tcfg.server.port = "127.0.0.1", 0
        tcfg.data_dir = os.path.join(out, "staged")
        tcfg.training.epochs = args.epochs
        trainer = trainer_cli.serve(tcfg, device=dev, manager=manager.url, gnn_model="gat")
        stack.callback(trainer.stop)
        first_byte = {}  # session → host time of its first uploaded chunk
        receive = trainer.service.receive_shard_bytes

        def timed_receive(session, *a, **kw):
            first_byte.setdefault(id(session), time.perf_counter())
            return receive(session, *a, **kw)

        trainer.service.receive_shard_bytes = timed_receive

        scfg = SchedulerConfigFile()
        scfg.server.host, scfg.server.port = "127.0.0.1", 0
        scfg.storage.dir = os.path.join(out, "records")
        scfg.scheduling.algorithm = "ml"
        # As the reference simulator runs: a cold task's first registration
        # goes back to source without sleeping out the retry loop.
        scfg.scheduling.retry_interval_s = 0.0
        scfg.scheduling.model_poll_interval_s = args.model_poll
        scfg.network_topology.enable = True
        scfg.manager_addr = manager.url
        scfg.trainer.enable, scfg.trainer.addr = True, trainer.url
        scfg.trainer.interval_s = args.train_interval
        t_boot = time.perf_counter()
        sched = scheduler_cli.serve(scfg, device=dev, scorer_blob=seeded_k1_blob(args.seed),
                                    rng=random.Random(args.seed))
        stack.callback(sched.stop)
        ev = sched.service.scheduling.evaluator
        k1_scorer = ev._scorer
        rounds = []  # the Announcer's rounds: start, end, run key
        announce = sched.announcer.announce_to_trainer
        storage = sched.service.storage

        def timed_announce():
            t0 = time.perf_counter()
            key = announce()
            rounds.append({"start": t0, "end": time.perf_counter(), "key": key})
            return key

        sched.announcer.announce_to_trainer = timed_announce

        rcfg = SchedulerConfigFile()
        rcfg.server.host, rcfg.server.port = "127.0.0.1", 0
        rcfg.storage.dir = os.path.join(out, "rule_records")
        rcfg.scheduling.retry_interval_s = 0.0
        rcfg.network_topology.enable = False
        rule = scheduler_cli.serve(rcfg, device=dev, rng=random.Random(args.seed))
        stack.callback(rule.stop)

        # -- 2. downloads and probes over the wire ---------------------------
        swarm = Swarm(args.hosts, args.seed)
        plan = swarm.plan(args.downloads, tasks=args.tasks)
        fused_score.reset_launch_counts()
        batcher = ev.batcher
        calls0 = batcher.scorer_calls
        announce_s = swarm.announce_all(sched.url, clients=args.clients)
        seed_s = swarm.seed_tasks(sched.url, plan)
        sched.rpc_server.stats.reset()
        swarm.latency.clear()
        dl = swarm.run_downloads(sched.url, plan, clients=args.clients)
        summary["downloads"] = {
            **dl, **_wire_breakdown(swarm, sched.rpc_server.stats, dl["seconds"]),
            "announce_host_seconds": announce_s, "seed_downloads": len(plan[2]),
            "seed_seconds": seed_s,
        }
        sched.rpc_server.stats.reset()
        swarm.latency.clear()
        seq_plan = swarm.plan(args.sequential, tasks=args.tasks, salt=2)
        seq = swarm.run_downloads(sched.url, seq_plan, clients=1, salt=3)
        summary["downloads"]["sequential"] = {
            **seq, **_wire_breakdown(swarm, sched.rpc_server.stats, seq["seconds"])}
        log(json.dumps({"wire_loop": "downloads", **summary["downloads"]}))
        swarm.latency.clear()
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
        _wait(lambda: any(r["start"] >= t_snap for r in rounds), args.timeout,
              "the Announcer's round after the probe snapshot")
        sched.announcer.stop()
        measured = next(r for r in rounds if r["start"] >= t_snap)
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
                for r in rounds if r["start"] < t_snap],
            "seconds_after_boot": measured["start"] - t_boot,
            "error": run_rec.error,
            "rows_written": {"download": written[0], "topology": written[1]},
            "rows_staged": {"download": run_rec.download_rows,
                            "topology": run_rec.topology_rows},
            "models": sorted(run_models),
            "first_byte_to_registered_s": (
                max(registered[m.id] for m in run_models.values()) - first
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


# ---------------------------------------------------------------------------
# The binaries in serve mode, as child processes
# ---------------------------------------------------------------------------


def boot_binary(kind: str, device: str, workdir: str, *, timeout: float = 120.0) -> dict:
    """``python -m dragonfly2_tpu_torch.cli.<kind> --device <device>`` in
    serve mode (``kind`` is ``scheduler`` or ``trainer``), on an ephemeral
    port with its state under ``workdir``: wait for the line with its URL,
    send one request (``POST /rpc/announce_host`` or ``POST /train/open``),
    send SIGINT and wait for the exit.  → {"url", "response", "rc",
    "seconds_to_url", "seconds_to_exit", "stdout", "stderr"}; the process
    is killed if it outlives ``timeout``."""
    os.makedirs(workdir, exist_ok=True)
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
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"dragonfly2_tpu_torch.cli.{kind}", "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=workdir,
    )
    out = {"rc": None, "url": None, "response": None}
    lines = []
    try:
        deadline = t0 + timeout
        while out["url"] is None:
            left = deadline - time.perf_counter()
            ready, _, _ = select.select([proc.stdout], [], [], max(left, 0.0))
            if not ready:
                raise TimeoutError(f"{kind}: no URL line within {timeout:.0f} s")
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"{kind} exited before serving (rc {proc.wait()}): "
                                   f"{proc.stderr.read()[-2000:]}")
            lines.append(line.rstrip("\n"))
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
        rest, err = proc.communicate(timeout=max(deadline - time.perf_counter(), 1.0))
        out["rc"] = proc.returncode
        out["seconds_to_exit"] = time.perf_counter() - t1
        out["stdout"] = lines + rest.splitlines()
        out["stderr"] = err[-2000:]
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


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
