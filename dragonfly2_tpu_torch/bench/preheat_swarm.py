"""Preheat and the seed peer over real sockets: the port's manager binary
fans a preheat job to the port's scheduler, whose job worker warms a
``dfdaemon --seed-peer`` composition; normal daemons then download from
the seed, K1 ranking their parents, and a cluster update on the manager
reaches the scheduler live through dynconfig.

``run(parse_args([...]))`` boots, in one process and under ``--out``:

- two origins (``bench/peer_swarm.Origin``): file A of ``--size-mib`` MiB
  and file B of ``--cold-mib`` MiB, made from ``--seed`` and ``--seed`` + 1
  with numpy, each counting the body bytes and range requests it serves;
- ``cli.manager.serve`` with its state under ``--out`` and
  ``jobs_min_requeue_s`` 1;
- ``cli.scheduler.serve`` with algorithm ``ml``, the seed-made
  32→64→64→1 scorer blob, ``manager_addr`` the manager's URL and
  ``dynconfig_refresh_s`` 1; its job worker's long poll is cut to 1 s;
- one seed daemon: ``cli.dfdaemon.build`` then ``cli.dfdaemon.seed_peer``
  (a SUPER_SEED host whose announce carries its public ``/obtain_seeds``
  port);
- ``--daemons`` normal daemons at the ``DaemonConfig`` defaults but their
  storage under ``--out``, piece servers on port 0 and ``--piece-kib``
  pieces (default 4 MiB, the config's); every daemon announced once.

Then, in order:

1. **preheat**: ``POST /api/v1/jobs`` of a ``preheat`` job for A on queue
   ``scheduler:<id>``; the group reaches SUCCESS and the seed's task of A
   completes;
2. **swarm**: the normal daemons download A at the same time;
3. **cold task**: daemon 1 downloads B with no source fetcher; the
   scheduler's cold-task branch triggers the seed inline and daemon 1's
   pieces come from it;
4. **dynconfig**: ``POST /api/v1/clusters/<id>:update`` with
   ``filter_parent_limit`` 6 and ``candidate_parent_limit`` 4; once the
   scheduler applies it, daemon 0 and daemons 2 to N-1 download B (the
   wave).

Each download sizes its file with the source client's ``HEAD`` first
(daemon 1's cold download is given B's size, having no source client).
Every request the batcher takes is recorded with its rows (the rows one
register hands K1) and whether a SUPER_SEED host is among them.  The
summary holds each step's seconds and rates, the origins' bytes and
requests, pieces by parent host for each file, the seed's share of P2P
pieces, the trigger's calls and seconds, the dynconfig update's
update-to-applied seconds, the rows per register before the update and
after it is applied, the manager's job polls, the evaluator's degrades
and the batcher's scorer calls, and ``checks``.  Everything the run wrote
under ``--out`` is deleted at the end.

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints the servers' boot lines, then one JSON line last.

    python -m dragonfly2_tpu_torch.bench.preheat_swarm [--daemons 15] [--size-mib 256] \\
        [--cold-mib 64] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from .peer_swarm import Origin, _make_file, _pieces_by_parent, _task_sha256

DYNCONFIG_REFRESH_S = 1.0  # the scheduler's dynconfig_refresh_s (10 s cut for the run's time)
POLL_TIMEOUT_S = 1.0       # the job worker's long poll (5 s cut: it bounds the stop)
FILTER_LIMIT, CANDIDATE_LIMIT = 6, 4  # the cluster update (from the defaults 15, 4)
WAIT_S = 120.0             # the most any one wait may take


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--daemons", type=int, default=15, help="normal daemons")
    ap.add_argument("--size-mib", type=int, default=256, help="file A, preheated")
    ap.add_argument("--cold-mib", type=int, default=64, help="file B, not preheated")
    ap.add_argument("--piece-kib", type=int, default=4096,
                    help="the daemons' piece_size (the DaemonConfig default: 4 MiB)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for every file of the run "
                    "(default: a fresh temporary directory); deleted after")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _wait(cond, timeout: float, what: str) -> float:
    """Poll ``cond`` every 10 ms; → the seconds it took.  Raises on timeout."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"preheat_swarm: {what} did not happen in {timeout:.0f}s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def _download_all(nodes, indices, url, piece_size):
    """Download ``url`` on ``nodes[i]`` for every i, all at once; →
    ({i: result}, seconds)."""
    results = {}

    def one(i):
        conductor = nodes[i]["conductor"]
        length = conductor.probe_content_length(url)
        results[i] = conductor.download(url, piece_size=piece_size, content_length=length)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,), name=f"daemon{i}-dl", daemon=True)
               for i in indices]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results, time.perf_counter() - t0


def _source_peers(service, task_id: str, host_names: dict) -> dict:
    """Pieces fetched from the origin for a task, by the daemon that
    fetched them."""
    out: dict = {}
    for peer in service.resource.peer_manager.items():
        if peer.task.id != task_id:
            continue
        n = sum(1 for piece in list(peer.pieces.values()) if not piece.parent_id)
        if n:
            name = host_names.get(peer.host.id, peer.host.id)
            out[name] = out.get(name, 0) + n
    return out


def run(args: argparse.Namespace, *, log=print) -> dict:
    from ..cli import dfdaemon
    from ..cli import manager as manager_cli
    from ..cli import scheduler as scheduler_cli
    from ..config import DaemonConfig, ManagerConfig, SchedulerConfigFile
    from ..jobs.preheat import PREHEAT
    from ..jobs.remote import RemoteJobClient
    from ..utils import idgen
    from .wire_loop import seeded_k1_blob

    out_dir = args.out or tempfile.mkdtemp(prefix="preheat_swarm-")
    work = os.path.join(out_dir, "preheat_swarm")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    size_a, size_b = args.size_mib << 20, args.cold_mib << 20
    piece_size = args.piece_kib << 10
    n_a = (size_a + piece_size - 1) // piece_size
    n_b = (size_b + piece_size - 1) // piece_size
    origins, nodes = [], []
    manager = serving = seed = None
    try:
        t_setup = time.perf_counter()
        sha_a = _make_file(os.path.join(work, "a.bin"), size_a, args.seed)
        sha_b = _make_file(os.path.join(work, "b.bin"), size_b, args.seed + 1)
        origin_a, origin_b = Origin(os.path.join(work, "a.bin")), Origin(
            os.path.join(work, "b.bin"))
        for o in (origin_a, origin_b):
            o.serve()
            origins.append(o)
        tid_a, tid_b = idgen.task_id(origin_a.url), idgen.task_id(origin_b.url)

        mcfg = ManagerConfig()
        mcfg.server.host, mcfg.server.port = "127.0.0.1", 0
        mcfg.registry.blob_dir = os.path.join(work, "manager")
        mcfg.jobs_min_requeue_s = 1.0
        manager = manager_cli.serve(mcfg)
        jobqueue = manager.parts["jobs"]
        polls = [0]
        poll = jobqueue.poll

        def counted_poll(*a, **kw):
            polls[0] += 1
            return poll(*a, **kw)

        jobqueue.poll = counted_poll

        scfg = SchedulerConfigFile()
        scfg.server.host, scfg.server.port = "127.0.0.1", 0
        scfg.storage.dir = os.path.join(work, "records")
        scfg.scheduling.algorithm = "ml"
        # As the other serving phases: a cold task's first register goes
        # back to source without sleeping out the retry loop.
        scfg.scheduling.retry_interval_s = 0.0
        scfg.manager_addr = manager.url
        scfg.dynconfig_refresh_s = DYNCONFIG_REFRESH_S
        serving = scheduler_cli.serve(scfg, device=args.device,
                                      scorer_blob=seeded_k1_blob(args.seed),
                                      rng=random.Random(args.seed))
        serving.job_worker.poll_timeout_s = POLL_TIMEOUT_S
        service = serving.service
        ev = service.scheduling.evaluator
        cache = ev.feature_cache

        # Every request the batcher takes: its rows and whether a
        # SUPER_SEED host is among its parents' slots (column 9).
        requests = []
        score = ev.batcher.score

        def recorded_score(features, *, src_buckets=None, **kw):
            _, mat = cache.matrix_snapshot()
            src = np.asarray(src_buckets, dtype=np.int64)
            requests.append((time.perf_counter(), int(np.shape(features)[0]),
                             bool((mat[src, 9] == 1).any()) if src.size else False))
            return score(features, src_buckets=src_buckets, **kw)

        ev.batcher.score = recorded_score
        triggers = []
        trigger = service.seed_peer_trigger

        def timed_trigger(url, task_id):
            t0 = time.perf_counter()
            ok = trigger(url, task_id)
            triggers.append({"task": "A" if task_id == tid_a else "B" if task_id == tid_b
                             else task_id, "ok": ok, "seconds": time.perf_counter() - t0})
            return ok

        service.seed_peer_trigger = timed_trigger

        def daemon(name):
            dc = DaemonConfig()
            dc.storage.dir = os.path.join(work, name)
            dc.server.host, dc.server.port = "127.0.0.1", 0
            dc.server.advertise_ip = "127.0.0.1"
            dc.piece_size = piece_size
            dc.validate()
            return dc, dfdaemon.build(dc, serving.url)

        dc, seed = daemon("seed")
        seed.update(dfdaemon.seed_peer(seed, dc))
        for i in range(args.daemons):
            nodes.append(daemon(f"daemon{i}")[1])
        for n in [seed, *nodes]:
            n["announcer"].announce_once()
        host_names = {n["host"].id: f"daemon{i}" for i, n in enumerate(nodes)}
        host_names[seed["host"].id] = "seed"
        setup_s = time.perf_counter() - t_setup
        log(f"preheat_swarm: seed + {args.daemons} daemons, A {size_a} bytes in {n_a} "
            f"pieces, B {size_b} bytes in {n_b} pieces, manager {manager.url}, "
            f"scheduler {serving.url} ({setup_s:.1f}s setup)")

        # -- 1. preheat ------------------------------------------------------
        jobs = RemoteJobClient(manager.url, timeout=30.0)
        t0 = time.perf_counter()
        group = jobs.create_group(PREHEAT, {"urls": [origin_a.url], "piece_size": piece_size},
                                  [f"scheduler:{serving.scheduler_id}"])
        job_s = _wait(lambda: jobs.group_state(group["group_id"])["state"] in ("SUCCESS", "FAILURE"),
                      WAIT_S, "the preheat group's end")
        group = jobs.group_state(group["group_id"])
        _wait(lambda: seed["storage"].held_pieces(tid_a) >= n_a, WAIT_S,
              "the seed's task of A")
        preheat_s = time.perf_counter() - t0
        origin_a_preheat = {"bytes": origin_a.bytes_served, "requests": origin_a.requests}
        seed_sha_a = _task_sha256(seed["storage"], tid_a)
        log(f"preheat_swarm: preheat {group['state']} in {job_s:.2f}s, seed holds A "
            f"after {preheat_s:.2f}s")

        # -- 2. the swarm downloads A -----------------------------------------
        t_swarm = time.perf_counter()
        swarm, swarm_s = _download_all(nodes, range(args.daemons), origin_a.url, piece_size)
        calls_swarm = ev.batcher.scorer_calls
        by_parent_a = _pieces_by_parent(service, tid_a, host_names)
        p2p_a = sum(v for k, v in by_parent_a.items() if k != "source")

        # -- 3. the cold task: daemon 1 downloads B with no source client -----
        cold_node = nodes[1]["conductor"]
        saved_source, cold_node.source_fetcher = cold_node.source_fetcher, None
        t_cold = time.perf_counter()
        try:
            cold = cold_node.download(origin_b.url, piece_size=piece_size, content_length=size_b)
        finally:
            cold_node.source_fetcher = saved_source
        cold_s = time.perf_counter() - t_cold
        by_parent_cold = {}
        for peer in service.resource.peer_manager.items():
            if peer.task.id == tid_b and peer.host.id == nodes[1]["host"].id:
                for piece in list(peer.pieces.values()):
                    parent = (service.resource.peer_manager.load(piece.parent_id)
                              if piece.parent_id else None)
                    key = ("source" if not piece.parent_id else
                           host_names.get(parent.host.id, parent.host.id) if parent
                           else "unknown")
                    by_parent_cold[key] = by_parent_cold.get(key, 0) + 1
        _wait(lambda: seed["storage"].held_pieces(tid_b) >= n_b, WAIT_S,
              "the seed's task of B")
        origin_b_cold = {"bytes": origin_b.bytes_served, "requests": origin_b.requests}

        # -- 4. dynconfig: the cluster update, then a wave of B ---------------
        limits0 = {"filter_parent_limit": service.scheduling.config.filter_parent_limit,
                   "candidate_parent_limit": service.scheduling.config.candidate_parent_limit}
        t_update = time.perf_counter()
        updated = jobs.call("POST", f"/api/v1/clusters/{scfg.cluster_id}:update", {
            "scheduler_cluster_config": {"filter_parent_limit": FILTER_LIMIT,
                                         "candidate_parent_limit": CANDIDATE_LIMIT}})
        applied_s = _wait(
            lambda: service.scheduling.config.filter_parent_limit == FILTER_LIMIT
            and service.scheduling.config.candidate_parent_limit == CANDIDATE_LIMIT,
            WAIT_S, "the cluster update's arrival")
        t_applied = t_update + applied_s
        wave_idx = [i for i in range(args.daemons) if i != 1]
        wave, wave_s = _download_all(nodes, wave_idx, origin_b.url, piece_size)
        by_parent_b = _pieces_by_parent(service, tid_b, host_names)

        service.storage.flush()
        rows_before = [r for t, r, _ in requests if t < t_update]
        rows_after = [r for t, r, _ in requests if t >= t_applied]
        swarm_ok = [r is not None and r.ok for r in swarm.values()]
        wave_ok = [r is not None and r.ok for r in wave.values()]
        sha_swarm = [_task_sha256(nodes[i]["storage"], r.task_id) if r.ok else ""
                     for i, r in sorted(swarm.items())]
        sha_wave = [_task_sha256(nodes[i]["storage"], r.task_id) if r.ok else ""
                    for i, r in sorted(wave.items())]
        seed_share = by_parent_a.get("seed", 0) / max(p2p_a, 1)
        summary = {
            "daemons": args.daemons, "piece_size": piece_size,
            "a": {"bytes": size_a, "pieces": n_a, "task_id": tid_a},
            "b": {"bytes": size_b, "pieces": n_b, "task_id": tid_b},
            "setup_seconds": setup_s,
            "preheat": {"group_state": group["state"], "job_seconds": job_s,
                        "seconds": preheat_s, "origin": origin_a_preheat,
                        "source_pieces_by_daemon": _source_peers(service, tid_a, host_names)},
            "swarm": {"seconds": swarm_s,
                      "aggregate_mb_s": args.daemons * size_a / swarm_s / 1e6,
                      "download_seconds": [r.cost_s for _, r in sorted(swarm.items())],
                      "back_to_source": [bool(r.back_to_source)
                                         for _, r in sorted(swarm.items())],
                      "pieces_by_parent": by_parent_a, "seed_share_of_p2p": seed_share,
                      "origin": {"bytes": origin_a.bytes_served,
                                 "requests": origin_a.requests}},
            "cold": {"seconds": cold_s, "ok": bool(cold.ok),
                     "back_to_source": bool(cold.back_to_source),
                     "pieces_by_parent": by_parent_cold, "origin": origin_b_cold,
                     "source_pieces_by_daemon": _source_peers(service, tid_b, host_names)},
            "triggers": triggers,
            "dynconfig": {"refresh_s": DYNCONFIG_REFRESH_S, "before": limits0,
                          "update": updated.get("scheduler_cluster_config"),
                          "update_to_applied_s": applied_s,
                          "rows_per_register_before": {
                              "max": max(rows_before, default=0), "n": len(rows_before)},
                          "rows_per_register_after": {
                              "max": max(rows_after, default=0), "n": len(rows_after)}},
            "wave": {"seconds": wave_s, "daemons": len(wave_idx),
                     "aggregate_mb_s": len(wave_idx) * size_b / wave_s / 1e6,
                     "back_to_source": [bool(r.back_to_source)
                                        for _, r in sorted(wave.items())],
                     "pieces_by_parent": by_parent_b,
                     "origin": {"bytes": origin_b.bytes_served,
                                "requests": origin_b.requests}},
            "requests_scored": len(requests),
            "requests_with_seed_row": sum(1 for _, _, s in requests if s),
            "job_polls": polls[0], "jobs_done": serving.job_worker.jobs_done,
            "download_records": service.storage.download_count,
            "rule_degrades": ev.degrades, "scorer_calls": ev.batcher.scorer_calls,
            "scorer_calls_swarm": calls_swarm,
            "batcher_fallbacks": ev.batcher.fallbacks,
        }
        seed_a = summary["preheat"]["source_pieces_by_daemon"]
        summary["checks"] = {
            "preheat_group_success": group["state"] == "SUCCESS",
            "origin_served_a_once_to_the_seed": origin_a_preheat
            == {"bytes": size_a, "requests": n_a} and seed_a == {"seed": n_a}
            and seed_sha_a == sha_a,
            "swarm_ok": all(swarm_ok) and len(swarm_ok) == args.daemons
            and all(s == sha_a for s in sha_swarm),
            "no_normal_daemon_back_to_source": not any(
                r.back_to_source for r in [*swarm.values(), *wave.values(), cold]),
            "origin_a_bytes_once": origin_a.bytes_served == size_a
            and origin_a.requests == n_a,
            "pieces_a_add_up": sum(by_parent_a.values()) == (args.daemons + 1) * n_a
            and by_parent_a.get("source", 0) == n_a,
            "cold_from_the_seed": bool(cold.ok) and not cold.back_to_source
            and by_parent_cold == {"seed": n_b}
            and _task_sha256(nodes[1]["storage"], cold.task_id) == sha_b,
            "origin_b_once_to_the_seed": origin_b.bytes_served == size_b
            and origin_b.requests == n_b
            and summary["cold"]["source_pieces_by_daemon"] == {"seed": n_b},
            "triggered_once_per_task": sorted(t["task"] for t in triggers) == ["A", "B"]
            and all(t["ok"] for t in triggers),
            "dynconfig_within_three_refreshes": applied_s <= 3 * DYNCONFIG_REFRESH_S,
            "wave_ok": all(wave_ok) and len(wave_ok) == len(wave_idx)
            and all(s == sha_b for s in sha_wave),
            "rows_within_filter_limit_after_update": 0 < len(rows_after)
            and max(rows_after) <= FILTER_LIMIT,
            "a_seed_row_scored": summary["requests_with_seed_row"] > 0,
            "no_degrade": ev.degrades == 0 and ev.batcher.fallbacks == 0,
        }
        return summary
    finally:
        for n in nodes:
            n["announcer"].stop()
            n["piece_server"].stop()
        if seed is not None:
            seed["announcer"].stop()
            seed["piece_server"].stop()
            if "seed_endpoint" in seed:
                seed["seed_endpoint"].stop()
                seed["seeder"].queue.stop()
        if serving is not None:
            serving.stop()
        if manager is not None:
            manager.stop()
        for o in origins:
            o.stop()
        shutil.rmtree(work, ignore_errors=True)
        if not args.out:
            shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("preheat_swarm: no CUDA device", file=sys.stderr)
            return 2
    summary = run(args, log=lambda line: print(line, file=sys.stderr))
    print(json.dumps(summary))
    return 0 if all(summary["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
