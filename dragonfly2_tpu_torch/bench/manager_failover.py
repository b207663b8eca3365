"""Manager HA under load: the leader manager is SIGKILLed with a preheat job
in flight, its hot standby promotes itself when the lease lapses, and the
scheduler keeps ranking parents with K1 through the outage, then serves a
model registered and activated at the survivor.

``run(parse_args([...]))`` boots, under ``--out``:

- **two manager binaries as child processes**, each ``python -m
  dragonfly2_tpu_torch.cli.manager`` with its own state directory,
  ``ha.enable``, its own ``ha.node_id`` and one private 32-byte
  ``ha.lease_secret``, configured through ``DRAGONFLY_MANAGER_*`` and
  otherwise at the reference's defaults (``lease_ttl_s`` 10,
  ``poll_interval_s`` 1) but ``jobs_min_requeue_s`` 1; the second boots
  with ``--replicate-from <leader>``, both at once (the leader's port is
  picked first), and the run goes on once the standby has bootstrapped;
- in this process: ``cli.scheduler.serve`` with algorithm ``ml`` and
  ``manager_addr`` ``"<leader>,<standby>"`` (its job worker, dynconfig,
  topology sync and ``ModelSubscriber`` all go through one
  ``ManagerEndpoints``), the subscriber polling every 1 s; one seed daemon
  (``cli.dfdaemon.seed_peer``); ``--daemons`` daemons at the
  ``DaemonConfig`` defaults (the native engine); an HTTP origin that
  answers every request after 20-25 ms and serves files A, B, C and D of
  ``--file-mib`` MiB each, made from ``--seed`` with numpy.

The subscription's installs serve through K1, as ``cli.scheduler.serve``
installs every active model that K1 runs (``k1_installs``): models A and
B are ``FusedMLPScorer`` over the scheduler's host store once installed.

Then, in order:

1. model A (``seeded_k1_blob(seed)``) is registered and activated at the
   leader over REST; the run waits until the subscriber installs it;
2. wave 1: every daemon downloads A, driven by ``tools/stress.run_stress``;
3. the scheduler's job worker detaches (the reference drill's window: a
   job queued before its worker polls), and ``POST /api/v1/jobs`` queues
   a preheat of B on ``scheduler:<id>``;
4. once the standby's ``replication:status`` shows every row the leader
   wrote applied, the leader is SIGKILLed and never restarted, and the
   job worker re-attaches through the endpoint pair;
5. during the outage: wave 2 (every daemon downloads C), one probe write
   to the standby (it must answer 503 before promotion), and
   ``subscriber.pinned`` sampled every 100 ms until model B is installed;
6. the run waits for the promotion (role leader, term >= 2), writes until
   the survivor accepts one, registers and activates model B
   (``seeded_k1_blob(seed + 1)``) there, and times activation → installed;
7. wave 3: every daemon downloads D under model B.

The summary holds the replication lag (the standby's
``manager_replication_lag_seconds`` and the ops it trailed the leader by,
polled before the kill) at p50 / p99, the seconds from the kill to the
promotion and to the first write the survivor accepted, the preheat's
POST → SUCCESS read at the survivor, each wave's
``StressReport.summary()``, pieces by parent for each file, the manager
endpoints' failovers by client, the survivor's ``manager_role`` and
``manager_failovers_total``, the ``pinned`` samples, activation →
installed, the batcher's scorer calls per wave and per model, ``engine``
(``peer_swarm.engine_report``) and ``checks``.  Everything under ``--out``
is deleted at the end.

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
``--lease-ttl-s`` shortens the lease for a CPU rehearsal.  Prints the
servers' boot lines, then one JSON line last.

    python -m dragonfly2_tpu_torch.bench.manager_failover [--daemons 8] [--file-mib 64] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import random
import re
import secrets
import shutil
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from .peer_swarm import (
    Origin,
    _make_file,
    _pieces_by_parent,
    _task_sha256,
    daemon_config,
    engine_ran,
    engine_report,
    finish_engine,
)
from .secure_cluster import _rest
from .wire_loop import _wait

MODEL_NAME = "parent-bandwidth-mlp"  # the subscriber's model name (its default)
MODEL_POLL_S = 1.0                   # the subscriber's poll (300 s cut, as the wire phases)
POLL_TIMEOUT_S = 1.0                 # the job worker's long poll (5 s cut: it bounds the stop)
JOBS_MIN_REQUEUE_S = 1.0             # the managers' jobs_min_requeue_s (30 s cut)
ORIGIN_DELAY_S = (0.020, 0.025)      # every origin request answers after this
SAMPLE_S = 0.1                       # the pinned sampler's and the lag poll's period
WAIT_S = 120.0                       # the most any one wait may take
FILES = ("a", "b", "c", "d")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--daemons", type=int, default=8)
    ap.add_argument("--file-mib", type=int, default=64, help="each of files A-D")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for every file of the run "
                    "(default: a fresh temporary directory); deleted after")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lease-ttl-s", type=float, default=None,
                    help="the managers' ha.lease_ttl_s (default: the config's, 10 s); "
                    "for a CPU rehearsal")
    return ap.parse_args(argv)


BOOT = re.compile(r"manager: serving REST on (http://\S+) as (\w+) \(term (\d+)\)")


def _manager(state_dir: str, env: dict, argv=()):
    """One manager binary as a child process (``sim.chaos.ChaosProcess``),
    configured through the environment."""
    from ..sim.chaos import PACKAGE_PARENT, ChaosProcess

    return ChaosProcess(
        ["-m", "dragonfly2_tpu_torch.cli.manager", *argv],
        ready_prefixes=("manager: serving REST on",),
        env={**os.environ, "PYTHONPATH": PACKAGE_PARENT,
             "DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR": state_dir, **env}).start()


def _boot(child) -> tuple:
    """(url, role, term) from a manager child's boot line."""
    m = BOOT.match(child.wait_ready(WAIT_S)["manager: serving REST on"])
    if m is None:
        raise RuntimeError(f"manager_failover: a manager booted without HA: {child.lines}")
    return m.group(1), m.group(2), int(m.group(3))


def _metrics(url: str, names) -> dict:
    """The samples of ``names`` on a server's ``/metrics``: series → value."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        if series.split("{")[0] in names:
            out[series] = float(value)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pct(values, q) -> float:
    return float(np.percentile(values, q)) if len(values) else 0.0


def run(args: argparse.Namespace, *, log=print) -> dict:
    from ..cli import dfdaemon
    from ..cli import scheduler as scheduler_cli
    from ..config import DaemonConfig, SchedulerConfigFile
    from ..jobs.preheat import PREHEAT
    from ..jobs.remote import RemoteJobClient
    from ..ops.fused_score import FusedMLPScorer
    from ..tools.stress import run_stress
    from ..trainer.export import load_scorer
    from ..utils import idgen
    from ..utils.metrics import default_registry
    from .wire_loop import seeded_k1_blob

    out_dir = args.out or tempfile.mkdtemp(prefix="manager_failover-")
    work = os.path.join(out_dir, "manager_failover")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    size = args.file_mib << 20
    piece_size = DaemonConfig().piece_size
    n_pieces = (size + piece_size - 1) // piece_size
    origin = serving = seed = summary = None
    nodes, managers = [], {}
    stop_sampling = threading.Event()
    sampler = None
    try:
        t_setup = time.perf_counter()
        # -- the two managers, booting together while the files are made ------
        # The leader's port is picked first so that the standby can boot
        # with --replicate-from at once; its follower grants an unseen
        # leader a lease and a half (15 s at the defaults) before it would
        # promote, and the bootstrap check below holds that it did not.
        ha_env = {"DRAGONFLY_MANAGER_SERVER_HOST": "127.0.0.1",
                  "DRAGONFLY_MANAGER_HA_ENABLE": "true",
                  "DRAGONFLY_MANAGER_HA_LEASE_SECRET": secrets.token_hex(16),
                  "DRAGONFLY_MANAGER_JOBS_MIN_REQUEUE_S": str(JOBS_MIN_REQUEUE_S)}
        if args.lease_ttl_s is not None:
            ha_env["DRAGONFLY_MANAGER_HA_LEASE_TTL_S"] = str(args.lease_ttl_s)
        leader_port = _free_port()
        leader = managers["leader"] = _manager(
            os.path.join(work, "leader"),
            {**ha_env, "DRAGONFLY_MANAGER_SERVER_PORT": str(leader_port),
             "DRAGONFLY_MANAGER_HA_NODE_ID": "mgr-leader"})
        standby = managers["standby"] = _manager(
            os.path.join(work, "standby"),
            {**ha_env, "DRAGONFLY_MANAGER_SERVER_PORT": "0",
             "DRAGONFLY_MANAGER_HA_NODE_ID": "mgr-standby"},
            ["--replicate-from", f"http://127.0.0.1:{leader_port}"])
        shas, paths = {}, {}
        for i, name in enumerate(FILES):
            paths[name] = os.path.join(work, f"{name}.bin")
            shas[name] = _make_file(paths[name], size, args.seed + i)
        origin = Origin(paths, delay=ORIGIN_DELAY_S, seed=args.seed)
        origin.serve()
        setup = {"files": time.perf_counter() - t_setup}
        urls = {name: origin.url_of(name) for name in FILES}
        tids = {name: idgen.task_id(url) for name, url in urls.items()}
        leader_boot, standby_boot = _boot(leader), _boot(standby)
        leader_url, standby_url = leader_boot[0], standby_boot[0]
        if leader_boot != (f"http://127.0.0.1:{leader_port}", "leader", 1) \
                or standby_boot[1:] != ("standby", 1):
            raise RuntimeError(f"manager_failover: the managers booted as {leader_boot} "
                               f"and {standby_boot}")
        # The standby has bootstrapped from the leader (not promoted).
        _wait(lambda: (lambda st: st["applied_seq"] >= 1 and st["role"] == "standby"
                       and st["term"] == 1)(_rest(standby_url + "/api/v1/replication:status")[1]),
              WAIT_S, "the standby's bootstrap from the leader", poll=0.05)
        setup["managers"] = time.perf_counter() - t_setup - sum(setup.values())
        for child in managers.values():
            log(child.ready_lines["manager: serving REST on"])

        # -- the scheduler, its K1 installs, the daemons ---------------------
        scfg = SchedulerConfigFile()
        scfg.server.host, scfg.server.port = "127.0.0.1", 0
        scfg.storage.dir = os.path.join(work, "records")
        scfg.scheduling.algorithm = "ml"
        # As the other serving phases: a cold task's first register goes
        # back to source without sleeping out the retry loop.
        scfg.scheduling.retry_interval_s = 0.0
        scfg.scheduling.model_poll_interval_s = MODEL_POLL_S
        scfg.manager_addr = f"{leader_url},{standby_url}"
        serving = scheduler_cli.serve(scfg, device=args.device, rng=random.Random(args.seed))
        serving.job_worker.poll_timeout_s = POLL_TIMEOUT_S
        setup["scheduler"] = time.perf_counter() - t_setup - sum(setup.values())
        service = serving.service
        ev = service.scheduling.evaluator
        subscriber = serving.model_subscriber
        weights = {k: load_scorer(seeded_k1_blob(args.seed + i)).weights
                   for i, k in enumerate(("A", "B"))}

        def serving_model():
            """The model whose weights the evaluator serves through K1:
            "A", "B", "other", or None while no K1 scorer is installed."""
            scorer = ev._scorer
            if not isinstance(scorer, FusedMLPScorer):
                return None
            w = scorer._ref.weights
            return next((k for k, ref in weights.items() if len(ref) == len(w) and all(
                np.array_equal(a, b) and np.array_equal(c, d)
                for (a, c), (b, d) in zip(ref, w))), "other")

        def daemon(name):
            dc = daemon_config(args, os.path.join(work, name), piece_size)
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
        setup["daemons"] = setup_s - sum(setup.values())
        log(f"manager_failover: seed + {args.daemons} daemons, 4 files of {size} bytes, "
            f"leader {leader_url}, standby {standby_url}, scheduler {serving.url} "
            f"({setup_s:.1f}s setup)")

        def register(base: str, blob: bytes) -> tuple:
            """Register and activate a model; → (model id, version, POST
            :activate's host time)."""
            status, created = _rest(base + "/api/v1/models", {
                "name": MODEL_NAME, "type": "mlp", "scheduler_id": serving.scheduler_id,
                "artifact_b64": base64.b64encode(blob).decode()})
            if status != 200:
                raise RuntimeError(f"manager_failover: register at {base}: {status} {created}")
            t_activate = time.perf_counter()
            status, body = _rest(base + f"/api/v1/models/{created['id']}:activate", {})
            if status != 200:
                raise RuntimeError(f"manager_failover: activate at {base}: {status} {body}")
            return created["id"], created["version"], t_activate

        # -- 1. model A at the leader --------------------------------------------
        _, version_a, t_act_a = register(leader_url, seeded_k1_blob(args.seed))
        _wait(lambda: serving_model() == "A", WAIT_S, "model A's install")
        install_a_s = time.perf_counter() - t_act_a
        calls_before_a = ev.batcher.scorer_calls

        # Lag and pinned samplers (before the kill: lag; throughout: pinned).
        lag = {"seconds": [], "ops": []}
        pinned = []

        def sample():
            while not stop_sampling.wait(SAMPLE_S):
                pinned.append(subscriber.pinned)
                if leader.alive() and not killed.is_set():
                    try:
                        seq = _rest(leader_url + "/api/v1/replication:status")[1]
                        st = _rest(standby_url + "/api/v1/replication:status")[1]
                        g = _metrics(standby_url, {"manager_replication_lag_seconds"})
                    except (OSError, ValueError):
                        continue
                    if not killed.is_set():
                        lag["ops"].append(max(int(seq["seq"]) - int(st["applied_seq"]), 0))
                        lag["seconds"].append(g.get("manager_replication_lag_seconds", 0.0))

        killed = threading.Event()
        sampler = threading.Thread(target=sample, name="failover-sampler", daemon=True)
        sampler.start()

        def wave(name: str) -> dict:
            """Every daemon downloads file ``name`` once, through run_stress."""
            url = urls[name]
            picked, results = iter(range(len(nodes))), {}
            pick_mu = threading.Lock()
            calls0 = ev.batcher.scorer_calls

            def download(u):
                with pick_mu:
                    i = next(picked)
                conductor = nodes[i]["conductor"]
                length = conductor.probe_content_length(u)
                results[i] = conductor.download(u, piece_size=piece_size,
                                                content_length=length)
                return results[i]

            report = run_stress(download, [url], concurrency=len(nodes), total=len(nodes))
            sha_ok = [bool(r.ok) and _task_sha256(nodes[i]["storage"], r.task_id) == shas[name]
                      for i, r in sorted(results.items())]
            return {"file": name, "stress": report.summary(),
                    "mb_s": report.bytes / max(report.wall_s, 1e-9) / 1e6,
                    "sha256_equal": sum(sha_ok), "downloads": len(results),
                    "back_to_source": sum(bool(r.back_to_source) for r in results.values()),
                    "scorer_calls": ev.batcher.scorer_calls - calls0,
                    "pieces_by_parent": _pieces_by_parent(service, tids[name], host_names)}

        # -- 2. wave 1 under A ---------------------------------------------------
        waves = [wave("a")]

        # -- 3. a preheat of B, queued with its worker detached --------------------
        serving.job_worker.stop()
        endpoints = serving.job_worker.client.endpoints
        t_job = time.perf_counter()
        jobs = RemoteJobClient(endpoints, timeout=30.0)
        group = jobs.create_group(PREHEAT, {"urls": [urls["b"]], "piece_size": piece_size},
                                  [f"scheduler:{serving.scheduler_id}"])
        leader_seq = _rest(leader_url + "/api/v1/replication:status")[1]["seq"]
        replicated_s = _wait(
            lambda: _rest(standby_url + "/api/v1/replication:status")[1]["applied_seq"]
            >= leader_seq, WAIT_S, "the standby's apply of the job rows", poll=0.05)

        # -- 4. the kill ------------------------------------------------------------
        t_kill = time.perf_counter()
        killed.set()
        leader.sigkill()
        leader_rc = leader.proc.returncode
        log(f"manager_failover: leader SIGKILLed (rc {leader_rc}); job rows applied at the "
            f"standby {replicated_s:.2f}s after the POST")
        serving.job_worker = scheduler_cli._job_worker(service, endpoints,
                                                       serving.scheduler_id, None)
        serving.job_worker.poll_timeout_s = POLL_TIMEOUT_S
        serving.job_worker.serve()

        # -- 5. the outage: wave 2, the standby's 503 ----------------------------
        probe = urllib.request.Request(
            standby_url + "/api/v1/topology", method="POST",
            data=json.dumps({"scheduler_id": "failover-probe", "edges": []}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(probe, timeout=30) as resp:
                probe_status, retry_after = resp.status, resp.headers.get("Retry-After")
        except urllib.error.HTTPError as exc:
            probe_status, retry_after = exc.code, exc.headers.get("Retry-After")
        probe_promoted = _rest(standby_url + "/api/v1/replication:status")[1]["role"]
        waves.append(wave("c"))

        # -- 6. the promotion, the first accepted write, model B ------------------
        def promoted() -> bool:
            st = _rest(standby_url + "/api/v1/replication:status")[1]
            return st["role"] == "leader" and st["term"] >= 2

        _wait(promoted, WAIT_S, "the standby's promotion", poll=0.05)
        promote_s = time.perf_counter() - t_kill
        _wait(lambda: _rest(standby_url + "/api/v1/topology", {
            "scheduler_id": "failover-probe", "edges": []})[0] == 200,
            WAIT_S, "the survivor's first accepted write", poll=0.05)
        first_write_s = time.perf_counter() - t_kill
        status = _rest(standby_url + "/api/v1/replication:status")[1]
        _, version_b, t_act_b = register(standby_url, seeded_k1_blob(args.seed + 1))
        _wait(lambda: serving_model() == "B", WAIT_S, "model B's install")
        install_b_s = time.perf_counter() - t_act_b
        calls_at_b = ev.batcher.scorer_calls
        survivor_jobs = RemoteJobClient(standby_url, timeout=30.0)
        _wait(lambda: survivor_jobs.group_state(group["group_id"])["state"]
              in ("SUCCESS", "FAILURE"), WAIT_S, "the preheat's end at the survivor",
              poll=0.05)
        preheat_s = time.perf_counter() - t_job
        group_state = survivor_jobs.group_state(group["group_id"])["state"]
        # SUCCESS means the seed took the task (the trigger's answer); the
        # seed finishes it on its own, as phase 21's seed does.
        seed_whole_s = _wait(lambda: seed["storage"].held_pieces(tids["b"]) >= n_pieces,
                             WAIT_S, "the seed's task of B") + preheat_s
        seed_b = _task_sha256(seed["storage"], tids["b"]) == shas["b"]

        # -- 7. wave 3 under B ------------------------------------------------------
        waves.append(wave("d"))
        stop_sampling.set()
        sampler.join(timeout=10)
        # The waves are the only traffic: calls between two installs are A's.
        calls_by_model = {"A": calls_at_b - calls_before_a,
                          "B": ev.batcher.scorer_calls - calls_at_b}
        b_served = serving_model() == "B"
        survivor_metrics = _metrics(standby_url, {"manager_role", "manager_failovers_total"})
        failovers = {}
        for line in default_registry.expose_text().splitlines():
            m = re.match(r'manager_endpoint_failovers_total\{client="([^"]*)"\} (\S+)$', line)
            if m:
                failovers[m.group(1)] = float(m.group(2))
        summary = {
            "daemons": args.daemons, "file_bytes": size, "piece_size": piece_size,
            "setup_seconds": setup_s, "setup_breakdown_s": setup, "lease_ttl_s": args.lease_ttl_s or 10.0,
            "replication_lag": {
                "samples": len(lag["seconds"]),
                "seconds_p50": _pct(lag["seconds"], 50), "seconds_p99": _pct(lag["seconds"], 99),
                "ops_p50": _pct(lag["ops"], 50), "ops_p99": _pct(lag["ops"], 99)},
            "job_rows_applied_s": replicated_s,
            "leader_returncode": leader_rc,
            "kill_to_promotion_s": promote_s,
            "kill_to_first_accepted_write_s": first_write_s,
            "survivor_status": status,
            "standby_probe": {"status": probe_status, "role": probe_promoted,
                              "retry_after": retry_after},
            "preheat": {"state": group_state, "post_to_end_s": preheat_s,
                        "post_to_seed_whole_s": seed_whole_s, "seed_holds_b": seed_b},
            "waves": waves,
            "endpoint_failovers": failovers,
            "survivor_metrics": survivor_metrics,
            "pinned_samples": {"n": len(pinned), "true": sum(pinned)},
            "activation_to_installed_s": {"A": install_a_s, "B": install_b_s},
            "model_versions": {"A": version_a, "B": version_b},
            "scorer_calls": ev.batcher.scorer_calls,
            "scorer_calls_by_model": calls_by_model,
            "rule_degrades": ev.degrades, "batcher_fallbacks": ev.batcher.fallbacks,
            "engine": engine_report([seed, *nodes]),
        }
        leader_failovers = [v for k, v in survivor_metrics.items()
                            if k.startswith("manager_failovers_total")]
        summary["checks"] = {
            "leader_sigkilled": leader_rc == -9,
            "survivor_leader_term_2": status["role"] == "leader" and status["term"] >= 2
            and survivor_metrics.get('manager_role{role="leader"}') == 1.0
            and leader_failovers == [1.0],
            "standby_503_before_promotion": probe_status == 503 and probe_promoted == "standby"
            and retry_after == "1",
            "preheat_success_at_survivor": group_state == "SUCCESS" and seed_b,
            "every_download_sha256_equal": all(
                w["sha256_equal"] == w["downloads"] == args.daemons
                and w["stress"]["failed"] == 0 and w["stress"]["succeeded"] == args.daemons
                for w in waves),
            "never_pinned": len(pinned) > 0 and not any(pinned),
            "b_served_after_install": b_served
            and calls_by_model["B"] == waves[2]["scorer_calls"] > 0,
            "every_scorer_call_in_a_wave": ev.batcher.scorer_calls
            == sum(w["scorer_calls"] for w in waves) == sum(calls_by_model.values()),
            "no_degrade": ev.degrades == 0 and ev.batcher.fallbacks == 0,
            "engine_ran": engine_ran(summary["engine"], True),
        }
    finally:
        stop_sampling.set()
        if sampler is not None:
            sampler.join(timeout=10)
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
        for child in managers.values():
            child.stop()
        if origin is not None:
            origin.stop()
        shutil.rmtree(work, ignore_errors=True)
        if not args.out:
            shutil.rmtree(out_dir, ignore_errors=True)
    summary["checks"]["no_manager_child_alive"] = not any(
        child.alive() for child in managers.values())
    summary["manager_lines"] = {name: child.lines[-6:] for name, child in managers.items()}
    finish_engine(summary)
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("manager_failover: no CUDA device", file=sys.stderr)
            return 2
    summary = run(args, log=lambda line: print(line, file=sys.stderr))
    print(json.dumps(summary))
    return 0 if all(summary["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
