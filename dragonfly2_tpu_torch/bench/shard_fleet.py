"""The sharded scheduler fleet over real sockets: three ``ml`` schedulers
behind the manager's shard ring, daemons steering across them with K1
ranking parents in each, and one scheduler SIGKILLed between download
waves.

``run(parse_args([...]))`` boots, in one process and under ``--out``:

- ``cli.manager.serve`` (its state under ``--out``);
- two ``cli.scheduler.serve`` compositions in this process and one
  ``python -m dragonfly2_tpu_torch.cli.scheduler`` child
  (``sim.chaos.ChaosProcess``), each with algorithm ``ml``, the manager's
  URL, ``dynconfig_refresh_s`` ``--refresh-s`` and the shard guard with
  admission at the config's defaults (512 in flight, 50 ms p99).  The
  seed-made 32→64→64→1 scorer blob reaches every shard the same way: the
  in-process ones take it as ``scorer_blob``, the child reads the same
  bytes from a file through ``--scorer-blob``.  On ``cuda`` the kernels'
  library is built in this process before the child starts, so the child
  only loads it.  The child's records go under ``--out`` with a buffer of
  one, so a SIGKILL loses none;
- ``--files`` origins (stdlib HTTP with ``Range``), each serving one file
  of ``--size-mib`` MiB made from ``--seed`` + its index.  The files'
  URLs are picked so that the published ring gives every shard at least
  two of them (round robin over the members);
- ``--daemons`` daemons, each ``cli.dfdaemon.build`` at the default
  ``DaemonConfig`` (4 MiB pieces) but with its storage under ``--out``
  and its piece server on port 0, given the comma-separated list of the
  three schedulers' URLs: each builds a ``SteeringSchedulerClient`` and
  adopts the ring from its announce answers.

Then: once every shard and daemon holds the three-member ring (ring
v1), one daemon per file downloads it back to source (wave 1, all files
at once).  Wave 2 is ``--daemons / 2 - 1`` more daemons per file.  The
survivors' files start first; while they are in flight the child is
SIGKILLed, and the manager expires it as the reference's drill does
(its last keepalive aged out of the TTL: the scheduler's keepalive
interval is 20 s, and the TTL 60 s).  Once the manager publishes the
two-member ring (ring v2), both survivors adopt it through dynconfig
(their guards run the handoff sweep), and every daemon adopts it from
an announce answer, the victim's files' wave 2 starts.  The reference's
daemon fails a download whose scheduler dies under it (its
back-to-source fallback reports to the dead scheduler), so the victim's
tasks wait for ring v2 instead of being in flight at the kill.

The summary holds the wall time and rates, the ring versions and the
seconds from the kill to ring v2 at the manager, at each survivor and at
the first daemon, every download's result, the origins' bytes, the
pieces by source, each shard's Download records by task, the handoff
spans and redirects, the in-process evaluators' degrades and batchers'
scorer calls and fallbacks, and the sheds by priority and the most
requests in flight that admission saw.  ``checks``: ring v1 has three
members, ring v2 two with a higher version; the survivors adopted v2
through dynconfig and a survivor's announce answer carries it, as does
every daemon's steering client; the child died by SIGKILL; every
download is ok and its sha256 equals its origin's; the Download records
before the kill are on each task's v1 owner only; the victim's tasks'
records after the kill are on their v2 owners only, one per wave-2
download; a handoff span on each survivor; the origin served each
survivor file at most 1.25 x its size; the child's diagnostics sidecar
(started by its ``run`` at the reference's default, on an ephemeral port
here), scraped just before the kill, counts in
``scheduler_download_records_total`` the Download records the run read
from the child's storage, and its ``/debug/spans`` holds its
``rpc/register_peer`` spans; no evaluator degrade and no
batcher fallback in process; every daemon ran the native engine
(``engine_ran``: its store, ``NativePieceServer``, pieces through the
native fetch loop) and no native server leaked at teardown.  ``engine``
is ``peer_swarm.engine_report`` over the daemons.  Everything the run
wrote under ``--out`` is deleted at the end.

K1's launches are counted in this process only: the child's are its
own.  The two in-process batchers' scorer calls are what the caller
holds K1's launch count to.

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints one JSON line.

    python -m dragonfly2_tpu_torch.bench.shard_fleet [--daemons 16] [--files 8] [--size-mib 32] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import sys
import tempfile
import threading
import time

from .peer_swarm import (
    ORIGIN_BYTES_LIMIT,
    Origin,
    _make_file,
    _task_sha256,
    daemon_config,
    engine_ran,
    engine_report,
    finish_engine,
)

SCHEDULERS = 3          # two in this process, one child
IN_PROCESS = 2
READY_LINE = "scheduler: serving rpc on "
DIAG_LINE = "scheduler: diagnostics on "


def scrape_diagnostics(base: str) -> dict:
    """The child's diagnostics sidecar read once: its ``/metrics``
    counters of the scheduler's records and registrations, and the span
    names in ``/debug/spans``."""
    import urllib.request

    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    series = {}
    for line in text.splitlines():
        if line.startswith("scheduler_") and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            series[name] = float(value)
    spans = _get_json(base + "/debug/spans")
    names = [s["name"] for rs in spans.get("resourceSpans", [])
             for ss in rs.get("scopeSpans", []) for s in ss.get("spans", [])]
    return {
        "url": base,
        "download_records_total": series.get("scheduler_download_records_total", 0.0),
        "register_peer_total": sum(v for k, v in series.items()
                                   if k.startswith("scheduler_register_peer_total")),
        "spans": len(names),
        "register_spans": names.count("rpc/register_peer"),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--daemons", type=int, default=16)
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--size-mib", type=int, default=32, help="each origin file's size")
    ap.add_argument("--piece-kib", type=int, default=4096,
                    help="the daemons' piece_size (the DaemonConfig default: 4 MiB)")
    ap.add_argument("--refresh-s", type=float, default=0.5,
                    help="the schedulers' dynconfig_refresh_s (the default 10 s cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for every file of the run "
                    "(default: a fresh temporary directory); deleted after")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class _HandoffSpans:
    """A span exporter that keeps the ``scheduler/shard.handoff`` spans'
    attributes."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.spans: list = []

    def export(self, span) -> None:
        if span.name == "scheduler/shard.handoff":
            with self._mu:
                self.spans.append(dict(span.attributes))


class _AdmissionWatch:
    """Samples each in-process guard's admission every 10 ms: the most
    requests in flight and the highest overload fraction it read."""

    def __init__(self, guards) -> None:
        self._guards = guards
        self.inflight_max = 0
        self.overload_max = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="admission-watch", daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(0.01):
            for g in self._guards:
                if g.admission is not None:
                    self.inflight_max = max(self.inflight_max, g.admission.inflight())
                    self.overload_max = max(self.overload_max, g.admission.overload())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()


def shed_counts() -> dict:
    """``scheduler_shard_shed_total`` by priority class, in this process."""
    from ..scheduler import metrics

    return {key[0]: value for key, value in metrics.SHARD_SHED_TOTAL.state()["series"]}


def _get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


def _wait(fn, timeout: float, what: str, interval: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    raise RuntimeError(f"shard_fleet: timed out waiting for {what}")


def _records_by_task(storage) -> dict:
    """{task id: Download records} of one scheduler's storage."""
    out: dict = {}
    for rec in storage.list_download():
        out[rec.task.id] = out.get(rec.task.id, 0) + 1
    return out


def _answer_ring_version(url: str, host) -> int:
    """The ring version in ``url``'s answer to an announce of ``host``."""
    from ..rpc import RemoteScheduler

    client = RemoteScheduler(url, timeout=5.0)
    client.announce_host(host)
    return int((client.scheduler_ring or {}).get("version", 0))


def _announce_all(nodes) -> None:
    threads = [threading.Thread(target=n["announcer"].announce_once, daemon=True)
               for n in nodes]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def _download_wave(nodes, jobs, piece_size) -> tuple:
    """Start ``(daemon index, file index, url)`` downloads at once; →
    (threads, {(daemon, file): result})."""
    results: dict = {}

    def one(i, k, url):
        conductor = nodes[i]["conductor"]
        try:
            length = conductor.probe_content_length(url)
            results[(i, k)] = conductor.download(url, piece_size=piece_size,
                                                 content_length=length)
        except Exception as exc:  # noqa: BLE001 — recorded as a failed download
            results[(i, k)] = exc

    threads = [threading.Thread(target=one, args=job, name=f"daemon{job[0]}-f{job[1]}",
                                daemon=True) for job in jobs]
    for th in threads:
        th.start()
    return threads, results


def run(args: argparse.Namespace, *, log=print) -> dict:
    from ..cli import dfdaemon
    from ..cli import manager as manager_cli
    from ..cli import scheduler as scheduler_cli
    from ..config import ManagerConfig, SchedulerConfigFile
    from ..records.storage import Storage
    from ..rpc.daemon_control import STATE_ENV
    from ..scheduler import ShardRing, metrics
    from ..sim.chaos import ChaosProcess
    from ..utils import idgen
    from ..utils.tracing import CompositeExporter, default_tracer
    from .wire_loop import seeded_k1_blob

    out_dir = args.out or tempfile.mkdtemp(prefix="shard_fleet-")
    work = os.path.join(out_dir, "shard_fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    size = args.size_mib << 20
    piece_size = args.piece_kib << 10
    n_pieces = (size + piece_size - 1) // piece_size
    wave2 = args.daemons // 2 - 1
    if args.files < 2 * SCHEDULERS or wave2 < 1:
        raise ValueError("shard_fleet needs >= 6 files and >= 4 daemons")
    origins, nodes, servings = [], [], []
    manager = child = summary = None
    saved_state = os.environ.get(STATE_ENV)
    saved_exporter = default_tracer.exporter
    handoffs = _HandoffSpans()
    try:
        t_setup = time.perf_counter()
        os.environ[STATE_ENV] = os.path.join(work, "daemon.json")
        if args.device.startswith("cuda"):
            # One build, here, before the child starts: the child only
            # loads the library this process published.
            from ..ops import _build

            _build.load()
        blob = seeded_k1_blob(args.seed)
        blob_path = os.path.join(work, "scorer.blob")
        with open(blob_path, "wb") as f:
            f.write(blob)

        mcfg = ManagerConfig()
        mcfg.server.host, mcfg.server.port = "127.0.0.1", 0
        mcfg.registry.blob_dir = os.path.join(work, "manager")
        manager = manager_cli.serve(mcfg)
        clusters = manager.parts["clusters"]

        def scheduler_cfg(i: int) -> SchedulerConfigFile:
            cfg = SchedulerConfigFile()
            cfg.server.host, cfg.server.port = "127.0.0.1", 0
            cfg.storage.dir = os.path.join(work, f"records{i}")
            cfg.scheduling.algorithm = "ml"
            # As the other serving phases: a cold task's first register
            # goes back to source without sleeping out the retry loop.
            cfg.scheduling.retry_interval_s = 0.0
            cfg.manager_addr = manager.url
            cfg.dynconfig_refresh_s = args.refresh_s
            return cfg

        default_tracer.exporter = CompositeExporter([saved_exporter, handoffs])
        for i in range(IN_PROCESS):
            serving = scheduler_cli.serve(scheduler_cfg(i), device=args.device,
                                          scorer_blob=blob,
                                          rng=random.Random(args.seed + i))
            serving.job_worker.poll_timeout_s = 1.0
            servings.append(serving)
        child_records = os.path.join(work, f"records{IN_PROCESS}")
        env = dict(os.environ)
        env.update({
            "DRAGONFLY_SCHEDULER_SERVER_HOST": "127.0.0.1",
            "DRAGONFLY_SCHEDULER_SERVER_PORT": "0",
            "DRAGONFLY_SCHEDULER_STORAGE_DIR": child_records,
            "DRAGONFLY_SCHEDULER_STORAGE_BUFFER_SIZE": "1",
            "DRAGONFLY_SCHEDULER_SCHEDULING_ALGORITHM": "ml",
            "DRAGONFLY_SCHEDULER_SCHEDULING_RETRY_INTERVAL_S": "0",
            "DRAGONFLY_SCHEDULER_MANAGER_ADDR": manager.url,
            "DRAGONFLY_SCHEDULER_DYNCONFIG_REFRESH_S": str(args.refresh_s),
            # The diagnostics sidecar at the reference's default, on an
            # ephemeral port (its boot line carries the URL).
            "DRAGONFLY_SCHEDULER_METRICS_PORT": "0",
        })
        child = ChaosProcess(
            ["-m", "dragonfly2_tpu_torch.cli.scheduler", "--device", args.device,
             "--scorer-blob", blob_path],
            ready_prefixes=[READY_LINE, DIAG_LINE], env=env,
        ).start()
        ready = child.wait_ready(120)
        child_url = re.search(r"rpc on (\S+)", ready[READY_LINE]).group(1).rstrip(",")
        diag_url = re.search(r"diagnostics on (\S+)/metrics", ready[DIAG_LINE]).group(1)
        urls = [s.url for s in servings] + [child_url]
        port_of = {int(u.rsplit(":", 1)[1]): u for u in urls}

        # Ring v1: all three registered; the manager publishes them.
        cfg_url = f"{manager.url}/api/v1/clusters/default:config"
        ring1 = _wait(lambda: (lambda r: r if len(r.get("members", [])) == SCHEDULERS
                               else None)(_get_json(cfg_url).get("scheduler_ring", {})),
                      60, "the three-member ring")
        ring_v1 = ShardRing.from_payload(ring1)
        url_of = {m["id"]: port_of[int(m["url"].rsplit(":", 1)[1])]
                  for m in ring1["members"]}
        id_of = {u: sid for sid, u in url_of.items()}
        victim_id = id_of[child_url]
        guards = [s.shard_guard for s in servings]
        _wait(lambda: all(g.ring_version() == ring_v1.version for g in guards),
              30, "the in-process shards' adoption of ring v1")

        # Origins, one a file; each URL picked for its v1 owner.
        members = sorted(url_of)
        files = []
        for k in range(args.files):
            sha = _make_file(os.path.join(work, f"file{k}.bin"), size, args.seed + k)
            origin = Origin(os.path.join(work, f"file{k}.bin"))
            origin.serve()
            origins.append(origin)
            base = origin.url.rsplit("/", 1)[0]
            want = members[k % SCHEDULERS]
            url = next(u for u in (f"{base}/shard-fleet-{k}-{j}.bin" for j in range(10_000))
                       if ring_v1.owner(idgen.task_id(u)) == want)
            files.append({"url": url, "task_id": idgen.task_id(url), "sha256": sha,
                          "origin": origin, "owner_v1": want})
        victim_files = [k for k, f in enumerate(files) if f["owner_v1"] == victim_id]

        for i in range(args.daemons):
            dc = daemon_config(args, os.path.join(work, f"daemon{i}"), piece_size)
            nodes.append(dfdaemon.build(dc, ",".join(urls)))

        # Every shard answers announces with ring v1 (the child's guard
        # adopted it too), and every daemon holds it, before any task
        # traffic.
        def all_on(version, shard_urls):
            _announce_all(nodes)
            return all(n["client"].ring_version() == version for n in nodes) and all(
                _answer_ring_version(u, nodes[0]["host"]) == version for u in shard_urls)
        _wait(lambda: all_on(ring_v1.version, urls), 30,
              "ring v1 on every shard and daemon", interval=0.2)
        setup_s = time.perf_counter() - t_setup
        evs = [s.service.scheduling.evaluator for s in servings]
        calls0 = [ev.batcher.scorer_calls for ev in evs]
        redirects0 = metrics.SHARD_REDIRECTS_TOTAL.value()
        sheds0 = shed_counts()
        log(f"shard_fleet: ring v{ring_v1.version} {sorted(url_of)}, victim {victim_id} "
            f"owns files {victim_files}; {args.daemons} daemons, {args.files} files of "
            f"{size} bytes ({setup_s:.1f}s setup)")

        with _AdmissionWatch(guards) as watch:
            t0 = time.perf_counter()
            # Wave 1: one daemon a file, back to source, all files at once.
            threads, wave1 = _download_wave(
                nodes, [(k % args.daemons, k, f["url"]) for k, f in enumerate(files)],
                piece_size)
            for th in threads:
                th.join()
            t_wave1 = time.perf_counter()

            def wave2_jobs(ks):
                return [((k + 1 + j) % args.daemons, k, files[k]["url"])
                        for k in ks for j in range(wave2)]

            survivor_files = [k for k in range(args.files) if k not in victim_files]
            threads_a, wave2_a = _download_wave(nodes, wave2_jobs(survivor_files), piece_size)
            # The kill, with the survivors' wave 2 in flight.
            for s in servings:
                s.service.storage.flush()
            before = {sid: _records_by_task(s.service.storage)
                      for sid, s in zip((id_of[s.url] for s in servings), servings)}
            before[victim_id] = _records_by_task(Storage(child_records))
            # The child's own counters and spans, read off its sidecar.
            child_diag = scrape_diagnostics(diag_url)
            in_flight_at_kill = len(wave2_a) < len(threads_a)
            t_kill = time.perf_counter()
            child.sigkill()
            victim_port = int(child_url.rsplit(":", 1)[1])
            with clusters._mu:
                for inst in clusters._schedulers.values():
                    if inst.port == victim_port:
                        inst.last_keepalive = 0.0
            ring2 = _wait(lambda: (lambda r: r if len(r.get("members", [])) == SCHEDULERS - 1
                                   else None)(_get_json(cfg_url)["scheduler_ring"]),
                          30, "the manager's ring v2")
            t_manager = time.perf_counter()
            ring_v2 = ShardRing.from_payload(ring2)
            t_survivor = []
            for g in guards:
                _wait(lambda: g.ring_version() == ring_v2.version, 30,
                      "a survivor's adoption of ring v2")
                t_survivor.append(time.perf_counter())
            t_daemon = None
            deadline = time.monotonic() + 30
            while t_daemon is None and time.monotonic() < deadline:
                nodes[0]["announcer"].announce_once()
                if nodes[0]["client"].ring_version() == ring_v2.version:
                    t_daemon = time.perf_counter()
            if t_daemon is None:
                raise RuntimeError("shard_fleet: no daemon adopted ring v2")
            survivor_urls = [s.url for s in servings]
            _wait(lambda: all_on(ring_v2.version, survivor_urls), 30,
                  "ring v2 on every daemon", interval=0.2)
            threads_b, wave2_b = _download_wave(nodes, wave2_jobs(victim_files), piece_size)
            for th in threads_a + threads_b:
                th.join()
            t_end = time.perf_counter()
        scorer_calls = sum(ev.batcher.scorer_calls - c for ev, c in zip(evs, calls0))

        for s in servings:
            s.service.storage.flush()
        after = {id_of[s.url]: _records_by_task(s.service.storage) for s in servings}
        after[victim_id] = _records_by_task(Storage(child_records))
        results = {**{("w1",) + key: r for key, r in wave1.items()},
                   **{("w2",) + key: r for key, r in wave2_a.items()},
                   **{("w2",) + key: r for key, r in wave2_b.items()}}
        ok = {key: not isinstance(r, Exception) and r is not None and r.ok
              for key, r in results.items()}
        sha_ok = all(ok[key] and _task_sha256(nodes[key[1]]["storage"], r.task_id)
                     == files[key[2]]["sha256"] for key, r in results.items() if ok[key])
        owner_v2 = {k: ring_v2.owner(files[k]["task_id"]) for k in range(args.files)}
        records_before_ok = all(
            sid == files[k]["owner_v1"] or files[k]["task_id"] not in before[sid]
            for sid in before for k in range(args.files))
        victim_after_ok = all(
            after[owner_v2[k]].get(files[k]["task_id"], 0) == wave2
            and all(files[k]["task_id"] not in after[sid]
                    for sid in after if sid not in (owner_v2[k], victim_id))
            for k in victim_files)
        origin_bytes = {k: files[k]["origin"].bytes_served for k in range(args.files)}
        engine = engine_report(nodes)
        uploads = engine["served_pieces"]
        source_pieces = sum(f["origin"].requests for f in files)
        degrades = [ev.degrades for ev in evs]
        fallbacks = [ev.batcher.fallbacks for ev in evs]
        sheds = {k: v - sheds0.get(k, 0.0) for k, v in shed_counts().items()
                 if v - sheds0.get(k, 0.0)}
        swarm_s = t_end - t0
        downloads = len(results)
        summary = {
            "daemons": args.daemons, "files": args.files, "bytes": size,
            "piece_size": piece_size, "pieces": n_pieces, "wave2_per_file": wave2,
            "setup_seconds": setup_s, "wall_seconds": swarm_s,
            "wave1_seconds": t_wave1 - t0, "aggregate_mb_s": downloads * size / swarm_s / 1e6,
            "downloads": downloads, "downloads_ok": sum(ok.values()),
            "failures": [f"{key}: {r!r}" for key, r in results.items() if not ok[key]][:8],
            "ring_v1": {"version": ring_v1.version, "members": sorted(ring_v1.members())},
            "ring_v2": {"version": ring_v2.version, "members": sorted(ring_v2.members())},
            "victim": victim_id, "victim_files": victim_files,
            "survivor_wave2_in_flight_at_kill": in_flight_at_kill,
            "kill_to_v2_seconds": {"manager": t_manager - t_kill,
                                   "survivors": [t - t_kill for t in t_survivor],
                                   "first_daemon": t_daemon - t_kill},
            "child_returncode": child.proc.returncode,
            "origin_bytes": origin_bytes,
            "origin_bytes_victim_files": {k: origin_bytes[k] / size for k in victim_files},
            "pieces_by_source": {"source": source_pieces, "peers": sum(uploads)},
            "back_to_source": sum(1 for r in results.values()
                                  if not isinstance(r, Exception) and r is not None
                                  and r.back_to_source),
            "records_before_kill": before, "records_after": after,
            "owner_v1": {k: f["owner_v1"] for k, f in enumerate(files)},
            "owner_v2": owner_v2,
            "handoff_spans": handoffs.spans,
            "redirects": metrics.SHARD_REDIRECTS_TOTAL.value() - redirects0,
            "rule_degrades": degrades, "batcher_fallbacks": fallbacks,
            "scorer_calls": scorer_calls,
            "admission": {"sheds": sheds, "inflight_max": watch.inflight_max,
                          "overload_max": watch.overload_max,
                          "max_inflight": guards[0].admission.max_inflight,
                          "p99_budget_s": guards[0].admission.p99_budget_s},
            "child_output_tail": child.lines[-6:],
            "child_diagnostics": child_diag,
            "engine": engine,
        }
        survivor_ids = [id_of[s.url] for s in servings]
        summary["checks"] = {
            "ring_v1_three_members": len(ring_v1) == SCHEDULERS,
            "ring_v2_two_members_newer": len(ring_v2) == SCHEDULERS - 1
            and ring_v2.version > ring_v1.version and victim_id not in ring_v2,
            "survivors_adopted_v2": all(g.ring_version() == ring_v2.version for g in guards),
            "announce_answers_carry_v2": all(
                n["client"].ring_version() == ring_v2.version for n in nodes)
            and all(_answer_ring_version(u, nodes[0]["host"]) == ring_v2.version
                    for u in survivor_urls),
            "victim_sigkilled": child.proc.returncode == -9,
            "all_downloads_ok": all(ok.values()),
            "sha256_equal": sha_ok,
            "records_before_kill_on_v1_owner": records_before_ok,
            "victim_tasks_on_v2_owners": victim_after_ok,
            "handoff_span_each_survivor": sorted(
                {s.get("shard") for s in handoffs.spans
                 if s.get("ring_version") == ring_v2.version}) == sorted(survivor_ids),
            "survivor_origin_bytes_within_limit": all(
                origin_bytes[k] <= ORIGIN_BYTES_LIMIT * size
                for k in range(args.files) if k not in victim_files),
            "no_degrade": not any(degrades) and not any(fallbacks),
            "child_no_degrade": not any(
                marker in line for line in child.lines
                for marker in ("ranking with rules", "degrading to per-request", "Traceback")),
            "engine_ran": engine_ran(engine, True),
            # The child's scraped record counter equals the records the
            # phase read from its storage before the kill.
            "child_metrics_match_records": child_diag["download_records_total"]
            == sum(before[victim_id].values()) > 0 and child_diag["register_spans"] > 0,
        }
    finally:
        default_tracer.exporter = saved_exporter
        for n in nodes:
            n["announcer"].stop()
            n["piece_server"].stop()
        if child is not None:
            child.stop()
        for s in servings:
            s.stop()
        if manager is not None:
            manager.stop()
        for o in origins:
            o.stop()
        if saved_state is None:
            os.environ.pop(STATE_ENV, None)
        else:
            os.environ[STATE_ENV] = saved_state
        shutil.rmtree(work, ignore_errors=True)
        if not args.out:
            shutil.rmtree(out_dir, ignore_errors=True)
    finish_engine(summary)
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("shard_fleet: no CUDA device", file=sys.stderr)
            return 2
    summary = run(args, log=lambda line: print(line, file=sys.stderr))
    print(json.dumps(summary))
    return 0 if all(summary["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
