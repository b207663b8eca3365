"""Port parity: the sharded-fleet chaos drill of
``tests/test_shard_chaos.py``, run on the port: SIGKILL one scheduler
shard mid-swarm.

Topology: the port's in-process manager (``ShardDirectory`` publishes
the ring with the cluster dynconfig), TWO port scheduler shard
subprocesses (``python -m dragonfly2_tpu_torch.cli.scheduler --device
cpu`` with durable flight-recorder logs, spawned by the port's
``sim.chaos.ChaosProcess``), the port's in-process warm parent daemon,
and a test-driven downloading client that routes by the published ring
over the real HTTP wire.

Proven:

- the victim dies by SIGKILL mid-download (returncode −9) and the
  manager's keepalive expiry bumps the ring version — the next
  ``:config`` poll publishes a one-member ring;
- the task MIGRATES: parent and child re-announce + re-register on the
  surviving shard (waiting out its own dynconfig adoption — a register
  that lands before it still steers to the dead owner and is retried),
  and the download completes with the remaining pieces;
- every completed download digest-checks against the origin bytes;
- the port's reader, ``bench/trace_assemble.py``, stitches the three
  surviving logs into ONE trace spanning both shards and the client,
  with ZERO corrupt frames, and renders the cross-shard handoff span on
  the critical path.
"""

from __future__ import annotations

import hashlib
import json
import re
import sys
import time
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dragonfly2_tpu_torch.sim.chaos import ChaosProcess, sha256_hex  # noqa: E402
from dragonfly2_tpu_torch.utils import tracing  # noqa: E402

PIECE = 32 * 1024
N_PIECES = 6


class _Origin:
    def fetch(self, url, number, piece_size):
        return bytes((number * 13 + i) % 251 for i in range(PIECE))


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


class TestTorchShardKillDrill:
    def test_sigkill_shard_task_migrates_and_digest_checks(self, tmp_path):
        from dragonfly2_tpu_torch.daemon import DaemonStorage, UploadManager
        from dragonfly2_tpu_torch.daemon.conductor import Conductor
        from dragonfly2_tpu_torch.manager.cluster import ClusterManager
        from dragonfly2_tpu_torch.manager.registry import ModelRegistry
        from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer
        from dragonfly2_tpu_torch.rpc import (
            HTTPPieceFetcher,
            PieceHTTPServer,
            RemoteScheduler,
        )
        from dragonfly2_tpu_torch.scheduler.resource import Host
        from dragonfly2_tpu_torch.scheduler.sharding import (
            ShardRing,
            WrongShardError,
            handoff_span,
        )
        from dragonfly2_tpu_torch.utils import idgen

        clusters = ClusterManager()
        manager = ManagerRESTServer(ModelRegistry(), clusters)
        manager.serve()
        mgr_url = f"http://{manager.address[0]}:{manager.address[1]}"

        def spawn(i: int) -> ChaosProcess:
            cfg = tmp_path / f"shard{i}.yaml"
            cfg.write_text(
                "server: {host: 127.0.0.1, port: 0, grpc_port: -1}\n"
                "scheduling: {retry_interval_s: 0.0}\n"
                f"storage: {{dir: {tmp_path / f'rec{i}'}, buffer_size: 1}}\n"
                f"manager_addr: {mgr_url}\n"
                "dynconfig_refresh_s: 0.5\n"
                f"tracing: {{log_path: {tmp_path / f'shard{i}.dftrace'}, "
                "sample_rate: 1.0}\n"
            )
            return ChaosProcess(
                ["-m", "dragonfly2_tpu_torch.cli.scheduler", "--config", str(cfg),
                 "--device", "cpu"],
                ready_prefixes=["scheduler: serving"],
            ).start()

        shards = [spawn(0), spawn(1)]
        piece_server = None
        client_log = str(tmp_path / "client.dftrace")
        prev_exporter = tracing.default_tracer.exporter
        try:
            urls_by_port: dict = {}
            for proc in shards:
                line = proc.wait_ready(120)["scheduler: serving"]
                rpc_url = re.search(r"rpc on (\S+)", line).group(1).rstrip(",")
                port = int(rpc_url.rsplit(":", 1)[1])
                urls_by_port[port] = rpc_url

            # Ring v1: both shards registered themselves with the
            # manager; the cluster dynconfig publishes them.
            deadline = time.monotonic() + 30
            ring_payload: dict = {}
            while time.monotonic() < deadline:
                cfg = _get_json(f"{mgr_url}/api/v1/clusters/default:config")
                ring_payload = cfg.get("scheduler_ring", {})
                if len(ring_payload.get("members", [])) == 2:
                    break
                time.sleep(0.3)
            assert len(ring_payload.get("members", [])) == 2, ring_payload
            ring = ShardRing.from_payload(ring_payload)
            id_by_url = {m["url"]: m["id"] for m in ring_payload["members"]}

            # A url whose task id the FIRST member owns: that shard is
            # the victim; the other survives.
            url, tid, victim_id = next(
                (u, t, ring.owner(t))
                for u, t in (
                    (f"drill://shard-chaos/{i}",
                     idgen.task_id(f"drill://shard-chaos/{i}"))
                    for i in range(64)
                )
            )
            victim_url = ring.url_of(victim_id)
            survivor_id = next(
                sid for sid in ring.members() if sid != victim_id
            )
            survivor_url = ring.url_of(survivor_id)
            victim_proc = shards[
                list(urls_by_port).index(int(victim_url.rsplit(":", 1)[1]))
            ]

            content_length = N_PIECES * PIECE
            want = hashlib.sha256(
                b"".join(
                    _Origin().fetch(url, n, PIECE) for n in range(N_PIECES)
                )
            ).hexdigest()

            # Warm parent on the victim shard (real daemon conductor:
            # registers, pulls from origin, reports pieces).
            pstore = DaemonStorage(str(tmp_path / "parent"))
            piece_server = PieceHTTPServer(UploadManager(pstore))
            piece_server.serve()
            phost = Host(
                id="drill-parent", hostname="drill-parent", ip="127.0.0.1",
                download_port=piece_server.port,
            )
            phost.stats.network.idc = "idc-a"
            victim_client = RemoteScheduler(victim_url, timeout=5.0)
            parent = Conductor(
                phost, pstore, victim_client,
                piece_fetcher=HTTPPieceFetcher(victim_client.resolve_host),
                source_fetcher=_Origin(),
            )
            warm = parent.download(
                url, piece_size=PIECE, content_length=content_length
            )
            assert warm.ok and warm.pieces == N_PIECES
            assert sha256_hex(pstore.read_task_bytes(tid)) == want

            # The drill's flight-recorder log for the client process.
            drill_exporter = tracing.DurableSpanExporter(
                client_log, service="dfdaemon", sample_rate=1.0
            )
            tracing.default_tracer.exporter = drill_exporter

            chost = Host(
                id="drill-child", hostname="drill-child", ip="127.0.0.1",
                download_port=0,
            )
            chost.stats.network.idc = "idc-a"
            fetch = HTTPPieceFetcher(
                lambda host_id: ("127.0.0.1", piece_server.port)
            )
            got: dict = {}
            with tracing.default_tracer.span("daemon/download", url=url):
                victim_client.announce_host(chost)
                reg = victim_client.register_peer(
                    host=chost, url=url, task_id=tid
                )
                parents = reg.schedule.parents
                assert parents, "child got no parents on the victim shard"
                for n in range(3):
                    got[n] = fetch.fetch(parents[0].host.id, tid, n)
                    victim_client.report_piece_finished(
                        reg.peer, n, parent_id=parents[0].id,
                        length=PIECE, cost_ns=10**6,
                    )

                # Mid-swarm kill: pieces 3..5 are still outstanding.
                victim_proc.sigkill()
                assert victim_proc.proc.returncode == -9

                # Keepalive expiry (deterministic): age the victim's
                # last tick out of the TTL instead of sleeping 60 s.
                with clusters._mu:
                    for inst in clusters._schedulers.values():
                        if victim_url.endswith(f":{inst.port}"):
                            inst.last_keepalive = 0.0
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    cfg = _get_json(
                        f"{mgr_url}/api/v1/clusters/default:config"
                    )
                    members = cfg["scheduler_ring"]["members"]
                    if [m["id"] for m in members] == [survivor_id]:
                        break
                    time.sleep(0.3)
                assert [m["id"] for m in members] == [survivor_id], members
                ring_v2 = cfg["scheduler_ring"]["version"]
                assert ring_v2 > ring_payload["version"]

                # The cross-shard handoff, client side: re-announce the
                # swarm on the new owner and finish the download there.
                # Registers racing the survivor's own dynconfig adoption
                # still steer to the dead owner — retried until the
                # survivor's guard has the v2 ring.
                survivor_client = RemoteScheduler(survivor_url, timeout=5.0)
                with handoff_span(
                    tid, from_shard=victim_id, to_shard=survivor_id,
                    ring_version=ring_v2,
                ):
                    survivor_client.announce_host(phost)
                    survivor_client.announce_host(chost)
                    deadline = time.monotonic() + 20
                    preg = None
                    while preg is None and time.monotonic() < deadline:
                        try:
                            preg = survivor_client.register_peer(
                                host=phost, url=url, task_id=tid
                            )
                        except WrongShardError:
                            time.sleep(0.3)
                    assert preg is not None, (
                        "survivor never adopted the v2 ring"
                    )
                    survivor_client.set_task_info(
                        preg.peer, content_length, N_PIECES, PIECE
                    )
                    for n in range(N_PIECES):
                        survivor_client.report_piece_finished(
                            preg.peer, n, parent_id="",
                            length=PIECE, cost_ns=10**6,
                        )
                    survivor_client.report_peer_finished(preg.peer)

                    reg2 = survivor_client.register_peer(
                        host=chost, url=url, task_id=tid
                    )
                    parents2 = reg2.schedule.parents
                    assert parents2, "task did not migrate with a parent"
                    assert parents2[0].host.id == phost.id
                    for n in range(3, N_PIECES):
                        got[n] = fetch.fetch(parents2[0].host.id, tid, n)
                        survivor_client.report_piece_finished(
                            reg2.peer, n, parent_id=parents2[0].id,
                            length=PIECE, cost_ns=10**6,
                        )
                    survivor_client.report_peer_finished(reg2.peer)

            # Every completed download digest-checks.
            assert (
                hashlib.sha256(
                    b"".join(got[n] for n in range(N_PIECES))
                ).hexdigest()
                == want
            )
            drill_exporter.close()
        finally:
            tracing.default_tracer.exporter = prev_exporter
            if piece_server is not None:
                piece_server.stop()
            for proc in shards:
                proc.stop()
            manager.stop()

        # -- flight-recorder evidence ------------------------------------
        from dragonfly2_tpu_torch.bench.trace_assemble import build_report, render_report

        logs = [
            str(tmp_path / "shard0.dftrace"),
            str(tmp_path / "shard1.dftrace"),
            client_log,
        ]
        report = build_report(logs, validate=True)
        for log in report["logs"]:
            assert log["corrupt"] == 0, log  # zero corrupt frames
            assert log["frames"] > 0, log    # every process left spans
        trace = report["trace"]
        # ONE trace spans the client and BOTH shard processes: handler
        # spans for the task live in both logs (register/report on the
        # victim before the kill, on the survivor after).
        assert "dfdaemon" in trace["services"]
        assert "scheduler" in trace["services"]
        shard_logs = {log["path"]: log for log in report["logs"]}
        assert shard_logs[str(tmp_path / "shard0.dftrace")]["frames"] > 0
        assert shard_logs[str(tmp_path / "shard1.dftrace")]["frames"] > 0
        # The cross-shard handoff is ON the critical path.
        path_names = [hop["name"] for hop in trace["critical_path"]]
        assert any(n == "scheduler/shard.handoff" for n in path_names), (
            path_names
        )
        rendered = render_report(report)
        assert "shard.handoff" in rendered
