"""dfdaemon: the peer daemon service binary (reference: cmd/dfget daemon
mode + client/daemon/daemon.go).

Boots the data plane against a remote scheduler: piece storage, HTTP
piece server, host announcer, probe agent and the control API.
``--download URL`` performs one download through the running daemon and
exits (smoke mode).

Port of ``dragonfly2_tpu/cli/dfdaemon.py``: ``build`` and ``run`` with
the download path, and ``--seed-peer``: the host announces as
``SUPER_SEED``, a ``Seeder`` rides the loopback control server, and a
second, public ``DaemonControlServer`` serving only ``/healthy`` and
``/obtain_seeds`` puts its port into the announce, where the scheduler's
``RemoteSeedPeerClient`` dials it (``seed_peer`` composes that part).
A comma-separated scheduler list builds the reference's
``rpc/steering.SteeringSchedulerClient``: each task's calls go to its
owner on the consistent-hash ring (the shard ring the schedulers publish
on announce answers, once one has), announces fan out to every
scheduler.  A ``grpc://`` scheduler is dialed with
``rpc/grpc_transport.GRPCStreamingScheduler``: per-peer calls ride the
bidi ``announce_peer`` stream, and the conductor adopts the reschedules
the scheduler pushes (on a machine without ``grpc`` or ``protobuf`` it
exits 2 naming the package).  What is not ported exits 2 naming its
ROADMAP queue 1 item: ``--pex-port`` (``daemon/pex_net.py``), the
config's ``security`` and ``proxy.sni_*`` keys and ``control_vsock_port``
(all item 14).  At the defaults the piece store, the piece server and
the fetch loop are the port's native engine, as in the reference
(``native_fetch`` and the engine's build decide; without a library the
Python ones run).  ``run`` starts the diagnostics sidecar (``metrics``:
port 8000 by default; a port in use only warns) and stops it on exit,
and stops on SIGTERM as on SIGINT.
"""

from __future__ import annotations

import logging
import signal
import socket
import sys
import threading

from ..config import ConfigError, DaemonConfig, load_config
from ..daemon import DaemonStorage, UploadManager
from ..daemon.conductor import Conductor
from ..daemon.host_announcer import HostAnnouncer
from ..rpc import HTTPPieceFetcher
from ..scheduler.resource import Host
from ..source import PieceSourceFetcher
from ..utils import idgen
from ..utils.ping import make_host_pinger
from .common import (
    base_parser,
    grpc_transport,
    init_debug,
    init_diagnostics,
    init_flight_recorder,
    init_logging,
    init_telemetry,
    init_tracing,
    stop_telemetry,
)

log = logging.getLogger(__name__)


def _scheduler_urls(scheduler_url: str) -> list:
    """The scheduler addresses, split as the reference splits them;
    raises ``ConfigError`` for none, or for a ``grpc://`` one on a
    machine without the gRPC packages."""
    # Comma-separated scheduler list → consistent-hash steering: each
    # task's swarm state lives on ONE replica (pkg/balancer semantics,
    # the reference's rpc/steering.py).
    scheduler_urls = [u.strip() for u in scheduler_url.split(",") if u.strip()]
    if not scheduler_urls:
        raise ConfigError("dfdaemon: no scheduler address")
    if any(u.startswith("grpc://") for u in scheduler_urls):
        grpc_transport("a grpc:// scheduler")
    return scheduler_urls


def build(cfg: DaemonConfig, scheduler_url: str, *, prefer_native: bool = True):
    """Daemon composition against a wire scheduler, or a comma-separated
    list of them (daemon.go:118-417).  ``prefer_native=False`` builds the
    Python piece store, and with it the Python piece server (the
    reference's composition always prefers the native engine)."""
    scheduler_urls = _scheduler_urls(scheduler_url)
    if cfg.source:
        from ..source import configure_sources

        configure_sources(cfg.source)
    storage = DaemonStorage(cfg.storage.dir, quota_bytes=cfg.storage.quota_bytes,
                            prefer_native=prefer_native)
    upload = UploadManager(storage, concurrent_limit=cfg.concurrent_upload_limit)

    hostname = socket.gethostname()
    from ..utils.hostinfo import local_ip

    # Advertise a routable address — peers on OTHER machines dial it.
    ip = cfg.server.advertise_ip or local_ip()

    # Native-engine stores serve pieces from the C++ server (sendfile hot
    # path); Python HTTP remains the fallback/TLS server.
    from ..rpc.piece_transport import make_piece_server

    # Bind the CONFIGURED piece port (0 = ephemeral): deployments pin it
    # (k8s containerPort / NetworkPolicies key on it) while test
    # clusters pass 0.
    piece_server = make_piece_server(upload, host=cfg.server.host, port=cfg.server.port)
    piece_server.serve()
    host = Host(
        # The piece port joins the identity so multiple daemons on one
        # machine are distinct hosts (reference: hostname-port host ids,
        # pkg/idgen/host_id.go v1).
        id=idgen.host_id_v2(ip, f"{hostname}-{piece_server.port}"),
        hostname=hostname,
        ip=ip,
        port=cfg.server.port,
        download_port=piece_server.port,
        concurrent_upload_limit=cfg.concurrent_upload_limit,
    )
    from ..rpc.steering import SteeringSchedulerClient, default_scheduler_factory

    if len(scheduler_urls) > 1:
        client = SteeringSchedulerClient(scheduler_urls)
    else:
        # grpc:// → the streaming client (pushed reschedules), else HTTP.
        client = default_scheduler_factory(scheduler_urls[0])
    # Declared tenant identity (DESIGN.md §26): stamped on announces and
    # registers; the wire client carries it as client state.
    if cfg.tenant and hasattr(client, "tenant"):
        client.tenant = cfg.tenant
    conductor = Conductor(
        host,
        storage,
        client,
        piece_fetcher=HTTPPieceFetcher(
            client.resolve_host, tenant=cfg.tenant
        ),
        source_fetcher=PieceSourceFetcher(),
        concurrent_source_groups=cfg.concurrent_source_groups,
        stream_tee_depth=cfg.stream_tee_depth,
        native_fetch=cfg.native_fetch,
        tenant=cfg.tenant,
    )
    announcer = HostAnnouncer(host, client, tenant=cfg.tenant)

    # Tenant QoS adoption (DESIGN.md §26): schedulers re-publish the
    # manager's tenant_qos table on announce answers (the §24 ring
    # discipline); each announce adopts the newest payload into the
    # upload-path bandwidth caps.  Payload-version comparison is cheap
    # (dict equality on a small table) and malformed payloads are
    # skipped — an adoption bug must not kill the announcer loop.
    adopted: list = [None]

    def _adopt_tenant_qos() -> None:
        payload = getattr(client, "tenant_qos", None)
        if not isinstance(payload, dict) or payload == adopted[0]:
            return
        from ..qos.policy import QoSPolicy

        try:
            policy = QoSPolicy.from_payload(payload)
        except (KeyError, TypeError, ValueError):
            return
        adopted[0] = payload
        upload.set_qos_policy(policy)

    announcer.on_announced = _adopt_tenant_qos
    return {
        "storage": storage,
        "upload": upload,
        "piece_server": piece_server,
        "host": host,
        "client": client,
        "conductor": conductor,
        "announcer": announcer,
    }


def seed_peer(parts: dict, cfg: DaemonConfig) -> dict:
    """Seed mode (seeder.go:41-151) over ``build``'s parts: the host
    becomes a SUPER_SEED and a public seed endpoint (``/obtain_seeds`` and
    ``/healthy`` only), bound on the serving address, serves a ``Seeder``;
    its port goes into the host announce, so call this before the first
    announce.  → ``{"seeder", "seed_endpoint"}``; pass the seeder to the
    loopback ``DaemonControlServer`` too, as ``run`` does."""
    from ..daemon.seeder import Seeder
    from ..rpc.daemon_control import DaemonControlServer
    from ..utils.types import HostType

    parts["host"].type = HostType.SUPER_SEED
    seeder = Seeder(parts["conductor"], parts["storage"])
    # Separate PUBLIC surface for the scheduler's cross-process trigger:
    # /obtain_seeds (+/healthy) only, bound on the serving address and
    # advertised via the host announce's port.
    seed_endpoint = DaemonControlServer(
        parts["conductor"], piece_size=cfg.piece_size,
        host=cfg.server.host, seeder=seeder, public=True,
    )
    seed_endpoint.serve()
    parts["host"].port = seed_endpoint.address[1]
    return {"seeder": seeder, "seed_endpoint": seed_endpoint}


def run(argv=None) -> int:
    p = base_parser("dfdaemon", "Peer daemon service")
    p.add_argument("--scheduler", required=True, help="scheduler RPC URL")
    p.add_argument("--download", default=None, metavar="URL",
                   help="download one URL through the daemon and exit")
    p.add_argument("-O", "--output", default=None, help="output path (--download)")
    p.add_argument("--seed-peer", action="store_true",
                   help="announce as a seed peer and serve the ObtainSeeds "
                        "endpoint the scheduler triggers cold tasks through")
    p.add_argument("--pex-port", type=int, default=-1, metavar="PORT",
                   help="networked peer-exchange gossip on this UDP port "
                        "(not ported: ROADMAP queue 1 item 14; -1 = disabled)")
    p.add_argument("--pex-join", default="", metavar="HOST:PORT[,...]",
                   help="gossip seed addresses to join (with --pex-port)")
    args = p.parse_args(argv)
    init_logging(args, "dfdaemon")
    debug = init_debug(args)
    init_tracing(args)
    journal = engine = diagnostics = None
    parts = control = seed = None
    try:
        if args.pex_port >= 0:
            print("dfdaemon: --pex-port: networked peer exchange (daemon/pex_net.py) "
                  "is not ported yet (ROADMAP queue 1 item 14)", file=sys.stderr)
            return 2
        try:
            cfg = load_config(DaemonConfig, args.config)
            init_flight_recorder(args, cfg.tracing, "dfdaemon")
            journal, engine = init_telemetry(args, cfg.telemetry, "dfdaemon")
            diagnostics = init_diagnostics(cfg.metrics, "dfdaemon")
            parts = build(cfg, args.scheduler)
        except ConfigError as exc:
            print(f"dfdaemon: {exc}", file=sys.stderr)
            return 2

        # Control API (daemon Download RPC analog): loopback by DEFAULT —
        # /download writes local files on behalf of same-machine dfget.
        # `control_host` may widen the bind for trusted pod/compose
        # networks, which trades that isolation for in-network
        # drivability — never expose it on a routable interface outside
        # such a boundary.
        from ..rpc.daemon_control import DaemonControlServer, write_state

        if args.seed_peer:
            # Seed mode: announce as SUPER_SEED and carry the public seed
            # endpoint's port in the announce so the scheduler's trigger
            # client (scheduler/seed_client.py) can dial /obtain_seeds.
            seed = seed_peer(parts, cfg)
        control = DaemonControlServer(
            parts["conductor"], piece_size=cfg.piece_size,
            host=cfg.control_host, port=cfg.control_port,
            # The seeder rides the loopback server too (not just the
            # public seed endpoint), as in the reference.
            seeder=seed["seeder"] if seed is not None else None,
        )
        control.serve()
        parts["announcer"].serve()

        if args.download:
            content_length = parts["conductor"].probe_content_length(args.download)
            if content_length is None or content_length < 0:
                print(f"dfdaemon: cannot size {args.download}", file=sys.stderr)
                return 1
            result = parts["conductor"].download(
                args.download, piece_size=cfg.piece_size, content_length=content_length
            )
            if not result.ok:
                print("dfdaemon: download failed", file=sys.stderr)
                return 1
            if args.output:
                with open(args.output, "wb") as f:
                    f.write(parts["storage"].read_task_bytes(result.task_id))
            mode = "back-to-source" if result.back_to_source else "p2p"
            print(f"dfdaemon: {result.pieces} pieces via {mode} in {result.cost_s:.2f}s")
            return 0

        # Discovery state file so dfget finds or spawns this daemon
        # (root.go:234-260).  write_state uses state_path() — the SAME
        # resolution dfget reads, so writer and reader can never disagree.
        state_file = write_state(control.url)

        # Probe loop against the remote scheduler, until SIGINT or SIGTERM.
        ping = make_host_pinger()
        print(
            f"dfdaemon: serving pieces on :{parts['piece_server'].port}, "
            f"control {control.url} (state {state_file}), "
            f"scheduler {args.scheduler} (ctrl-c to stop)",
            flush=True,
        )
        stop = threading.Event()
        previous = {
            s: signal.signal(s, lambda signum, frame: stop.set())
            for s in (signal.SIGINT, signal.SIGTERM)
        }
        try:
            while not stop.wait(cfg.probe_interval_s):
                try:
                    targets = parts["client"].sync_probes_start(parts["host"])
                    results = []
                    for t in targets:
                        rtt = ping(t)
                        if rtt is not None:
                            results.append((t.id, rtt))
                    if results:
                        parts["client"].sync_probes_finished(parts["host"], results)
                except Exception as exc:  # noqa: BLE001 — probe failures must not kill the daemon
                    log.debug("probe sweep failed: %s", exc)
        finally:
            for s, handler in previous.items():
                signal.signal(s, handler)
        return 0
    finally:
        if parts is not None:
            parts["announcer"].stop()
            parts["piece_server"].stop()
        if control is not None:
            control.stop()
        if seed is not None:
            seed["seed_endpoint"].stop()
            seed["seeder"].queue.stop()
        stop_telemetry(journal, engine)
        if diagnostics is not None:
            diagnostics.stop()
        if debug is not None:
            debug.stop()


if __name__ == "__main__":
    sys.exit(run())
