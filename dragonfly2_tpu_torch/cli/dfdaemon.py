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
exits 2 naming the package).  ``--pex-port`` / ``--pex-join`` run the
networked peer exchange (``daemon/pex_net.NetworkedGossipBus``) as the
reference wires it: the conductor's ``pex`` falls back to gossip-found
piece holders, and piece fetches resolve hosts through the scheduler's
mirror first and the gossip members second.  As in the reference,
``security.auto_issue`` requests the daemon's identity from the
manager's CA at boot (``manager_addr``, with ``manager_token``): the
piece server and fetcher then speak mutual TLS (the Python server: the
native one speaks plain HTTP, and the native fetch loop cannot dial TLS),
an ``IdentityRenewer`` reloads both contexts at half validity, and a
``grpc://`` scheduler is dialed over mTLS when
``security.scheduler_grpc_tls`` holds.  ``proxy.sni_enable`` starts the
SNI proxy (``start_sni``) and ``control_vsock_port >= 0`` binds the
control surface on vsock, or warns where vsock is unusable.  As in
the reference, no binary starts the forward proxy
(``daemon/proxy.P2PProxy``): ``proxy.enable`` is a key nothing reads.
At the defaults the piece store, the piece server and
the fetch loop are the port's native engine, as in the reference
(``native_fetch`` and the engine's build decide; without a library the
Python ones run).  ``run`` starts the diagnostics sidecar (``metrics``:
port 8000 by default; a port in use only warns) and stops it on exit,
and stops on SIGTERM as on SIGINT.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import sys
import threading

from ..config import ConfigError, DaemonConfig, load_config
from ..daemon import DaemonStorage, UploadManager
from ..daemon.conductor import Conductor
from ..daemon.daemon import Daemon
from ..daemon.host_announcer import HostAnnouncer
from ..rpc import HTTPPieceFetcher
from ..rpc.steering import SteeringSchedulerClient, default_scheduler_factory
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
    report_launches,
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
    reference's composition always prefers the native engine).  The
    parts' ``daemon`` is ``daemon.daemon.Daemon``'s surface over them, the
    one a proxy or an object gateway takes."""
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

    # Auto-issued mTLS (certify analog, scheduler.go:186-222): request
    # this daemon's identity from the manager's cluster CA at boot; the
    # piece plane then serves AND fetches over mutual TLS.
    identity = None
    serve_ssl = fetch_ssl = None
    renewer = None
    if cfg.security.auto_issue:
        if not cfg.manager_addr:
            raise ConfigError("dfdaemon: security.auto_issue needs manager_addr")
        from ..security.ca import IdentityRenewer, PeerIdentity
        from ..security.tls import client_context, server_context

        def _issue_identity():
            ident = PeerIdentity.request_from_manager(
                cfg.manager_addr,
                common_name=f"daemon-{hostname}",
                hostnames=[hostname],
                ips=[ip],
                token=cfg.manager_token or None,
                ttl_hours=cfg.security.cert_ttl_hours,
            )
            if cfg.security.identity_dir:
                ident.write(cfg.security.identity_dir)
            return ident

        identity = _issue_identity()
        serve_ssl = server_context(identity)
        fetch_ssl = client_context(identity)
        # Short-TTL certs stay alive: re-issue at half validity and
        # reload both piece-plane contexts in place.
        renewer = IdentityRenewer(
            identity, _issue_identity, [serve_ssl, fetch_ssl]
        ).start()

    # Native-engine stores serve pieces from the C++ server (sendfile hot
    # path); Python HTTP remains the fallback/TLS server.
    from ..rpc.piece_transport import make_piece_server

    # Bind the CONFIGURED piece port (0 = ephemeral): deployments pin it
    # (k8s containerPort / NetworkPolicies key on it) while test
    # clusters pass 0.
    piece_server = make_piece_server(
        upload, host=cfg.server.host, port=cfg.server.port,
        ssl_context=serve_ssl,
    )
    piece_server.serve()
    channel_creds = None
    if identity is not None and cfg.security.scheduler_grpc_tls and any(
        u.startswith("grpc://") for u in scheduler_urls
    ):
        # The scheduler's gRPC port runs mTLS when the cluster
        # auto-issues — dial with this daemon's issued identity.
        # (security.scheduler_grpc_tls: false covers mixed clusters
        # whose scheduler port is still plaintext.)
        channel_creds = grpc_transport("a grpc:// scheduler").grpc.ssl_channel_credentials(
            root_certificates=identity.ca_pem,
            private_key=identity.key_pem,
            certificate_chain=identity.cert_pem,
        )

    def scheduler_client_cls(url: str):
        if url.startswith("grpc://"):
            # Streaming variant: per-peer calls ride the bidi
            # announce_peer stream so the scheduler can push
            # mid-download reschedules (unary fallback on stream
            # failure).
            from ..rpc.grpc_transport import GRPCStreamingScheduler

            return GRPCStreamingScheduler(
                url[len("grpc://"):], channel_credentials=channel_creds
            )
        return default_scheduler_factory(url)

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
    if len(scheduler_urls) > 1:
        client = SteeringSchedulerClient(
            scheduler_urls, factory=scheduler_client_cls
        )
    else:
        # grpc:// → the streaming client (pushed reschedules), else HTTP.
        client = scheduler_client_cls(scheduler_urls[0])
    # Declared tenant identity (DESIGN.md §26): stamped on announces and
    # registers; the wire client carries it as client state.
    if cfg.tenant and hasattr(client, "tenant"):
        client.tenant = cfg.tenant
    conductor = Conductor(
        host,
        storage,
        client,
        piece_fetcher=HTTPPieceFetcher(
            client.resolve_host, ssl_context=fetch_ssl, tenant=cfg.tenant
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
        "daemon": Daemon.over(host, client, storage, upload, conductor, tenant=cfg.tenant),
        "identity": identity,
        "renewer": renewer,
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


def start_pex(parts: dict, cfg: DaemonConfig, port: int, join: str = ""):
    """Networked gossip over ``build``'s parts (reference
    ``cli/dfdaemon.py:226-273``): a ``NetworkedGossipBus`` on UDP ``port``
    (0 = ephemeral) joining the ``HOST:PORT`` seeds in ``join``, a
    ``PeerExchange`` serving on it as the conductor's ``pex``, and the
    piece fetcher's resolver chained through the gossip members; prints
    the reference's boot line.  → the ``PeerExchange`` (``stop()`` leaves
    the bus; ``run`` calls it on exit, where the reference leaves it to the
    process's exit)."""
    # Networked gossip (pex memberlist analog): piece-holder discovery
    # that keeps serving through scheduler outages.
    from ..daemon.pex import MemberMeta, PeerExchange
    from ..daemon.pex_net import NetworkedGossipBus

    seeds = []
    for part in filter(None, join.split(",")):
        h, _, pp = part.rpartition(":")
        seeds.append((h or "127.0.0.1", int(pp)))
    bus = NetworkedGossipBus(
        host=cfg.server.host, port=port, seeds=seeds,
        advertise_ip=parts["host"].ip,
    )
    pex = PeerExchange(
        MemberMeta(
            host_id=parts["host"].id,
            ip=parts["host"].ip,
            port=parts["piece_server"].port,
        ),
        bus,
    )
    pex.serve()
    parts["conductor"].pex = pex

    # Resolver chain: scheduler mirror first, gossip metadata second —
    # piece fetches keep resolving when the control plane is down.
    client = parts["client"]

    def resolve(host_id):
        try:
            return client.resolve_host(host_id)
        except KeyError:
            m = pex.member(host_id)
            if m is None:
                raise
            return m.ip, m.port

    # Keep the mTLS client identity (and the requester-pays tenant
    # stamp) through the resolver swap.
    old_fetcher = parts["conductor"].piece_fetcher
    parts["conductor"].piece_fetcher = HTTPPieceFetcher(
        resolve, ssl_context=getattr(old_fetcher, "ssl_context", None),
        tenant=getattr(old_fetcher, "tenant", ""),
    )
    print(f"dfdaemon: pex gossip on udp:{bus.address[1]}", flush=True)
    return pex


def start_sni(parts: dict, cfg: DaemonConfig):
    """The SNI-hijack proxy over ``build``'s parts (reference
    ``cli/dfdaemon.py:357-394``): the persistent daemon CA under
    ``storage.dir/sni-ca`` (restarts keep the trust anchor clients
    installed), its certificate written to ``storage.dir/sni-ca.pem``, and
    a ``daemon.sni.SNIProxy`` on ``server.host:proxy.sni_port`` hijacking
    ``proxy.sni_hijack_hosts`` into P2P; prints the reference's boot line.
    → ``(proxy, ca_path)``; ``proxy.stop()`` closes its listener."""
    from ..daemon.sni import SNIProxy
    from ..security.ca import CertificateAuthority

    class _DaemonShim:
        """SNIProxy's daemon surface over the CLI's parts."""

        def __init__(self, conductor, storage):
            self.conductor = conductor
            self._storage = storage

        def download(self, url, piece_size, content_length=None):
            return self.conductor.download(
                url, piece_size=piece_size, content_length=content_length
            )

        def read_task_bytes(self, task_id):
            return self._storage.read_task_bytes(task_id)

    # Persistent: restarts keep the same trust anchor, so clients that
    # installed sni-ca.pem don't break on every deploy.
    ca = CertificateAuthority.persistent(os.path.join(cfg.storage.dir, "sni-ca"))
    ca_path = os.path.join(cfg.storage.dir, "sni-ca.pem")
    os.makedirs(cfg.storage.dir, exist_ok=True)
    with open(ca_path, "wb") as f:
        f.write(ca.cert_pem)
    sni = SNIProxy(
        _DaemonShim(parts["conductor"], parts["storage"]),
        ca=ca,
        hijack=cfg.proxy.sni_hijack_hosts,
        host=cfg.server.host,
        port=cfg.proxy.sni_port,
        piece_size=cfg.piece_size,
    )
    sni.serve()
    print(f"dfdaemon: SNI proxy on :{sni.port}, trust anchor {ca_path}", flush=True)
    return sni, ca_path


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
                   help="enable networked peer-exchange gossip on this UDP "
                        "port (0 = ephemeral, -1 = disabled)")
    p.add_argument("--pex-join", default="", metavar="HOST:PORT[,...]",
                   help="gossip seed addresses to join")
    args = p.parse_args(argv)
    init_logging(args, "dfdaemon")
    debug = init_debug(args)
    init_tracing(args)
    journal = engine = diagnostics = None
    parts = control = seed = pex = sni = None
    try:
        try:
            cfg = load_config(DaemonConfig, args.config)
            init_flight_recorder(args, cfg.tracing, "dfdaemon")
            journal, engine = init_telemetry(args, cfg.telemetry, "dfdaemon")
            diagnostics = init_diagnostics(cfg.metrics, "dfdaemon")
            parts = build(cfg, args.scheduler)
        except ConfigError as exc:
            print(f"dfdaemon: {exc}", file=sys.stderr)
            return 2

        if args.pex_port >= 0:
            pex = start_pex(parts, cfg, args.pex_port, args.pex_join)

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
        if cfg.control_vsock_port >= 0:
            # VM-guest wire (pkg/rpc/vsock.go): same control handler, vsock
            # listener — guests dial vsock://2:<port> with no network stack.
            from ..rpc.vsock import vsock_available

            try:
                if not vsock_available():
                    raise OSError("AF_VSOCK unavailable")
                vport = control.serve_vsock(cfg.control_vsock_port)
                print(f"dfdaemon: control also on vsock:{vport}", flush=True)
            except OSError as exc:
                # socket() succeeding does not guarantee bind() does (module
                # loaded, no transport registered) — degrade to TCP-only
                # rather than crashing the daemon.
                log.warning("control_vsock_port set but vsock is unusable: %s", exc)
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

        if cfg.proxy.sni_enable:
            sni, _ = start_sni(parts, cfg)

        # Discovery state file so dfget finds or spawns this daemon
        # (root.go:234-260).  write_state uses state_path() — the SAME
        # resolution dfget reads, so writer and reader can never disagree.
        state_file = write_state(control.url)

        # Probe loop against the remote scheduler, until SIGINT or SIGTERM.
        ping = make_host_pinger()
        # The handlers go in before the ready line: a supervisor may
        # signal as soon as it reads it.
        stop = threading.Event()
        previous = {
            s: signal.signal(s, lambda signum, frame: stop.set())
            for s in (signal.SIGINT, signal.SIGTERM)
        }
        print(
            f"dfdaemon: serving pieces on :{parts['piece_server'].port}, "
            f"control {control.url} (state {state_file}), "
            f"scheduler {args.scheduler} (ctrl-c to stop)",
            flush=True,
        )
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
        report_launches("dfdaemon")
        return 0
    finally:
        if sni is not None:
            sni.stop()
        if pex is not None:
            pex.stop()
        if parts is not None:
            parts["announcer"].stop()
            parts["piece_server"].stop()
            if parts["renewer"] is not None:
                parts["renewer"].stop()
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
