"""trainer service binary (reference: cmd/trainer + trainer/trainer.go).

Port of ``dragonfly2_tpu/cli/trainer.py``.  ``--train-once DIR`` ingests
DIR's columnar shards (``download*.dfc``, ``networktopology*.dfc``), runs
one training round synchronously on ``--device`` (``cuda`` unless asked
for ``cpu``), registers the models and prints what the reference prints.

Without it the binary serves (``serve``): an HTTP ingest server
(``TrainerHTTPServer``) over ``TrainerService(data_dir=cfg.data_dir)``
on ``--device``, registering models through ``RemoteRegistry`` with
``--manager URL`` (or ``manager_addr``) and in an in-process
``ModelRegistry`` otherwise, until SIGINT or SIGTERM; then it stops the
server and exits 0.  With ``lifecycle.enable`` and a REST manager, every
ingested download row also streams into a ``LifecycleDaemon`` (its
``StreamingTrainer`` on ``--device``) that registers candidates as
``--scheduler-id``'s models and begins their rollout through
``RolloutRESTClient``.  A ``grpc://`` manager and ``server.grpc_port >=
0`` exit 2 naming ROADMAP queue 1 item 12c (the gRPC half).

    python -m dragonfly2_tpu_torch.cli.trainer [--train-once DIR] [--manager URL] \
        [--scheduler-id ID] [--device cpu]
"""

from __future__ import annotations

import glob
import os
import sys
from dataclasses import dataclass
from typing import Optional

from ..config import ConfigError, TrainerConfigFile, load_config
from ..manager.registry import ModelRegistry
from ..trainer.service import TrainerService
from ..trainer.train import TrainConfig
from .common import base_parser, init_debug, init_logging, wait_for_signal


def train_config(cfg: TrainerConfigFile) -> TrainConfig:
    """The round's ``TrainConfig`` from the config file's training section."""
    return TrainConfig(
        epochs=cfg.training.epochs,
        learning_rate=cfg.training.learning_rate,
        warmup_steps=cfg.training.warmup_steps,
    )


def model_registry(manager_addr: Optional[str], token: Optional[str], registry=None):
    """Where models register: ``RemoteRegistry`` for a REST manager,
    else ``registry`` (a fresh ``ModelRegistry`` by default)."""
    if manager_addr and manager_addr.startswith("grpc://"):
        raise ConfigError(
            "a grpc:// manager needs the gRPC registry client, "
            "which is not ported yet (ROADMAP queue 1 item 12c)"
        )
    if manager_addr:
        from ..rpc import RemoteRegistry

        return RemoteRegistry(manager_addr, token=token)
    return registry if registry is not None else ModelRegistry()


@dataclass
class TrainerServing:
    """What ``serve`` started."""

    service: TrainerService
    http_server: object
    lifecycle_daemon: object = None

    @property
    def url(self) -> str:
        return self.http_server.url

    def stop(self) -> None:
        if self.lifecycle_daemon is not None:
            self.lifecycle_daemon.stop()
        self.http_server.stop()


def serve(
    cfg: Optional[TrainerConfigFile] = None,
    *,
    device="cuda",
    manager: Optional[str] = None,
    manager_token: Optional[str] = None,
    registry=None,
    gnn_model: str = "hop",
    scheduler_id: str = "scheduler-local",
) -> TrainerServing:
    """The binary's serve mode (reference cli/trainer.py:98-176) as a
    composition: ``TrainerHTTPServer`` on ``server.host:server.port`` (0
    binds an ephemeral port) over ``TrainerService(data_dir=cfg.data_dir)``
    training on ``device``.  Models register through ``RemoteRegistry``
    when ``manager`` or ``cfg.manager_addr`` names one, else in
    ``registry`` (a fresh ``ModelRegistry`` by default).  With
    ``lifecycle.enable`` and a REST manager, a ``LifecycleDaemon`` for
    ``scheduler_id`` (the binary's ``--scheduler-id``) is the service's
    online sink and serves on its own thread.  ``gnn_model`` is the
    service's graph branch (``"hop"`` as in the reference binary, or
    ``"gat"``, whose gather's backward is K3).  Raises ``ConfigError``
    for what is not ported."""
    cfg = cfg or TrainerConfigFile()
    cfg.validate()
    manager_addr = manager or cfg.manager_addr
    registry = model_registry(manager_addr, manager_token, registry)
    if cfg.server.grpc_port >= 0:
        raise ConfigError(
            "server.grpc_port >= 0 asks for the gRPC Train stream, "
            "which is not ported yet (ROADMAP queue 1 item 12c)"
        )
    from ..rpc import TrainerHTTPServer

    service = TrainerService(
        registry,
        data_dir=cfg.data_dir,
        train_config=train_config(cfg),
        gnn_model=gnn_model,
        device=device,
    )
    http_server = TrainerHTTPServer(service, host=cfg.server.host, port=cfg.server.port)
    http_server.serve()
    serving = TrainerServing(service=service, http_server=http_server)
    # Self-driving lifecycle plane (DESIGN.md §29): with a REST manager
    # attached, every ingested record also streams into the continuous
    # train→export→rollout loop — candidates register and walk
    # SHADOW→CANARY→ACTIVE with zero human steps (schedulers' rollout
    # reporters supply the evaluation evidence).
    if cfg.lifecycle.enable and manager_addr:
        from ..lifecycle import LifecycleConfig, LifecycleDaemon
        from ..rollout.client import RolloutRESTClient

        lc = cfg.lifecycle
        # No StateBackend here (that is the manager's): lifecycle
        # watermarks/lineage live in the daemon's in-memory store, so the
        # epoch cadence holds for the life of this process; the
        # manager-side rollout rows stay durable either way.
        serving.lifecycle_daemon = LifecycleDaemon(
            registry,
            RolloutRESTClient(manager_addr, token=manager_token),
            config=LifecycleConfig(
                scheduler_id=scheduler_id,
                model_name=lc.model_name,
                regions=tuple(lc.regions),
                epoch_records=lc.epoch_records,
                max_steps_per_epoch=lc.max_steps_per_epoch,
                min_joined=lc.min_joined,
                arbitration_margin=lc.arbitration_margin,
                canary_percent=lc.canary_percent,
                interval_s=lc.interval_s,
                trainer_batch_size=lc.trainer_batch_size,
            ),
            device=device,
        )
        service.online_sink = serving.lifecycle_daemon
        serving.lifecycle_daemon.serve()
        print(
            f"trainer: lifecycle daemon on (epoch every {lc.epoch_records} "
            f"records, regions={list(lc.regions) or ['global only']})",
            flush=True,
        )
    elif cfg.lifecycle.enable:
        print(
            "trainer: lifecycle.enable set but no REST manager attached; "
            "lifecycle daemon not started",
            flush=True,
        )
    print(
        f"trainer: ingest on {http_server.url}, staging in {cfg.data_dir} "
        "(ctrl-c to stop)",
        flush=True,
    )
    return serving


def run(argv=None, *, registry=None) -> int:
    """The binary's body; → exit code.  ``registry`` replaces the
    in-process ``ModelRegistry`` the round registers into (callers that
    read the registered models back pass their own)."""
    p = base_parser("trainer", "Model training service")
    p.add_argument("--train-once", default=None, metavar="DIR",
                   help="ingest DIR's columnar shards, train one round, exit")
    p.add_argument("--scheduler-id", default="scheduler-local")
    p.add_argument("--manager", default=None, metavar="URL",
                   help="remote manager REST URL (models publish there)")
    p.add_argument("--manager-token", default=None, help="bearer token for the manager")
    p.add_argument("--device", default="cuda",
                   help="torch device the trainer trains on (cuda or cpu)")
    args = p.parse_args(argv)
    init_logging(args, "trainer")
    debug = init_debug(args)
    try:
        try:
            cfg = load_config(TrainerConfigFile, args.config)
            if args.train_once:
                registry = model_registry(
                    args.manager or cfg.manager_addr, args.manager_token, registry
                )
            else:
                serving = serve(
                    cfg, device=args.device, manager=args.manager,
                    manager_token=args.manager_token, registry=registry,
                    scheduler_id=args.scheduler_id,
                )
        except ConfigError as exc:
            print(f"trainer: {exc}", file=sys.stderr)
            return 2
        if not args.train_once:
            wait_for_signal()
            serving.stop()
            return 0
        service = TrainerService(
            registry,
            # --train-once reads local shards (no staging).
            data_dir=None,
            train_config=train_config(cfg),
            device=args.device,
        )
        session = service.open_train_stream(
            ip="127.0.0.1", hostname=os.uname().nodename, scheduler_id=args.scheduler_id
        )
        dl = sorted(glob.glob(os.path.join(args.train_once, "download*.dfc")))
        topo = sorted(glob.glob(os.path.join(args.train_once, "networktopology*.dfc")))
        if not dl:
            print(f"trainer: no download*.dfc shards in {args.train_once}", file=sys.stderr)
            return 1
        for path in dl:
            session.send_download_shard(path)
        for path in topo:
            session.send_network_topology_shard(path)
        key = session.close_and_train()
        run_rec = service.runs[key]
        if run_rec.error:
            print(f"trainer: run failed: {run_rec.error}", file=sys.stderr)
            return 1
        for name, metrics in run_rec.metrics.items():
            print(
                f"trainer: {name}: mae={metrics.mae:.4f} mse={metrics.mse:.4f} "
                f"f1={metrics.f1:.3f} ({run_rec.download_rows} rows)"
            )
        for mid in run_rec.models:
            m = registry.get(mid)
            print(f"trainer: registered {m.name} v{m.version} ({m.type})")
        return 0
    finally:
        if debug is not None:
            debug.stop()


if __name__ == "__main__":
    sys.exit(run())
