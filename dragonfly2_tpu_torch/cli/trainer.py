"""trainer service binary (reference: cmd/trainer + trainer/trainer.go).

Port of ``dragonfly2_tpu/cli/trainer.py``'s ``--train-once`` mode: ingest
DIR's columnar shards (``download*.dfc``, ``networktopology*.dfc``), run
one training round synchronously on ``--device`` (``cuda`` unless asked
for ``cpu``), register the models and print what the reference prints.

Serve mode (HTTP and gRPC ingest, a remote manager, the lifecycle daemon
behind ``RolloutRESTClient``) waits for the port's rpc slice: without
``--train-once`` the binary exits 2 and says so.

    python -m dragonfly2_tpu_torch.cli.trainer --train-once DIR [--device cpu]
"""

from __future__ import annotations

import glob
import os
import sys

from ..config import TrainerConfigFile, load_config
from ..manager.registry import ModelRegistry
from ..trainer.service import TrainerService
from ..trainer.train import TrainConfig
from .common import base_parser, init_debug, init_logging

SERVE_MODE_MISSING = (
    "trainer: serve mode (HTTP/gRPC ingest, remote manager, lifecycle daemon) "
    "waits for the port's rpc slice (ROADMAP queue 1 item 12); "
    "run one round with --train-once DIR"
)


def train_config(cfg: TrainerConfigFile) -> TrainConfig:
    """The round's ``TrainConfig`` from the config file's training section."""
    return TrainConfig(
        epochs=cfg.training.epochs,
        learning_rate=cfg.training.learning_rate,
        warmup_steps=cfg.training.warmup_steps,
    )


def run(argv=None, *, registry=None) -> int:
    """The binary's body; → exit code.  ``registry`` replaces the
    in-process ``ModelRegistry`` the round registers into (callers that
    read the registered models back pass their own)."""
    p = base_parser("trainer", "Model training service")
    p.add_argument("--train-once", default=None, metavar="DIR",
                   help="ingest DIR's columnar shards, train one round, exit")
    p.add_argument("--scheduler-id", default="scheduler-local")
    p.add_argument("--device", default="cuda",
                   help="torch device the round trains on (cuda or cpu)")
    args = p.parse_args(argv)
    init_logging(args, "trainer")
    debug = init_debug(args)
    try:
        cfg = load_config(TrainerConfigFile, args.config)
        if not args.train_once:
            print(SERVE_MODE_MISSING, file=sys.stderr)
            return 2
        registry = registry if registry is not None else ModelRegistry()
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
