"""scheduler service binary (reference: cmd/scheduler + scheduler/scheduler.go).

``build`` wires the scheduler composition: resource managers, the
columnar host store, the evaluator for the configured algorithm (``nt``
over the probe store when ``network_topology.enable`` is set, ``ml`` with
cross-request scorer micro-batching), the scheduling engine, record
storage and the network-topology probe store.  With a scorer blob it
installs the fused gather+score scorer on ``device``, the way a model
subscription would.

``run(argv)`` is the binary.  ``--simulate N`` runs an N-download
synthetic swarm into the configured record storage and prints the
reference's line of record counts.  Serve mode (the transports, the GC
runner and the periodic probe-graph save) waits for the port's rpc slice
(ROADMAP queue 1 item 12): without ``--simulate`` the binary exits 2 and
says so.  The seed-peer trigger waits for ROADMAP queue 1 item 10.

    DRAGONFLY_SCHEDULER_STORAGE_DIR=DIR \\
        python -m dragonfly2_tpu_torch.cli.scheduler --simulate N [--device cpu]
"""

from __future__ import annotations

import os
import random
import sys
from typing import Optional

from ..config import ConfigError, SchedulerConfigFile, load_config  # noqa: F401
from ..ops._build import resolve_device
from ..ops.fused_score import FusedMLPScorer
from ..records.storage import Storage
from ..scheduler import (
    HostFeatureCache,
    NetworkTopology,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
    ScorerBatcher,
    TopologyConfig,
    new_evaluator,
)
from ..trainer.export import load_scorer
from .common import base_parser, init_debug, init_logging

# The name the serving slice gave the scheduler's config.
SchedulerConfig = SchedulerConfigFile

SERVE_MODE_MISSING = (
    "scheduler: serve mode (HTTP/gRPC transports, the GC runner, the periodic "
    "probe-graph save) waits for the port's rpc slice (ROADMAP queue 1 item 12); "
    "run a synthetic swarm with --simulate N"
)


def build(
    cfg: Optional[SchedulerConfigFile] = None,
    *,
    device="cuda",
    scorer_blob: Optional[bytes] = None,
    rng: Optional[random.Random] = None,
) -> SchedulerService:
    """Composition root (scheduler.go:69-301 New).

    ``device`` is where a fused scorer serves (``"cuda"`` unless the
    caller asks for the CPU; no CUDA device raises).  ``scorer_blob`` is
    an exported scorer artifact (``trainer.export.scorer_to_bytes``) for
    the ``ml`` algorithm.  ``rng`` drives candidate sampling and the probe
    store's choice of probe targets (one generator for both, as the
    reference's process-global ``random``).  The service carries
    ``.storage`` and ``.networktopology`` (None when
    ``network_topology.enable`` is off)."""
    cfg = cfg or SchedulerConfigFile()
    cfg.validate()
    device = resolve_device(device)
    rng = rng if rng is not None else random.Random()
    sc = cfg.scheduling
    resource = Resource(
        host_ttl=cfg.gc.host_ttl_s,
        task_ttl=cfg.gc.task_ttl_s,
        peer_ttl=cfg.gc.peer_ttl_s,
    )
    topology = None
    if cfg.network_topology.enable:
        topology = NetworkTopology(
            resource.host_manager,
            TopologyConfig(
                probe_queue_length=cfg.network_topology.probe_queue_length,
                probe_count=cfg.network_topology.probe_count,
                collect_interval=cfg.network_topology.collect_interval_s,
            ),
            rng=rng,
        )
    # Every algorithm gets the columnar host store (DESIGN.md §18); only
    # ml additionally gets cross-request scorer micro-batching.
    feature_cache = HostFeatureCache(max_hosts=sc.eval_feature_cache_hosts)
    batcher = None
    if sc.algorithm == "ml":
        batcher = ScorerBatcher(linger_s=sc.eval_batch_linger_ms / 1e3)
    evaluator = new_evaluator(
        sc.algorithm, networktopology=topology, feature_cache=feature_cache,
        batcher=batcher,
    )
    if scorer_blob is not None:
        if sc.algorithm != "ml":
            raise ConfigError("a scorer blob needs scheduling.algorithm 'ml'")
        evaluator.set_scorer(
            FusedMLPScorer.from_scorer(
                feature_cache, load_scorer(scorer_blob), device=device
            )
        )
    scheduling = Scheduling(
        evaluator,
        SchedulingConfig(
            candidate_parent_limit=sc.candidate_parent_limit,
            filter_parent_limit=sc.filter_parent_limit,
            retry_limit=sc.retry_limit,
            retry_back_to_source_limit=sc.retry_back_to_source_limit,
            retry_interval=sc.retry_interval_s,
        ),
        rng=rng,
    )
    storage = Storage(
        cfg.storage.dir,
        buffer_size=cfg.storage.buffer_size,
        max_size=cfg.storage.max_size,
        max_backups=cfg.storage.max_backups,
    )
    return SchedulerService(resource, scheduling, storage, topology)


def run(argv=None) -> int:
    """The binary's body; → exit code."""
    p = base_parser("scheduler", "Parent-peer scheduling service")
    p.add_argument("--simulate", type=int, default=0, metavar="N",
                   help="run an N-download synthetic swarm and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device a fused scorer serves on (cuda or cpu)")
    args = p.parse_args(argv)
    init_logging(args, "scheduler")
    debug = init_debug(args)
    try:
        cfg = load_config(SchedulerConfigFile, args.config)
        if not args.simulate:
            print(SERVE_MODE_MISSING, file=sys.stderr)
            return 2
        rng = random.Random()
        service = build(cfg, device=args.device, rng=rng)
        storage = service.storage
        # Durable probe graph (the Redis-persistence analog): reload the
        # saved state at boot so the nt evaluator keeps its RTT scores
        # across restarts.
        if service.networktopology is not None:
            loaded = service.networktopology.load(
                os.path.join(cfg.storage.dir, "topology_state.json")
            )
            if loaded:
                print(f"scheduler: reloaded {loaded} probe edges", flush=True)

        from ..sim import SwarmConfig, SwarmSimulator

        sim = SwarmSimulator(storage, config=SwarmConfig(num_hosts=32, seed=0), rng=rng)
        done = sim.run_downloads(args.simulate)
        sim.run_probe_rounds(1)
        n_topo = sim.snapshot_topology()
        storage.flush()
        print(
            f"scheduler: simulated {done} downloads -> "
            f"{storage.download_count} download records, "
            f"{storage.network_topology_count} topology records ({n_topo} snapshots)"
        )
        return 0
    finally:
        if debug is not None:
            debug.stop()


if __name__ == "__main__":
    sys.exit(run())
