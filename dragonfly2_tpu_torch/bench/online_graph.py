"""configs[4] as the north star writes it: the online graph trainer on the
card, fed by a drifting world, with snapshot refreshes and kill/resume.

Port of ``tools/soak_online_1b.py``, with the in-process half of
``tools/soak_online_wire.py`` behind ``--wire``.  BOTH record streams
flow continuously:

- **downloads**: position-seeded edge batches whose ground-truth
  bandwidth reflects the cluster's CURRENT (drifting) load state;
- **topology**: per-epoch probe sweeps of the drifted cluster;

and every ``--refresh-every`` dispatches the driver rebuilds the graph
snapshot from the topology window (``OnlineGraphTrainer.refresh_snapshot``:
``build_neighbor_table`` + ``precompute_hop_features`` on the card, the
optimizer untouched).  Load drift happens at epoch boundaries
(``SyntheticCluster.drift``, seeded by epoch → a resumed run replays the
identical world).  At every boundary the driver measures validation MAE
on POST-drift edges twice: with the STALE snapshot and with the FRESH one.

``--wire``: both streams go as DFC1 chunks through
``TrainerService.receive_shard_bytes`` → ``_feed_online`` →
``WireIngestAdapter`` → the trainer, from a producer thread that
generates ``SyntheticCluster.generate_feature_rows`` blocks and per-epoch
probe shards in hash-bucket space; snapshot 0 is built from the first
wire-fed sweep, and validation edges map through the adapter's ids.  The
producer waits for the driver's refresh of epoch e before it sends epoch
e + 1's sweep, so each refresh sees exactly its own epoch's topology.
The adapter runs the native ``oi_*`` engine at the default
``native_ingest``, the trainer taking its dispatch blocks from the
engine's edge ring; ``--python-ingest`` runs the Python adapter instead.
The summary's ``ingest`` says which ran and holds the engine's counters.
The path stays in process: the chunks enter ``TrainerService`` directly,
not through its HTTP server (``rpc/trainer_transport.py``, which the
trainer binary's serve mode runs; ``bench/wire_loop.py`` drives it).

Kill/resume (direct feed): ``--kill-after-dispatch`` checkpoints and
stops (the command exits 137); ``--resume`` restores params, moments,
generator and stream position AND rebuilds the snapshot from the
checkpointed window; ``--hash-out`` writes ``state_hash`` to prove the
continuation byte-identical to an uninterrupted run.

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints one JSON line.  ``run(parse_args([...]))`` drives the same run
in-process and returns that summary (``chip_smoke.py`` does).

    python -m dragonfly2_tpu_torch.bench.online_graph --records 1e9 --ckpt-dir DIR \\
        [--kill-after-dispatch 70] [--resume] [--hash-out H] [--wire] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

BATCH = 131_072
SUPER = 64


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", type=float, default=1e9)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--refresh-every", type=int, default=30, help="dispatches per epoch")
    ap.add_argument("--ckpt-every", type=int, default=30, help="dispatches")
    ap.add_argument("--eval-every", type=int, default=15, help="dispatches")
    ap.add_argument("--kill-after-dispatch", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--hash-out", default=None)
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--super", dest="super_steps", type=int, default=SUPER)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0,
                    help="the world's seed (0 replays tools/soak_online_1b.py's world)")
    ap.add_argument("--wire", action="store_true",
                    help="feed both streams as DFC1 chunks through TrainerService")
    ap.add_argument("--block-rows", type=int, default=1_000_000,
                    help="download rows per wire chunk (--wire)")
    ap.add_argument("--python-ingest", action="store_true",
                    help="the wire adapter's Python path, not the native engine (--wire)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class _World:
    """The drifting synthetic cluster and its position-seeded streams.
    Every stream's seed is ``base + position``, offset by a million per
    unit of ``seed``."""

    def __init__(self, nodes: int, batch: int, super_steps: int, seed: int = 0) -> None:
        from ..records.synthetic import SyntheticCluster

        self.nodes, self.batch, self.super_steps = nodes, batch, super_steps
        self.seed = seed
        self.n_probe = nodes * 16  # one probe sweep per epoch ≈ table capacity
        self.cluster = SyntheticCluster(num_hosts=nodes, seed=seed)

    def key(self, base: int, position: int) -> int:
        return base + position + 1_000_000 * self.seed

    def drift_to(self, epoch: int) -> None:
        """Replay epochs 1..epoch of load drift (seeded per epoch — a
        resumed process reconstructs the identical world state)."""
        for e in range(1, epoch + 1):
            self.drift(e)

    def drift(self, epoch: int) -> None:
        self.cluster.drift(np.random.default_rng(self.key(77_000, epoch)))

    def probe_sweep(self, epoch: int):
        """Topology records for this epoch's world (prober → probed)."""
        rng = np.random.default_rng(self.key(88_000, epoch))
        src = rng.integers(0, self.nodes, self.n_probe)
        dst = rng.integers(0, self.nodes, self.n_probe)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        rtt = self.cluster._rtt_vec(src, dst, rng=rng) / 1e9
        return src, dst, rtt.astype(np.float32)

    def download_block(self, d: int):
        """Download records for dispatch d, against dispatch d's world."""
        n = self.super_steps * self.batch
        rng = np.random.default_rng(self.key(10_000, d))
        es = rng.integers(0, self.nodes, n).astype(np.int32)
        ed = (es + rng.integers(1, self.nodes, n).astype(np.int32)) % self.nodes
        y = np.log1p(self.cluster._bandwidth_vec(es, ed, rng=rng)).astype(np.float32)
        return es, ed, y

    def val_set(self, epoch: int):
        rng = np.random.default_rng(self.key(999_000, epoch))
        es = rng.integers(0, self.nodes, 2 * self.batch).astype(np.int32)
        ed = (es + rng.integers(1, self.nodes, 2 * self.batch).astype(np.int32)) % self.nodes
        y = np.log1p(self.cluster._bandwidth_vec(es, ed, rng=rng)).astype(np.float32)
        return es, ed, y


def _stop_producer(stop: threading.Event, thread: threading.Thread, trainer) -> None:
    """Stop a producer that may be blocked on the trainer's full queue or
    the native ingest engine's full edge ring: take dispatch blocks until
    it sees ``stop`` and returns."""
    stop.set()
    while thread.is_alive():
        trainer._next_dispatch_block(timeout=0.05)
    thread.join()


class _DispatchClock:
    """The time of every ``_train_dispatch`` of a trainer: CUDA events
    around it on the card (the device's time per dispatch, launch gaps
    inside it included), the host clock on the CPU."""

    def __init__(self, trainer, torch) -> None:
        self.pairs = []
        self.host_ms = []
        inner = trainer._train_dispatch
        cuda = trainer.device.type == "cuda"

        def timed(*args):
            t0 = time.perf_counter()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                start = time.perf_counter()
            out = inner(*args)
            if cuda:
                end.record()
            else:
                end = time.perf_counter()
            self.pairs.append((start, end))
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        trainer._train_dispatch = timed

    def ms(self):
        return [s.elapsed_time(e) if hasattr(s, "elapsed_time") else (e - s) * 1e3
                for s, e in self.pairs]


def _trainer(args, dev, *, node_feats, topo, **cfg_kw):
    from ..models.hop import HopConfig
    from ..trainer.online_graph import OnlineGraphConfig, OnlineGraphTrainer
    from ..trainer.train import TrainConfig

    rows_per_dispatch = args.batch * args.super_steps
    n_dispatch = int(np.ceil(args.records / rows_per_dispatch))
    cfg = OnlineGraphConfig(
        num_nodes=args.nodes,
        max_neighbors=16,
        batch_size=args.batch,
        super_steps=args.super_steps,
        refresh_every=0,   # the driver refreshes (stale/fresh eval around them)
        topo_window=args.nodes * 16,
        model=HopConfig(hidden=args.hidden),
        train=TrainConfig(warmup_steps=args.warmup_steps),
        total_steps_hint=n_dispatch * args.super_steps,
        **cfg_kw,
    )
    return OnlineGraphTrainer(
        cfg, node_feats=node_feats, topo_src=topo[0], topo_dst=topo[1], topo_rtt=topo[2],
        checkpoint_dir=args.ckpt_dir, device=dev,
    ), n_dispatch


def _column_rms(hop_feats):
    return hop_feats.float().pow(2).mean(dim=0).sqrt()


def _refresh(trainer, val, epoch, d, before=None):
    """Stale eval, refresh, fresh eval → the refresh's record, with the
    hop features' scale before and after: their RMS, and the largest
    factor by which one column's RMS moved."""
    t0 = time.perf_counter()
    stale = trainer.eval_mae(*val)
    old = _column_rms(trainer.hop_feats)
    if before is not None:
        before()
    digest = trainer.refresh_snapshot()
    fresh = trainer.eval_mae(*val)
    table_s, precompute_s = trainer.snapshot_seconds
    new = _column_rms(trainer.hop_feats)
    both = (old > 0) & (new > 0)
    moved = float(((new[both] / old[both]).log().abs().max()).exp()) if bool(both.any()) else 1.0
    return {
        "dispatch": d, "epoch": epoch, "stale_mae": stale, "fresh_mae": fresh,
        "refresh_s": time.perf_counter() - t0, "table_s": table_s,
        "precompute_s": precompute_s, "val_edges": int(len(val[0])),
        "hop_digest": digest[:12] if digest else None,
        "hop_rms": [float(old.pow(2).mean().sqrt()), float(new.pow(2).mean().sqrt())],
        "hop_column_rms_moved_max": moved,
    }


def run(args: argparse.Namespace, *, log=print, keep=None) -> dict:
    """One run as the command line describes it; → the summary.  With
    ``keep`` (a list), the trainer is appended to it at the end."""
    import torch

    from ..ops._build import resolve_device

    dev = resolve_device(args.device)
    fn = _run_wire if args.wire else _run_direct
    out, trainer = fn(args, dev, torch, log)
    if keep is not None:
        keep.append(trainer)
    return out


def _summary(trainer, torch, clock, losses, t0, d0, d, extra):
    from ..trainer.online_graph import state_hash

    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rows_per_dispatch = trainer.config.batch_size * trainer.config.super_steps
    return {
        "dispatches": d - d0,
        "records_this_run": (d - d0) * rows_per_dispatch,
        "records_seen": trainer.records_seen,
        "snapshots": trainer.snapshot_idx,
        "train_s": train_s,
        "records_per_s": (d - d0) * rows_per_dispatch / train_s if train_s else 0.0,
        "dispatch_ms": clock.ms(),
        "dispatch_host_ms": clock.host_ms,
        "losses": [float(x) for x in torch.stack(losses).cpu()] if losses else [],
        "state_hash": state_hash(trainer.state),
        **extra,
    }


def _run_direct(args, dev, torch, log) -> dict:
    """The soak: direct feed, the driver's refreshes, kill/resume."""
    from ..trainer.online_graph import state_hash

    t_wall0 = time.perf_counter()
    R = args.refresh_every
    world = _World(args.nodes, args.batch, args.super_steps, args.seed)
    t0 = time.perf_counter()
    trainer, n_dispatch_total = _trainer(
        args, dev, node_feats=world.cluster._host_feature_matrix(), topo=world.probe_sweep(0),
    )
    log(f"online-graph: trainer built in {time.perf_counter() - t0:.1f}s "
        f"({args.nodes} nodes, {len(trainer._window[0])} probes)")

    start_dispatch = 0
    resumed_at = None
    if args.resume:
        if not trainer.resume():
            raise FileNotFoundError(f"no checkpoint to resume in {args.ckpt_dir}")
        start_dispatch = trainer.dispatch
        resumed_at = {"dispatch": trainer.dispatch, "snapshot": trainer.snapshot_idx,
                      "step": trainer.state.step}
        # Rebuild the WORLD to match the restored stream position.
        world.drift_to(start_dispatch // R)
        log(f"online-graph: resumed at dispatch {start_dispatch} "
            f"(step {trainer.state.step}, snapshot {trainer.snapshot_idx})")

    # The producer runs AHEAD of the train loop (queue backpressure ≠
    # lockstep), so it generates against its OWN world replica, drifted at
    # its own generation position.
    producer_world = _World(args.nodes, args.batch, args.super_steps, args.seed)
    stop = threading.Event()

    def producer() -> None:
        producer_world.drift_to(start_dispatch // R)
        for d in range(start_dispatch, n_dispatch_total):
            if stop.is_set():
                return
            if d and d % R == 0 and d != start_dispatch:
                # Dispatch d is the first of epoch d//R: drift first.  On
                # resume the replay above already drifted to it.
                producer_world.drift(d // R)
            trainer.feed_downloads(*producer_world.download_block(d))
        trainer.end_of_stream()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    trainer._ensure_snapshot()
    clock = _DispatchClock(trainer, torch)
    curve, refreshes, losses = [], [], []
    t_train0 = time.perf_counter()
    d = start_dispatch
    killed = None
    while d < n_dispatch_total:
        if trainer.run(max_dispatches=1, idle_timeout=30.0) == 0:
            break
        d += 1
        losses.append(trainer.last_loss)
        epoch = d // R
        if d % args.eval_every == 0 or d == n_dispatch_total:
            # The boundary drift for epoch d//R runs BELOW — the world at
            # eval time is still dispatch d's epoch.
            mae = trainer.eval_mae(*world.val_set((d - 1) // R))
            curve.append({"dispatch": d, "records": d * args.super_steps * args.batch,
                          "snapshot": trainer.snapshot_idx, "val_mae": mae})
            log(f"online-graph: dispatch {d}/{n_dispatch_total} snapshot="
                f"{trainer.snapshot_idx} val_mae={mae:.4f}")
        if d % R == 0 and d < n_dispatch_total:
            # Epoch boundary: the world drifts; measure the model on the
            # NEW world with the STALE snapshot, refresh, measure FRESH.
            world.drift(epoch)

            def new_epoch_streams():
                trainer.set_node_features(world.cluster._host_feature_matrix())
                trainer.feed_topology(*world.probe_sweep(epoch))

            refreshes.append(_refresh(trainer, world.val_set(epoch), epoch, d,
                                      before=new_epoch_streams))
            log(f"online-graph: refresh at dispatch {d}: stale="
                f"{refreshes[-1]['stale_mae']:.4f} fresh={refreshes[-1]['fresh_mae']:.4f}")
        saved = False
        if d % args.ckpt_every == 0 or d == n_dispatch_total:
            trainer.checkpoint()
            saved = True
        if args.kill_after_dispatch is not None and d >= args.kill_after_dispatch:
            if not saved:
                trainer.checkpoint()
            if args.hash_out:
                with open(args.hash_out + ".at_kill", "w") as f:
                    f.write(state_hash(trainer.state) + "\n")
            log(f"online-graph: KILLING after dispatch {d} "
                f"(checkpoint written, snapshot {trainer.snapshot_idx})")
            killed = d
            break
    _stop_producer(stop, thread, trainer)
    out = _summary(trainer, torch, clock, losses, t_train0, start_dispatch, d, {
        "mode": "direct", "dispatch": trainer.dispatch, "refreshes": refreshes,
        "val_curve": curve, "resumed_at": resumed_at, "killed_at": killed,
        "wall_s": time.perf_counter() - t_wall0,
    })
    if args.hash_out and killed is None:
        with open(args.hash_out, "w") as f:
            f.write(out["state_hash"] + "\n")
    return out, trainer


def _run_wire(args, dev, torch, log) -> dict:
    """Both streams as DFC1 chunks through the trainer service."""
    from ..records.columnar import ColumnarHeader, _encode_header
    from ..records.features import DOWNLOAD_COLUMNS, HOST_FEATURE_DIM, TOPO_COLUMNS
    from ..trainer.service import TrainerService

    t_wall0 = time.perf_counter()
    R = args.refresh_every
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32))
    trainer, n_dispatch = _trainer(
        args, dev, node_feats=np.zeros((args.nodes, HOST_FEATURE_DIM), np.float32),
        topo=empty, queue_capacity=4, native_ingest=not args.python_ingest,
    )
    rows_per_dispatch = args.batch * args.super_steps
    total_rows = n_dispatch * rows_per_dispatch
    n_epochs = (n_dispatch + R - 1) // R + 1
    adapter = trainer.make_wire_adapter()
    # The service stages every chunk it receives (~2.5 GB for 16.8 M
    # rows) beside the checkpoint.
    os.makedirs(args.ckpt_dir, exist_ok=True)
    stage = tempfile.mkdtemp(prefix="wire-stage-", dir=args.ckpt_dir)
    service = TrainerService(data_dir=stage, online_sink=adapter, device=dev)
    session = service.open_train_stream(ip="10.9.9.9", hostname="online-graph",
                                        scheduler_id="bench")
    topo_posted = [threading.Event() for _ in range(n_epochs)]
    first_rows = threading.Event()
    refreshed = [threading.Event() for _ in range(n_epochs)]
    stop = threading.Event()
    sent = {"download_rows": 0, "topology_rows": 0, "bytes": 0}
    failure = []

    def producer() -> None:
        pworld = _World(args.nodes, args.batch, args.super_steps, args.seed)
        cluster = pworld.cluster
        buckets = cluster._bucket_table()
        header = _encode_header(ColumnarHeader(columns=DOWNLOAD_COLUMNS))
        seqs: dict = {}

        def post(kind, name, payload):
            seq = seqs.get(name, 0)
            service.receive_shard_bytes(session, kind, name, payload, seq=seq)
            seqs[name] = seq + 1
            sent["bytes"] += len(payload)

        def probe_shard(epoch):
            rng = np.random.default_rng(pworld.key(88_000, epoch))
            n = args.nodes * 16
            src = rng.integers(0, args.nodes, n)
            dst = rng.integers(0, args.nodes, n)
            keep = src != dst
            src, dst = src[keep], dst[keep]
            rows = np.zeros((len(src), len(TOPO_COLUMNS)), np.float32)
            rows[:, 0] = buckets[src]
            rows[:, 1] = buckets[dst]
            rows[:, 2] = (cluster._rtt_vec(src, dst, rng=rng) / 1e9).astype(np.float32)
            sent["topology_rows"] += len(rows)
            return _encode_header(ColumnarHeader(columns=TOPO_COLUMNS)) + rows.tobytes()

        try:
            rows_per_epoch = R * rows_per_dispatch
            g = 0
            for epoch in range((total_rows + rows_per_epoch - 1) // rows_per_epoch):
                if epoch > 0:
                    # Epoch e's sweep goes out only after the driver
                    # refreshed on epoch e - 1's.
                    while not refreshed[epoch - 1].wait(0.1):
                        if stop.is_set():
                            return
                    pworld.drift(epoch)
                post("networktopology", f"topo-{epoch}", probe_shard(epoch))
                topo_posted[epoch].set()
                end = min((epoch + 1) * rows_per_epoch, total_rows)
                for offset in range(epoch * rows_per_epoch, end, args.block_rows):
                    if stop.is_set():
                        return
                    n = min(args.block_rows, end - offset)
                    rows = cluster.generate_feature_rows(n, seed=pworld.key(10_000, g))
                    g += 1
                    name = f"dl-{epoch}"
                    post("download", name, (header if seqs.get(name, 0) == 0 else b"")
                         + rows.tobytes())
                    sent["download_rows"] += n
                    first_rows.set()
            trainer.end_of_stream()
        except Exception as exc:  # the driver raises it
            failure.append(exc)
            trainer.end_of_stream()

    world = _World(args.nodes, args.batch, args.super_steps, args.seed)

    def val_set(epoch):
        """Epoch's validation edges, mapped through the adapter's ids."""
        rows = world.cluster.generate_feature_rows(2 * args.batch,
                                                   seed=world.key(999_000, epoch))
        ids = adapter.map_known(np.concatenate([rows[:, 0], rows[:, 1]]))
        src, dst = ids[: len(rows)], ids[len(rows):]
        ok = (src >= 0) & (dst >= 0)
        return src[ok], dst[ok], rows[ok, -1]

    def wait_topology(epoch):
        while not topo_posted[epoch].wait(0.1):
            if failure:
                raise failure[0]
            if not thread.is_alive():
                raise RuntimeError(f"the producer ended without epoch {epoch}'s topology")

    t_start = time.perf_counter()
    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        # Snapshot 0 comes OFF THE WIRE: the first probe sweep and the
        # first download rows (whose host features the node means come
        # from), then the first real graph, before training.
        wait_topology(0)
        while not first_rows.wait(0.1):
            if failure or not thread.is_alive():
                raise failure[0] if failure else RuntimeError("the producer sent no rows")
        if trainer.refresh_snapshot() is None:
            raise RuntimeError("no wire topology arrived")
        bootstrap = {"table_s": trainer.snapshot_seconds[0],
                     "precompute_s": trainer.snapshot_seconds[1],
                     "seconds": time.perf_counter() - t_start,
                     "probe_edges": int(len(trainer._window[0]))}
        refreshed[0].set()
        log(f"online-graph: snapshot from wire topology "
            f"({bootstrap['probe_edges']} probe edges)")
        clock = _DispatchClock(trainer, torch)
        refreshes, losses = [], []
        t_train0 = time.perf_counter()
        d = 0
        while d < n_dispatch:
            if trainer.run(max_dispatches=1, idle_timeout=60.0) == 0:
                break
            d += 1
            losses.append(trainer.last_loss)
            if d % R == 0 and d < n_dispatch:
                epoch = d // R
                world.drift(epoch)
                refreshes.append(_refresh(trainer, val_set(epoch), epoch, d,
                                          before=lambda e=epoch: wait_topology(e)))
                refreshed[epoch].set()
                log(f"online-graph: refresh at dispatch {d}: stale="
                    f"{refreshes[-1]['stale_mae']:.4f} fresh="
                    f"{refreshes[-1]['fresh_mae']:.4f}")
        out = _summary(trainer, torch, clock, losses, t_train0, 0, d, {})
    finally:
        _stop_producer(stop, thread, trainer)
        shutil.rmtree(stage, ignore_errors=True)
    if failure:
        raise failure[0]
    end_s = time.perf_counter() - t_start
    out.update({
        "mode": "wire", "dispatch": trainer.dispatch, "refreshes": refreshes,
        "bootstrap": bootstrap, "rows_sent": sent["download_rows"],
        "topology_rows_sent": sent["topology_rows"], "bytes_sent": sent["bytes"],
        "rows_off_the_wire": sum(v for (_, kind, _), v in service._online_fed.items()
                                 if kind == "download"),
        "leftover_rows": 0 if trainer._leftover is None else int(len(trainer._leftover[0])),
        "overflow_edges": adapter.overflow_edges, "evicted_nodes": adapter.evicted_nodes,
        "nodes_recycled": trainer.nodes_recycled,
        "mapped_nodes": int(adapter.native_stats()["next_id"] if adapter.is_native
                            else adapter._next_id),
        "ingest": {"native": adapter.is_native, "stats": adapter.native_stats()},
        "service_s": end_s, "records_per_s_service": trainer.records_seen / end_s,
        "wall_s": time.perf_counter() - t_wall0,
    })
    return out, trainer


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import torch

        from ..ops._build import resolve_device

        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"online-graph: {exc}", file=sys.stderr)
        return 2
    out = run(args, log=lambda m: print(m, flush=True))
    if torch.device(args.device).type == "cuda":
        from .k1_stamps import smi

        out["card"] = smi("name,power.limit")
    print(json.dumps(out), flush=True)
    if out.get("killed_at") is not None:
        os._exit(137)
    return 0


if __name__ == "__main__":
    sys.exit(main())
