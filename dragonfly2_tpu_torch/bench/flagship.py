"""The flagship hop ranker's train step on one card: records/s and MFU.

The port's counterpart of the repo's ``bench.py``: the same workload at
the north star's shape — a 100,000-host synthetic cluster, its probe
graph at 16 probes a host, ``build_neighbor_table`` with K = 16, one
batch of 131,072 download edges with log1p ground-truth bandwidth — and
the same model, ``HopConfig(hidden=1024)`` (2 hops, embed 32, dropout
0.1, bf16 compute), trained with ``TrainConfig()`` on that batch.

The hop features are precomputed once on the card (timed).  The step is
timed with CUDA events over a window of steps after a warm-up, with no
host sync inside the window (the window's host time is printed too).
MFU is the step's dense operations, counted from the shapes
(``hop_train_flops``), over the window's time per step and the card's
bf16 dense peak (989 TFLOP/s, H100 SXM data sheet).  Prints one JSON
line with the card's name and power limit.

    python -m dragonfly2_tpu_torch.bench.flagship [--warmup 5] [--steps 20] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.gnn import build_neighbor_table
from ..models.hop import HopConfig, HopRanker, hop_feature_dim, precompute_hop_features
from ..records.synthetic import SyntheticCluster
from ..trainer.train import TrainConfig, TrainState, _graph_train_step, _make_optimizer
from .k1_stamps import smi

NODES = 100_000
NEIGHBORS = 16
BATCH = 131_072
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12


def hop_train_flops(cfg: HopConfig, in_dim: int, batch: int, query_edge_dim: int = 0) -> int:
    """Dense operations of one train step of ``HopRanker`` on ``batch``
    edges: each Dense layer's 2·in·out multiply-adds per row, forward, and
    twice that backward (the input's and the weight's gradients); the
    encoder runs on two rows an edge (both endpoints), the head on one.
    Elementwise work (gelu, dropout, the optimizer) is not counted."""
    f = hop_feature_dim(in_dim, cfg.hops) + cfg.node_embed_dim
    h, o = cfg.hidden, cfg.out_dim
    encoder = f * h + h * h + h * o
    head = (3 * o + query_edge_dim) * h + h * (h // 2) + (h // 2)
    return 3 * 2 * batch * (2 * encoder + head)


def mfu(flops: int, step_ms: float) -> float:
    """Share of the card's bf16 dense peak that ``flops`` a step of
    ``step_ms`` reach."""
    return flops / (step_ms / 1e3) / PEAK_BF16_FLOPS


def step_window(step, steps: int):
    """``steps`` calls of ``step()`` between two CUDA events, with no host
    sync inside the window; → (device ms a step, host ms a step, the last
    call's result).  The caller warms up first."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        out = step()
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    return start.elapsed_time(end) / steps, host_ms, out


def workload(seed: int, n_nodes: int = NODES, batch: int = BATCH):
    """bench.py's graph and batch, made from ``seed`` (CPU tensors)."""
    cluster = SyntheticCluster(num_hosts=n_nodes, seed=seed)
    src, dst, rtt = cluster.probe_edges(density=NEIGHBORS / max(n_nodes - 1, 1), seed=seed)
    table = build_neighbor_table(n_nodes, src, dst, rtt / 1e9, max_neighbors=NEIGHBORS)
    rng = np.random.default_rng(seed)
    e_src = rng.integers(0, n_nodes, batch)
    e_dst = (e_src + rng.integers(1, n_nodes, batch)) % n_nodes
    target = np.log1p(cluster._bandwidth_vec(e_src, e_dst)).astype(np.float32)
    return cluster._host_feature_matrix(), table, e_src, e_dst, target


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flagship: no CUDA device")
    dev = torch.device("cuda")
    mcfg = HopConfig(hidden=1024)
    node_feats, table, e_src, e_dst, target = workload(args.seed)
    table = table.to(dev)
    nf = torch.from_numpy(node_feats).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hop = precompute_hop_features(nf, table, hops=mcfg.hops)
    torch.cuda.synchronize()
    precompute_ms = (time.perf_counter() - t0) * 1e3

    model = HopRanker(mcfg, num_nodes=hop.shape[0], in_dim=hop.shape[1],
                      generator=torch.Generator().manual_seed(args.seed)).to(dev)
    cfg = TrainConfig()
    state = TrainState(
        model=model,
        opt=_make_optimizer(list(model.parameters()), cfg, 100),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
    )
    a = torch.from_numpy(e_src).to(dev)
    b = torch.from_numpy(e_dst).to(dev)
    y = torch.from_numpy(target).to(dev)

    def step():
        return _graph_train_step(state, hop, table, a, b, y, None)[1]

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, loss = step_window(step, args.steps)
    flops = hop_train_flops(mcfg, node_feats.shape[1], BATCH)
    print(json.dumps({
        "ok": bool(torch.isfinite(loss).item()),
        "metric": "hop_ranker_train_records_per_sec_per_chip",
        "value": BATCH / (step_ms / 1e3),
        "unit": "records/s/chip",
        "step_ms": step_ms,
        "step_ms_host": host_ms,
        "mfu": mfu(flops, step_ms),
        "flops_per_step": flops,
        "peak_bf16_flops": PEAK_BF16_FLOPS,
        "precompute_ms": precompute_ms,
        "steps": args.steps, "warmup": args.warmup, "batch": BATCH, "nodes": NODES,
        "hidden": mcfg.hidden, "hop_dim": int(hop.shape[1]),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "loss": float(loss),
        "card": smi("name,power.limit"),
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
