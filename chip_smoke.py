#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dragonfly2_tpu_torch``) on one GPU.

Drives the scheduler's ML parent-ranking path through the port's own
entry points and holds every kernel of that path against its plain
PyTorch version.  Imports nothing of JAX or of the JAX package.

Phases:

1. Device and build: the card's name and power limit, the kernels built
   from ``dragonfly2_tpu_torch/csrc`` with nvcc for sm_90a (timed).
2. Serving path: ``cli.scheduler.build`` with algorithm ``ml``, a
   65,536-slot host store, the 1.5 ms batcher and a fused scorer made
   from a seeded 32→64→64→1 scorer blob.  16,384 synthetic hosts
   announce; 64 tasks are warmed with 256 downloads each (register, task
   length, every piece from the first scheduled parent or the source,
   finished); then 32 threads send 16 ``register_peer`` requests each,
   every one into a task where its host has no peer yet, and one client
   sends 64 more (the uncontended per-layer breakdown).  The rule arm
   (K2) then scores the rule components of the same candidate sets.
   Launch counts are zeroed just before this phase and read just after.
3. The path against the reference: K1 launches equal the batcher's
   scorer calls, no batcher fallback, no announce degraded to the rule
   ranking, >= 90% of the requests scored >= 2 candidates.  Then, with
   the cluster state frozen, every recorded candidate set is ranked again
   through the evaluator and scored by K1 directly, and held to the
   numpy ``MLPScorer`` on ``_featurize_batch`` rows: scores within 1e-4,
   orders equal wherever adjacent reference scores differ by > 1e-4.
4. Kernels against their plain versions on the same inputs: K1 at the
   path's padded sizes (128, 256, 512 rows) and at 4,096 rows over the
   full 65,536-row mirror, K2 at [512, 6].
5. Times from CUDA events at 512 rows (median of 25).  The announce
   rate and register_peer p50/p99 are those of the 512 concurrent
   requests (a closed loop of 32 clients); evaluate_parents and the
   scorer flush are timed per call around the same requests.

Prints JSON lines, the ``kernels`` line second to last and the contract
line ``{"ok": true, "device": {...}}`` last.  Any failed check exits
non-zero before that line.  Exits 2 without a result when no CUDA device
is available.

    python3 chip_smoke.py [--seed 0] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N_HOSTS = 16384
N_TASKS = 64
HOSTS_PER_TASK = 256
PIECES = 16
THREADS = 32
PER_THREAD = 16
SEQUENTIAL = 64
STORE_SLOTS = 65536
SCORE_TOL = 1e-4          # path vs numpy MLPScorer (scores and ties)
K1_TOL = 1e-5             # K1 vs plain, scaled by max(1, max |score|)
K2_TOL = 1e-6             # K2 vs plain
TIMING_SAMPLES = 25
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def weights_from_seed(seed: int, dims=(32, 64, 64, 1)):
    """Seeded serving-MLP weights (scale 0.3 / 0.05)."""
    rng = np.random.default_rng(seed)
    return [
        (
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05,
        )
        for i in range(len(dims) - 1)
    ]


def orders_agree(order, ref_scores, tol: float) -> bool:
    """``order`` (indices, best first) equals the stable descending order
    of ``ref_scores`` up to permutations inside runs of reference scores
    whose adjacent gaps are <= tol."""
    ref_order = np.argsort(-ref_scores, kind="stable")
    sorted_scores = ref_scores[ref_order]
    start = 0
    for i in range(1, len(ref_order) + 1):
        if i == len(ref_order) or sorted_scores[i - 1] - sorted_scores[i] > tol:
            if set(ref_order[start:i].tolist()) != set(order[start:i]):
                return False
            start = i
    return True


# ---------------------------------------------------------------------------
# The serving path
# ---------------------------------------------------------------------------


def warm_tasks(service, cluster, hosts, *, n_tasks, hosts_per_task):
    """Warm ``n_tasks`` tasks with ``hosts_per_task`` downloads each: the
    download sequence of the reference swarm simulator (register → task
    length → every piece from the first scheduled parent or the source →
    finished), without storage.  Returns the tasks' URLs."""
    from dragonfly2_tpu_torch.records.synthetic import PIECE_SIZE
    from dragonfly2_tpu_torch.scheduler import ScheduleResultKind

    index = {h.id: i for i, h in enumerate(hosts)}
    urls = [f"https://origin.example.com/blob/{t}" for t in range(n_tasks)]
    for t in range(n_tasks):
        for k in range(hosts_per_task):
            hi = t * hosts_per_task + k
            res = service.register_peer(
                host=hosts[hi], url=urls[t], peer_id=f"warm-{t}-{k}"
            )
            peer = res.peer
            service.set_task_info(peer, PIECES * PIECE_SIZE, PIECES, PIECE_SIZE)
            sched = res.schedule
            parent = (
                sched.parents[0]
                if sched is not None and sched.kind is ScheduleResultKind.PARENTS
                else None
            )
            for n in range(PIECES):
                if parent is None:
                    bw = float(cluster.down_cap[hi]) * 0.5
                    pid = ""
                else:
                    bw = max(cluster.bandwidth(index[parent.host.id], hi, noise=False), 1e3)
                    pid = parent.id
                service.report_piece_finished(
                    peer, n, parent_id=pid, length=PIECE_SIZE,
                    cost_ns=int(PIECE_SIZE / bw * 1e9),
                )
            service.report_peer_finished(peer)
    return urls


def serve_requests(service, hosts, urls, *, hosts_per_task, threads, per_thread,
                   first=0):
    """``threads × per_thread`` concurrent registrations, requests
    ``first`` on; request q registers a host of the NEXT task's group
    into task q % n_tasks, so the host has no peer there yet.  Returns
    the records of every ranked candidate set and the phase's timings:
    register_peer per request, evaluate_parents per ranked set, and the
    scorer call per flush (host time, the kernel launch included)."""
    ev = service.scheduling.evaluator
    scorer = ev._scorer
    n_tasks = len(urls)
    records = {}
    evaluate_s = []
    flush_s = []
    rec_mu = threading.Lock()
    evaluate = ev.evaluate_parents
    score = scorer.score

    def recording(parents, child, total):
        t0 = time.perf_counter()
        ranked = evaluate(parents, child, total)
        dt = time.perf_counter() - t0
        with rec_mu:
            records[child.id] = (list(parents), child, total, ranked)
            evaluate_s.append(dt)
        return ranked

    def timed_score(*args, **kwargs):
        t0 = time.perf_counter()
        out = score(*args, **kwargs)
        dt = time.perf_counter() - t0
        with rec_mu:
            flush_s.append(dt)
        return out

    n_req = threads * per_thread
    plan = [
        (q % n_tasks, ((q % n_tasks + 1) % n_tasks) * hosts_per_task + q // n_tasks)
        for q in range(first, first + n_req)
    ]
    lat = [0.0] * n_req
    kinds = [None] * n_req
    errors = []
    barrier = threading.Barrier(threads + 1)

    def worker(t: int) -> None:
        try:
            barrier.wait()
            for i in range(t * per_thread, (t + 1) * per_thread):
                task_i, hi = plan[i]
                t0 = time.perf_counter()
                res = service.register_peer(
                    host=hosts[hi], url=urls[task_i], peer_id=f"req-{first + i}"
                )
                lat[i] = time.perf_counter() - t0
                kinds[i] = res.schedule.kind.name if res.schedule else "NONE"
        except Exception as exc:  # re-raised on the main thread after join
            errors.append(exc)

    ev.evaluate_parents = recording
    scorer.score = timed_score
    try:
        pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
        for th in pool:
            th.start()
        barrier.wait()
        t0 = time.perf_counter()
        for th in pool:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        del ev.evaluate_parents
        del scorer.score
    if errors:
        raise errors[0]
    counts = {}
    for k in kinds:
        counts[k] = counts.get(k, 0) + 1
    timing = {"wall": wall, "register": lat, "evaluate": evaluate_s, "flush": flush_s}
    return list(records.values()), timing, counts


def summarize(timing, n_req):
    """Per-layer medians (ms) and the end-to-end numbers of a phase."""
    ms = {k: sorted(x * 1e3 for x in timing[k]) for k in ("register", "evaluate", "flush")}
    return {
        "requests": n_req,
        "announce_rate_per_s": n_req / timing["wall"],
        "register_p50_ms": float(np.percentile(ms["register"], 50)),
        "register_p99_ms": float(np.percentile(ms["register"], 99)),
        "evaluate_p50_ms": float(np.percentile(ms["evaluate"], 50)) if ms["evaluate"] else None,
        "flush_p50_ms": float(np.percentile(ms["flush"], 50)) if ms["flush"] else None,
        "flushes": len(ms["flush"]),
    }


def rule_arm(ev, records, device):
    """K2 over the rule components of each recorded candidate set,
    against the float64 weighted sum of the same components."""
    from dragonfly2_tpu_torch.ops.fused_score import RULE_COMPONENT_WEIGHTS, rule_weighted_sum

    w = np.asarray(RULE_COMPONENT_WEIGHTS, np.float64)
    comps_all = []
    err = 0.0
    for parents, child, total, _ in records:
        comps = np.stack(ev._component_arrays(parents, child, total), axis=1)
        got = rule_weighted_sum(comps, device=device)
        want = comps @ w
        err = max(err, float(np.max(np.abs(got - want))))
        comps_all.append(comps.astype(np.float32))
    return np.concatenate(comps_all), err


def verify_rankings(ev, scorer, ref, records):
    """Frozen-state re-rank of every recorded candidate set: the path's
    ranking and K1's scores against the numpy scorer."""
    worst = 0.0
    inputs = []
    for parents, child, total, ranked in records:
        check(sorted(p.id for p in ranked) == sorted(p.id for p in parents),
              "a ranking is not a permutation of its candidates")
        feats, _, _ = ev._featurize_batch(parents, child)
        want = ref.score(feats)
        edge, src, cslot, _, _ = ev._featurize_slots(parents, child)
        dst = np.full(len(parents), cslot, dtype=np.int64)
        got = scorer.score(edge, src_buckets=src, dst_buckets=dst)
        worst = max(worst, float(np.max(np.abs(got - want))))
        pos = {p.id: i for i, p in enumerate(parents)}
        order = [pos[p.id] for p in ev.evaluate_parents(parents, child, total)]
        check(orders_agree(order, want, SCORE_TOL),
              f"path ranking differs from the numpy MLPScorer for {child.id}")
        inputs.append((edge, src, dst))
    check(worst <= SCORE_TOL, f"K1 scores differ from MLPScorer by {worst}")
    return worst, inputs


# ---------------------------------------------------------------------------
# Kernels: comparison and timing
# ---------------------------------------------------------------------------


def device_ms(torch, fn, samples=TIMING_SAMPLES, reps=10):
    """Median device time of one ``fn()`` over ``samples`` runs of
    ``reps`` back-to-back calls.  A spin kernel queued first keeps the
    card busy while the host issues the calls, so the events bracket
    device time, not the host's issue rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # ~1.5 GHz: spin at least twice the host issue time.
    cycles = int(max(host_s * 2.0, 1e-4) * 1.5e9)
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def k1_cost(n, d1, d2):
    """(bytes, FLOPs) K1 needs for n rows: slot ids, edge rows, the two
    gathered host rows and the score per row, plus the weights once;
    the dense stack's multiply-adds plus ~9 operations per gelu."""
    row_bytes = 2 * 4 + 8 * 4 + 2 * 12 * 4 + 4
    weight_bytes = 4 * (32 * d1 + d1 + d1 * d2 + d2 + d2 + 1)
    flops = n * (2 * 32 * d1 + d1 + 2 * d1 * d2 + d2 + 2 * d2 + 1 + 9 * (d1 + d2))
    return n * row_bytes + weight_bytes, flops


def k2_cost(n):
    return n * (6 * 4 + 4), n * 11


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for the nvcc report and a JSON summary")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
    from dragonfly2_tpu_torch.ops import _build
    from dragonfly2_tpu_torch.ops.fused_score import (
        LAUNCHES,
        RULE_COMPONENT_WEIGHTS,
        _fused_score_plain,
        _rule_sum_plain,
        fused_gather_mlp_score,
        reset_launch_counts,
        rule_sum,
    )
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
    from dragonfly2_tpu_torch.sim.swarm import host_from_latent
    from dragonfly2_tpu_torch.trainer.export import MLPScorer, load_scorer, scorer_to_bytes

    # "f32" means f32 on the card: no TF32 in the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    print(_build.build_log, file=sys.stderr, flush=True)
    emit({"phase": "build", "card": card, "seconds": build_s,
          "nvcc_seconds": _build.build_seconds})

    # -- 2. serving path ----------------------------------------------------
    cfg = SchedulerConfig()
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.eval_feature_cache_hosts = STORE_SLOTS
    cfg.scheduling.eval_batch_linger_ms = 1.5
    # As the reference simulator runs: a cold task's first registration
    # goes back to source without sleeping out the retry loop.
    cfg.scheduling.retry_interval_s = 0.0
    blob = scorer_to_bytes(MLPScorer(weights=weights_from_seed(args.seed)))
    service = build(cfg, device=dev, scorer_blob=blob, rng=random.Random(args.seed))
    ev = service.scheduling.evaluator
    batcher = ev.batcher
    scorer = ev._scorer
    cluster = SyntheticCluster(num_hosts=N_HOSTS, seed=args.seed)
    hosts = [host_from_latent(lh) for lh in cluster.hosts]

    reset_launch_counts()
    t_path = time.perf_counter()
    for h in hosts:
        service.announce_host(h)
    urls = warm_tasks(service, cluster, hosts, n_tasks=N_TASKS,
                      hosts_per_task=HOSTS_PER_TASK)
    warm_s = time.perf_counter() - t_path
    calls0, batches0, reqs0 = batcher.scorer_calls, batcher.batches, batcher.batched_requests
    k1_0 = LAUNCHES["fused_gather_mlp_score"]
    n_req = THREADS * PER_THREAD
    records, timing, kinds = serve_requests(
        service, hosts, urls, hosts_per_task=HOSTS_PER_TASK, threads=THREADS,
        per_thread=PER_THREAD,
    )
    concurrent = summarize(timing, n_req)
    concurrent.update({
        "threads": THREADS, "schedule_kinds": kinds,
        "requests_per_flush": (batcher.batched_requests - reqs0)
        / max(batcher.batches - batches0, 1),
        "k1_launches": LAUNCHES["fused_gather_mlp_score"] - k1_0,
    })
    # One client, the same kind of request: the uncontended breakdown.
    k1_1 = LAUNCHES["fused_gather_mlp_score"]
    seq_records, seq_timing, seq_kinds = serve_requests(
        service, hosts, urls, hosts_per_task=HOSTS_PER_TASK, threads=1,
        per_thread=SEQUENTIAL, first=n_req,
    )
    sequential = summarize(seq_timing, SEQUENTIAL)
    sequential.update({
        "threads": 1, "schedule_kinds": seq_kinds,
        "k1_launches": LAUNCHES["fused_gather_mlp_score"] - k1_1,
    })
    scored = [r for r in records if len(r[0]) >= 2]
    records = scored + [r for r in seq_records if len(r[0]) >= 2]
    comps, k2_path_err = rule_arm(ev, records, dev)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    path_s = time.perf_counter() - t_path
    emit({
        "phase": "serving", "seconds": path_s, "warm_seconds": warm_s,
        "concurrent": concurrent, "sequential": sequential,
        "scored_ge2": len(scored),
        "batcher": {"scorer_calls": batcher.scorer_calls, "batches": batcher.batches,
                    "mean_occupancy": batcher.mean_occupancy(),
                    "fallbacks": batcher.fallbacks},
        "rule_degrades": ev.degrades, "launches": launches,
        "k2_path_max_abs_err": k2_path_err,
    })

    # -- 3. the path against the reference ----------------------------------
    check(launches["fused_gather_mlp_score"] > 0, "K1 never launched on the path")
    check(launches["fused_gather_mlp_score"] == batcher.scorer_calls,
          f"K1 launches {launches['fused_gather_mlp_score']} != batcher scorer "
          f"calls {batcher.scorer_calls}")
    check(launches["rule_weighted_sum"] == len(records), "K2 launches != rule-arm calls")
    check(batcher.fallbacks == 0, f"{batcher.fallbacks} batcher fallbacks")
    check(ev.degrades == 0, f"{ev.degrades} announces degraded to the rule ranking")
    check(len(scored) >= 0.9 * n_req,
          f"only {len(scored)} of {n_req} requests scored >= 2 candidates")
    check(k2_path_err <= K2_TOL, f"K2 on the path off by {k2_path_err}")
    ref = load_scorer(blob)
    score_err, inputs = verify_rankings(ev, scorer, ref, records)
    emit({"phase": "reference", "requests_checked": len(records),
          "max_abs_score_err": score_err, "tol": SCORE_TOL})

    # -- 4. kernels against their plain versions ----------------------------
    mat = scorer._sync_mirror()
    mlp = scorer.mlp
    edge_all = np.concatenate([e for e, _, _ in inputs])
    src_all = np.concatenate([s for _, s, _ in inputs]).astype(np.int32)
    dst_all = np.concatenate([d for _, _, d in inputs]).astype(np.int32)

    def k1_inputs(n):
        idx = np.arange(n) % edge_all.shape[0]
        return (
            torch.from_numpy(np.ascontiguousarray(src_all[idx])).to(dev),
            torch.from_numpy(np.ascontiguousarray(dst_all[idx])).to(dev),
            torch.from_numpy(np.ascontiguousarray(edge_all[idx])).to(dev),
        )

    def k1_plain(s, d, e):
        return _fused_score_plain(mat, s, d, e, mlp.w0c, mlp.w0p, mlp.w0e, mlp.b0,
                                  mlp.layers())

    k1_err = {}
    for n in (128, 256, 512, 4096):
        s, d, e = k1_inputs(n)
        got = fused_gather_mlp_score(mat, s, d, e, mlp)
        torch.cuda.synchronize()
        want = k1_plain(s, d, e)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        k1_err[n] = err
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at n={n}")
        check(err <= K1_TOL * scale, f"K1 off its plain version by {err} at n={n}")
    c512 = torch.from_numpy(np.ascontiguousarray(comps[np.arange(512) % len(comps)])).to(dev)
    got = rule_sum(c512)
    torch.cuda.synchronize()
    want = _rule_sum_plain(c512, RULE_COMPONENT_WEIGHTS)
    k2_err = float((got - want).abs().max())
    check(k2_err <= K2_TOL, f"K2 off its plain version by {k2_err}")
    emit({"phase": "kernels", "k1_max_abs_err": k1_err, "k1_tol_scaled": K1_TOL,
          "k2_max_abs_err": k2_err, "k2_tol": K2_TOL})

    # -- 5. times -----------------------------------------------------------
    s, d, e = k1_inputs(512)
    d1, d2 = mlp.w0c.shape[1], mlp.w1.shape[1]
    w_t = torch.tensor(RULE_COMPONENT_WEIGHTS, dtype=torch.float32, device=dev)
    # Timing launches are not path launches: counted apart.
    k1_ms = device_ms(torch, lambda: fused_gather_mlp_score(mat, s, d, e, mlp))
    k1_plain_ms = device_ms(torch, lambda: k1_plain(s, d, e))
    k2_ms = device_ms(torch, lambda: rule_sum(c512))
    k2_plain_ms = device_ms(torch, lambda: _rule_sum_plain(c512, RULE_COMPONENT_WEIGHTS))
    k2_lib_ms = device_ms(torch, lambda: torch.mv(c512, w_t))
    # The card's busy share of the concurrent phase, from K1's device time.
    busy_s = concurrent["k1_launches"] * k1_ms / 1e3
    emit({"phase": "times", "concurrent_wall_s": timing["wall"],
          "k1_device_s": busy_s, "device_busy_share": busy_s / timing["wall"]})
    k1_bound, k1_by = bound(*k1_cost(512, d1, d2))
    k2_bound, k2_by = bound(*k2_cost(512))
    kernels = {"kernels": [
        {"name": "fused_gather_mlp_score", "route": "cuda",
         "source": "dragonfly2_tpu_torch/csrc/fused_score.cu",
         "replaces": "dragonfly2_tpu/ops/pallas_score.py:114",
         "launches": launches["fused_gather_mlp_score"],
         "max_abs_err": max(k1_err.values()), "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "rule_weighted_sum", "route": "cuda",
         "source": "dragonfly2_tpu_torch/csrc/fused_score.cu",
         "replaces": "dragonfly2_tpu/ops/pallas_score.py:364",
         "launches": launches["rule_weighted_sum"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib_ms},
    ]}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_nvcc.txt"), "w") as f:
            f.write(_build.build_log)
        with open(os.path.join(args.out, "chip_smoke_kernels.json"), "w") as f:
            json.dump({"card": card, **kernels}, f, indent=1)
    print(card, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
