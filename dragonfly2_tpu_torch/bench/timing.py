"""Device timing and bounds shared by ``chip_smoke.py`` and the bench
scripts: a kernel's device time from CUDA events, and the least time the
card could take for the same work (the larger of bytes over the HBM rate
and operations over the f32 rate)."""

from __future__ import annotations

import statistics
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def device_ms(fn, samples=25, reps=10) -> float:
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


def bound(nbytes, flops):
    """(least ms, "bytes" or "operations") for the given work."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_cost(n, d1, d2, blob_floats):
    """(bytes, FLOPs) K1 needs for n rows: slot ids, edge rows, the two
    gathered host rows and the score per row, plus the packed weight
    blob once; the dense stack's multiply-adds plus ~9 operations per
    gelu."""
    row_bytes = 2 * 4 + 8 * 4 + 2 * 12 * 4 + 4
    flops = n * (2 * 32 * d1 + d1 + 2 * d1 * d2 + d2 + 2 * d2 + 1 + 9 * (d1 + d2))
    return n * row_bytes + 4 * blob_floats, flops


def k2_cost(n):
    return n * (6 * 4 + 4), n * 11


def k3_cost(plan, d, itemsize):
    """(bytes, FLOPs) K3 needs: every real edge's value row, row id and
    segment id; the chunk table; the output rows; one add per value."""
    ch = plan.chunks
    e = int(ch["edge_seg"].numel())
    table_bytes = 4 * sum(int(ch[k].numel()) for k in ch if k != "edge_pos")
    nbytes = e * d * itemsize + table_bytes + plan.num_segments * d * 4
    return nbytes, e * d
