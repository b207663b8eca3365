"""Replay evaluation: join shadow decisions with realized outcomes and
score both arms' rankings.

Port of ``dragonfly2_tpu/rollout/evaluation.py``, numpy verbatim, with
the columnar shard loader (``load_replay_rows``) the reporter and the
lifecycle daemon's ``file_replay_source`` read through.

The shadow replay log (rollout/shadow.py) records, per sampled announce,
every candidate edge with both arms' scores and rank positions.  The
scheduler's record store (records/storage.py) later captures what
actually happened: each completed Download row carries the realized
bandwidth per parent edge (the training target).  Joining the two on
(src_bucket, dst_bucket) turns counterfactual rankings into measurable
quality:

- **regret@k** — per announce, the mean realized bandwidth of the k
  edges an arm ranked best, relative to the best achievable k (ideal
  ranking over the same outcome-bearing edges).  ``1 - achieved/ideal``,
  0 = perfect, higher = worse.
- **pairwise inversion rate** — fraction of outcome-bearing edge pairs
  within an announce that an arm ordered against the realized-bandwidth
  order (ties in outcome excluded).  The rank-correlation view of the
  same question, robust to bandwidth scale.

Everything is numpy over the whole log: group reductions ride one
lexsort + bincount sweeps, never a Python loop per edge.  Per-feature
drift (PSI) is accumulated online by ShadowScorer against the
training-snapshot bins in the candidate blob; ``evaluate_shadow`` folds
its ``psi_max`` into the report the rollout controller judges.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..records.features import NUM_HASH_BUCKETS
from .shadow import SHADOW_COLUMNS

_COL = {name: i for i, name in enumerate(SHADOW_COLUMNS)}


def load_replay_rows(paths: Sequence[str]) -> np.ndarray:
    """Concatenate shadow replay shards (ColumnarReader over each)."""
    import os

    from ..records.columnar import ColumnarReader

    arrays = [
        ColumnarReader(p).to_array()
        for p in paths
        if os.path.exists(p) and os.path.getsize(p) > 0
    ]
    arrays = [a for a in arrays if a.shape[0] > 0]
    if not arrays:
        return np.zeros((0, len(SHADOW_COLUMNS)), dtype=np.float32)
    return np.concatenate(arrays, axis=0)


def _pair_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    return src.astype(np.int64) * NUM_HASH_BUCKETS + dst.astype(np.int64)


def join_outcomes(
    shadow_rows: np.ndarray, download_rows: np.ndarray
) -> np.ndarray:
    """Realized log-bandwidth per shadow row, NaN where no Download
    record covers that (parent, child) edge.  Multiple realized
    transfers of one edge average (the scheduler may re-announce the
    same pair across the evaluation window)."""
    out = np.full(shadow_rows.shape[0], np.nan)
    if not shadow_rows.shape[0] or not download_rows.shape[0]:
        return out
    # Download columnar layout (records/features.DOWNLOAD_COLUMNS):
    # col 0 src_bucket, col 1 dst_bucket, last col target_log_bw.
    dl_keys = _pair_keys(download_rows[:, 0], download_rows[:, 1])
    targets = download_rows[:, -1].astype(np.float64)
    uniq, inverse = np.unique(dl_keys, return_inverse=True)
    sums = np.bincount(inverse, weights=targets, minlength=len(uniq))
    counts = np.bincount(inverse, minlength=len(uniq))
    means = sums / np.maximum(counts, 1)
    sh_keys = _pair_keys(
        shadow_rows[:, _COL["src_bucket"]], shadow_rows[:, _COL["dst_bucket"]]
    )
    idx = np.searchsorted(uniq, sh_keys)
    idx_c = np.clip(idx, 0, len(uniq) - 1)
    hit = uniq[idx_c] == sh_keys
    out[hit] = means[idx_c[hit]]
    return out


def _group_index(shadow_rows: np.ndarray) -> np.ndarray:
    """Dense announce-group ids over the log: one group per
    (candidate_version, announce_seq) — seq counters restart per
    candidate, so the version disambiguates concatenated logs."""
    keys = (
        shadow_rows[:, _COL["candidate_version"]].astype(np.int64) << 32
    ) + shadow_rows[:, _COL["announce_seq"]].astype(np.int64)
    _, groups = np.unique(keys, return_inverse=True)
    return groups


def _topk_mean_per_group(
    groups: np.ndarray, order_key: np.ndarray, values: np.ndarray, k: int,
    n_groups: int,
) -> np.ndarray:
    """Mean of ``values`` over each group's k smallest ``order_key``
    rows — one lexsort + bincount, no per-group loop."""
    order = np.lexsort((order_key, groups))
    g_sorted = groups[order]
    # Position within group = global position - group start.
    starts = np.zeros(n_groups, dtype=np.int64)
    counts = np.bincount(g_sorted, minlength=n_groups)
    starts[1:] = np.cumsum(counts)[:-1]
    pos = np.arange(len(g_sorted)) - starts[g_sorted]
    top = pos < k
    sums = np.bincount(
        g_sorted[top], weights=values[order][top], minlength=n_groups
    )
    taken = np.bincount(g_sorted[top], minlength=n_groups)
    return sums / np.maximum(taken, 1)


def regret_at_k(
    shadow_rows: np.ndarray, realized: np.ndarray, *, k: int = 4
) -> Dict[str, float]:
    """Mean regret@k for both arms over announces with ≥2 outcome-bearing
    edges.  Realized values compare in linear bytes/sec (expm1 of the
    logged target)."""
    valid = ~np.isnan(realized)
    rows = shadow_rows[valid]
    bw = np.expm1(realized[valid])
    if not rows.shape[0]:
        return {"announces": 0, "candidate": 0.0, "active": 0.0}
    groups = _group_index(rows)
    n_groups = int(groups.max()) + 1
    sizes = np.bincount(groups, minlength=n_groups)
    scorable = sizes >= 2
    ideal = _topk_mean_per_group(groups, -bw, bw, k, n_groups)
    out: Dict[str, float] = {"announces": int(scorable.sum())}
    for arm in ("candidate", "active"):
        achieved = _topk_mean_per_group(
            groups, rows[:, _COL[f"{arm}_rank"]], bw, k, n_groups
        )
        with np.errstate(invalid="ignore", divide="ignore"):
            regret = 1.0 - achieved / np.maximum(ideal, 1e-9)
        regret = regret[scorable & (ideal > 0)]
        out[arm] = float(regret.mean()) if regret.size else 0.0
    return out


def pairwise_inversion_rate(
    shadow_rows: np.ndarray, realized: np.ndarray
) -> Dict[str, float]:
    """Fraction of outcome-bearing edge pairs (within an announce) each
    arm ranked against the realized-bandwidth order."""
    valid = ~np.isnan(realized)
    rows = shadow_rows[valid]
    bw = realized[valid]
    out = {"pairs": 0, "candidate": 0.0, "active": 0.0}
    if not rows.shape[0]:
        return out
    groups = _group_index(rows)
    inv = {"candidate": 0, "active": 0}
    pairs = 0
    order = np.argsort(groups, kind="stable")
    bounds = np.flatnonzero(np.diff(groups[order])) + 1
    for seg in np.split(order, bounds):  # per-ANNOUNCE; inner math is n×n numpy
        if len(seg) < 2:
            continue
        d_bw = bw[seg][:, None] - bw[seg][None, :]
        upper = np.triu(np.ones((len(seg), len(seg)), dtype=bool), k=1)
        decided = upper & (d_bw != 0.0)
        pairs += int(decided.sum())
        for arm in ("candidate", "active"):
            r = rows[seg, _COL[f"{arm}_rank"]]
            d_rank = r[:, None] - r[None, :]
            # Better outcome (d_bw > 0) should mean better (smaller) rank
            # (d_rank < 0); same-sign products are inversions.
            inv[arm] += int((decided & ((d_bw * d_rank) > 0)).sum())
    out["pairs"] = pairs
    if pairs:
        out["candidate"] = inv["candidate"] / pairs
        out["active"] = inv["active"] / pairs
    return out


def population_stability_index(
    expected_fracs: np.ndarray, observed_counts: np.ndarray
) -> np.ndarray:
    """PSI per feature row: sum((o-e)·ln(o/e)) with epsilon clamps (the
    same formula ShadowScorer.psi applies to its online accumulators)."""
    counts = np.asarray(observed_counts, np.float64)
    totals = counts.sum(axis=-1, keepdims=True)
    eps = 1e-4
    observed = np.maximum(counts / np.maximum(totals, 1.0), eps)
    expected = np.maximum(np.asarray(expected_fracs, np.float64), eps)
    return ((observed - expected) * np.log(observed / expected)).sum(axis=-1)


def evaluate_shadow(
    shadow_rows: np.ndarray,
    download_rows: np.ndarray,
    *,
    k: int = 4,
    psi_max: Optional[float] = None,
) -> Dict:
    """The report payload the scheduler posts to the rollout controller
    (rollout/client.py ``report``): outcome-joined ranking quality for
    both arms + the drift headline."""
    realized = join_outcomes(shadow_rows, download_rows)
    joined = int((~np.isnan(realized)).sum())
    regret = regret_at_k(shadow_rows, realized, k=k)
    inversion = pairwise_inversion_rate(shadow_rows, realized)
    versions = shadow_rows[:, _COL["candidate_version"]] if shadow_rows.size else np.zeros(0)
    return {
        "shadow_rows": int(shadow_rows.shape[0]),
        "joined_edges": joined,
        "announces": regret["announces"],
        "candidate_version": int(versions.max()) if versions.size else 0,
        "regret_at_k": {
            "k": k,
            "candidate": regret["candidate"],
            "active": regret["active"],
        },
        "inversion_rate": {
            "pairs": inversion["pairs"],
            "candidate": inversion["candidate"],
            "active": inversion["active"],
        },
        "psi_max": psi_max,
    }
