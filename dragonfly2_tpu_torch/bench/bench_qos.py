"""Multi-tenant QoS isolation benchmark (DESIGN.md §26).

Drives ``sim/qos.py``'s overload drill — a measured tenant-A workload
(announce loop + real downloads off a seed daemon) against a tenant-B
announce+download flood — in INTERLEAVED rounds (bench_sched
discipline: GC quiesced, identical config per round, arms inside one
round share one box state):

- ``baseline``  — tenant A alone;
- ``unshaped``  — the burst with tenant-blind admission and no caps
                  (documents the baseline interference);
- ``shaped``    — the burst with the QoS plane live (background class,
                  announce-rate cap, upload-bandwidth cap, per-tenant
                  accounting + noisy-first shedding).

Headline: **isolation_score = 100 − max(shaped movement of tenant A's
announce p99 and download TTLB, in %, floored at 0)** over the best
round — ≥ 90 means the <10% isolation bar held.

Port of ``tools/bench_qos.py``: the same rounds, flags and ``--smoke``,
and three flags more.  ``--evaluator ml`` ranks the drill's parents with
an ``MLEvaluator`` over a ``FusedMLPScorer`` (K1) on ``--device``, built
from the seed-made 32→64→64→1 artifact ``chip_smoke.py`` serves
(``wire_loop.seeded_k1_blob(0)``);
``--extra-parents N`` gives each of tenant A's downloads N more
candidates (``sim/qos.py``), without which the ml evaluator scores
nothing.  It writes no ``BENCH_QOS_r*.json`` and has no regression
guard: the reference's rounds are another program's host numbers.
With ``--evaluator ml`` the JSON also carries K1's launches and the
batchers' scorer calls.

Usage: python -m dragonfly2_tpu_torch.bench.bench_qos
       [--rounds 3] [--announces 1200] [--downloads 10]
       [--pieces 8] [--piece-size 65536] [--b-threads 2] [--seed 7]
       [--evaluator rule|ml] [--extra-parents 0] [--device cuda]
       [--smoke]   # tiny drill: the JSON-schema gate
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List

SCHEMA_KEYS = (
    "ok",
    "metric",
    "value",
    "config",
    "rounds",
    "best",
    "movement",
    "arms",
)

ARM_KEYS = (
    "a_announce_p99_ms",
    "a_ttlb_ms",
    "b_offered",
    "b_sheds",
    "b_throttled",
    "a_downloads_ok",
)


class MLEvaluators:
    """``sim/qos`` evaluator factory: each call builds an ``MLEvaluator``
    over a ``FusedMLPScorer`` on ``device`` with a ``ScorerBatcher`` (its
    1.5 ms linger, the scheduler config's default), over the drill's
    feature cache, and keeps it in ``built``."""

    def __init__(self, blob: bytes, device) -> None:
        from ..trainer.export import load_scorer

        self._scorer = load_scorer(blob)
        self.device = device
        self.built: List[object] = []

    def __call__(self, cache):
        from ..ops.fused_score import FusedMLPScorer
        from ..scheduler import MLEvaluator, ScorerBatcher

        ev = MLEvaluator(
            FusedMLPScorer.from_scorer(cache, self._scorer, device=self.device),
            feature_cache=cache,
            batcher=ScorerBatcher(),
        )
        self.built.append(ev)
        return ev

    def scorer_calls(self) -> int:
        return sum(ev.batcher.scorer_calls for ev in self.built)


def _isolation_score(movement: Dict[str, float]) -> float:
    """100 − the worst shaped movement (announce p99 / TTLB), floored at
    0 from below (a negative movement is no interference, not credit)."""
    worst = max(
        0.0,
        float(movement["shaped_announce_p99_pct"]),
        float(movement["shaped_ttlb_pct"]),
    )
    return round(max(0.0, 100.0 - worst), 2)


def run(args) -> Dict[str, object]:
    from ..ops import fused_score
    from ..sim.qos import QoSDrillConfig, run_isolation_drill

    cfg = QoSDrillConfig(
        a_announces=args.announces,
        a_downloads=args.downloads,
        pieces_per_task=args.pieces,
        piece_size=args.piece_size,
        b_threads=args.b_threads,
        seed=args.seed,
    )
    evaluators = None
    if args.evaluator == "ml":
        from .wire_loop import seeded_k1_blob

        evaluators = MLEvaluators(seeded_k1_blob(0), args.device)
    k1_0 = fused_score.LAUNCHES["fused_gather_mlp_score"]
    rounds: List[Dict[str, object]] = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(max(1, args.rounds)):
            rounds.append(run_isolation_drill(
                cfg, evaluator=evaluators, extra_parents=args.extra_parents,
            ))
    finally:
        gc.enable()
    scored = [
        (_isolation_score(r["movement"]), i) for i, r in enumerate(rounds)
    ]
    best_score, best_i = max(scored)
    best = rounds[best_i]
    # Every round must prove the flood actually ran and the shaped arm
    # actually shed/capped it — an idle flood is a vacuous isolation.
    for r in rounds:
        if r["unshaped"]["b_offered"] == 0:
            raise RuntimeError("tenant-B flood never ran in an unshaped arm")
        shaped = r["shaped"]
        if shaped["b_sheds"] + shaped["b_throttled"] == 0:
            raise RuntimeError("shaped arm never shed or capped the flood")
        if shaped["a_downloads_ok"] != args.downloads:
            raise RuntimeError(
                "tenant-A downloads failed under the shaped burst: "
                f"{shaped['a_downloads_ok']}/{args.downloads}"
            )
    out: Dict[str, object] = {
        "ok": True,
        "metric": "qos_isolation_score",
        "value": best_score,
        "config": {
            "rounds": args.rounds,
            "a_announces": cfg.a_announces,
            "a_downloads": cfg.a_downloads,
            "pieces_per_task": cfg.pieces_per_task,
            "piece_size": cfg.piece_size,
            "b_threads": cfg.b_threads,
            "b_announce_qps": cfg.b_announce_qps,
            "b_upload_rate": cfg.b_upload_rate,
            "seed": cfg.seed,
            "evaluator": args.evaluator,
            "extra_parents": args.extra_parents,
            "device": args.device if args.evaluator == "ml" else None,
        },
        "rounds": [r["movement"] for r in rounds],
        "best": best["movement"],
        "movement": best["movement"],
        "arms": {
            "baseline": best["baseline"],
            "unshaped": best["unshaped"],
            "shaped": best["shaped"],
        },
        "unshaped_interference": {
            "announce_p99_pct": best["movement"]["unshaped_announce_p99_pct"],
            "ttlb_pct": best["movement"]["unshaped_ttlb_pct"],
        },
    }
    if evaluators is not None:
        out["k1"] = {
            "launches": fused_score.LAUNCHES["fused_gather_mlp_score"] - k1_0,
            "scorer_calls": evaluators.scorer_calls(),
        }
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--announces", type=int, default=1200)
    p.add_argument("--downloads", type=int, default=10)
    p.add_argument("--pieces", type=int, default=8)
    p.add_argument("--piece-size", type=int, default=64 * 1024)
    p.add_argument("--b-threads", type=int, default=2)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--evaluator", choices=("rule", "ml"), default="rule",
                   help="the drill's parent ranking: the reference's rule "
                        "Evaluator, or an MLEvaluator over K1")
    p.add_argument("--extra-parents", type=int, default=0,
                   help="more candidates for each of tenant A's downloads")
    p.add_argument("--device", default="cuda",
                   help="K1's device with --evaluator ml (cpu: its plain version)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny drill: the JSON-schema gate")
    args = p.parse_args(argv)
    if args.smoke:
        args.rounds, args.announces, args.downloads = 1, 200, 3
        args.pieces, args.piece_size = 4, 16 * 1024
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        out = run(args)
        missing = [k for k in SCHEMA_KEYS if k not in out]
        for arm, stats in out["arms"].items():
            missing += [f"{arm}.{k}" for k in ARM_KEYS if k not in stats]
        if missing:
            raise RuntimeError(f"schema keys missing: {missing}")
    except Exception as exc:  # noqa: BLE001 — one parseable line, never a traceback
        print(json.dumps({
            "ok": False,
            "metric": "qos_isolation_score",
            "error": f"{type(exc).__name__}: {exc}"[:300],
        }))
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
