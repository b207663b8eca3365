"""Lifecycle decision kernel: the pure functions the daemon replays.

Port of ``dragonfly2_tpu/lifecycle/arbiter.py``, verbatim.

Every decision the self-driving lifecycle plane makes — when to cut a
training epoch, and which of a global/regional candidate set may advance
toward CANARY — is computed HERE as a pure function of its inputs, and
declared a replay root in records/determinism_contracts.py (DF018/DF019).
The daemon (lifecycle/daemon.py) samples the ambient world (record
counters, replay-log evaluations) outside these functions and passes the
values in, so the §27 dual-run divergence drill can re-run the loop that
retrains the fleet's brain over journal bytes and demand byte-identical
decisions.

Regional arbitration (DESIGN.md §29): a regional candidate
(``name@region`` registry key) competes with the global candidate for its
region's traffic.  Admission to CANARY is regret@k-gated:

- a candidate below ``min_joined`` joined samples is **held** (not
  enough evidence to judge either way);
- while a global candidate exists but is itself below the evidence
  floor, every regional candidate is **held** too — a regional may only
  advance by BEATING the global arm, never by out-accumulating joined
  samples while the global arm is still unjudged;
- an eligible regional candidate **advances** only if its regret beats
  the global candidate's by ``margin`` — ties go to global (one model
  for the whole fleet is cheaper than a specialization that buys
  nothing) — otherwise it is **retired** (deactivated, freeing the
  region's candidate slot); with no global candidate in the report set
  at all there is nothing to beat and eligible regionals advance;
- the eligible global candidate advances unless EVERY eligible regional
  candidate beat it, in which case it is retired.

Keep these functions pure: no clocks, no RNG, no ambient reads — DF018
taints everything reachable from them.
"""

from __future__ import annotations

from typing import Dict, Optional

# The pseudo-region of the fleet-wide model: its registry key is the bare
# model name, every real region's key is ``name@region``.
GLOBAL_KEY = "global"


def regional_model_name(base: str, region: Optional[str]) -> str:
    """Registry model name for a lifecycle key: the bare ``base`` for the
    global arm, ``base@region`` for a regional specialization (the
    registry keys models per (scheduler_id, name), so regional keys ride
    composed names with no registry change)."""
    if not region or region == GLOBAL_KEY:
        return base
    return f"{base}@{region}"


def plan_epoch(
    *,
    records_seen: int,
    watermark: int,
    epoch_records: int,
    candidate_in_flight: bool,
) -> Dict:
    """Cut a new training epoch?  Pure cadence arithmetic: an epoch is
    due once ``epoch_records`` new records have arrived past the last
    watermark AND the previous candidate has resolved (one candidate per
    key in flight — the registry enforces the same exclusivity)."""
    fresh = max(int(records_seen) - int(watermark), 0)
    if candidate_in_flight:
        return {
            "train": False,
            "watermark": int(watermark),
            "reason": "candidate still in flight",
        }
    if epoch_records <= 0 or fresh < epoch_records:
        return {
            "train": False,
            "watermark": int(watermark),
            "reason": f"{fresh}/{epoch_records} records since watermark",
        }
    return {
        "train": True,
        "watermark": int(records_seen),
        "reason": f"cadence reached ({fresh} records)",
    }


def arbitrate_candidates(
    reports: Dict[str, dict], *, min_joined: int = 50, margin: float = 0.02
) -> Dict:
    """Global-vs-regional CANARY admission over one base name's SHADOW
    candidates.  ``reports`` maps lifecycle key (``"global"`` or a region
    name) → rollout/evaluation.py ``evaluate_shadow`` report.  Returns
    ``{"advance": [keys], "hold": {key: reason}, "retire": {key:
    reason}}`` with deterministic (sorted) ordering."""
    hold: Dict[str, str] = {}
    retire: Dict[str, str] = {}
    eligible: Dict[str, float] = {}
    for key in sorted(reports):
        rep = reports[key] or {}
        joined = int(rep.get("joined_edges", 0))
        if joined < min_joined:
            hold[key] = f"{joined}/{min_joined} joined samples"
            continue
        regret = (rep.get("regret_at_k") or {}).get("candidate", 0.0)
        eligible[key] = float(regret)
    advance = []
    global_regret = eligible.get(GLOBAL_KEY)
    regional = [k for k in sorted(eligible) if k != GLOBAL_KEY]
    if GLOBAL_KEY in hold:
        # A global candidate exists but is below the evidence floor:
        # "no eligible global" must not read as "nothing to beat", or
        # admission would depend on which arm accumulates joined
        # samples first.  Hold the eligible regionals until the global
        # arm can be judged.
        for key in regional:
            hold[key] = (
                f"global candidate below evidence floor "
                f"({hold[GLOBAL_KEY]})"
            )
        return {"advance": [], "hold": hold, "retire": retire}
    beaten_everywhere = bool(regional)
    for key in regional:
        if global_regret is None or eligible[key] + margin < global_regret:
            advance.append(key)
        else:
            beaten_everywhere = False
            retire[key] = (
                f"regional regret {eligible[key]:.4f} does not beat global "
                f"{global_regret:.4f} by {margin}"
            )
    if global_regret is not None:
        if beaten_everywhere:
            retire[GLOBAL_KEY] = (
                "every eligible regional candidate beat the global arm by "
                f"{margin}"
            )
        else:
            advance.insert(0, GLOBAL_KEY)
    return {"advance": advance, "hold": hold, "retire": retire}
