"""K2 (``ops.fused_score.rule_sum``) on a ladder of row counts, on the card.

Each rung tiles one set of rule components (``[m, 6]`` f32, the rule
evaluator's own columns) to its row count on the device and holds K2 to
its plain version there (``K2_TOL``), on the tensor and on the view that
starts one row in (24 bytes off a 16-byte boundary).  Then it times K2,
the plain version and ``torch.mv`` (one PyTorch call for the same
function, never called by the port) with ``bench/timing.device_ms``, and
computes the bound from the rung's bytes.  The rungs:

- 512 rows: the smoke's K2 shape; the launch sets the pace;
- 65,536 rows: the serving slot table's row count, 1.8 MB, which stays in
  the 50 MB L2 from one launch to the next;
- 16,777,216 rows: 470 MB, nine times L2, so every launch reads HBM.

``chip_smoke.py`` runs ``ladder`` on the rule arm's components; alone,
the components come from the rule ``Evaluator`` over
``sim.swarm.build_announce_swarm``'s candidate set.  Prints one JSON
line with the card's name and power limit, the launch floor (an empty
launch timed the same way) and each rung.

    python -m dragonfly2_tpu_torch.bench.k2_ladder [--rows 512,65536,16777216]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..ops.fused_score import RULE_COMPONENT_WEIGHTS, _rule_sum_plain, rule_sum
from .timing import bound, device_ms, k2_cost

RUNGS = (512, 65_536, 16_777_216)
K2_TOL = 1e-6   # K2 vs plain, unscaled: the components lie in [0, 1]


def swarm_components(seed: int = 0, hosts: int = 1000) -> np.ndarray:
    """[hosts - 1, 6] f32: the rule evaluator's six columns for one child
    over every other peer of a seeded announce swarm."""
    from ..scheduler.evaluator import Evaluator
    from ..sim.swarm import build_announce_swarm

    task, peers = build_announce_swarm(hosts, seed=seed)
    cols = Evaluator()._component_arrays(peers[1:], peers[0], task.total_piece_count)
    return np.stack(cols, axis=1).astype(np.float32)


def tiled(comps: np.ndarray, n: int, device) -> torch.Tensor:
    """[n, 6] f32 on ``device``: the rows of ``comps`` repeated in order."""
    src = torch.from_numpy(np.ascontiguousarray(comps, dtype=np.float32)).to(device)
    idx = torch.arange(n, device=device) % src.shape[0]
    return src[idx].contiguous()


def ladder(comps: np.ndarray, device, rungs=RUNGS, floor_ms=None) -> dict:
    """{"launch_floor_ms", "rungs": {n: {...}}} for K2 at each row count,
    each with K2's largest distance from its plain version on the tensor
    and on the offset view, for the caller to hold to ``K2_TOL``.  These
    launches compare and time K2: a caller that counts the path's
    launches reads its counts before."""
    if floor_ms is None:
        floor_ms = device_ms(lambda: torch.cuda._sleep(1))
    w = torch.tensor(RULE_COMPONENT_WEIGHTS, dtype=torch.float32, device=device)
    out = {}
    for n in rungs:
        c = tiled(comps, n, device)
        errs = []
        for view in (c, c[1:]):
            got = rule_sum(view)
            want = _rule_sum_plain(view, RULE_COMPONENT_WEIGHTS)
            torch.cuda.synchronize()
            errs.append(float((got - want).abs().max()) if view.shape[0] else 0.0)
        ms = device_ms(lambda: rule_sum(c))
        plain_ms = device_ms(lambda: _rule_sum_plain(c, RULE_COMPONENT_WEIGHTS))
        mv_ms = device_ms(lambda: torch.mv(c, w))
        bound_ms, bound_by = bound(*k2_cost(n))
        out[n] = {"ms": ms, "plain_ms": plain_ms, "library_ms": mv_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "share_of_bound": bound_ms / ms, "over_launch_floor_ms": ms - floor_ms,
                  "max_abs_err": errs[0], "max_abs_err_offset_view": errs[1]}
        del c
        torch.cuda.empty_cache()
    return {"launch_floor_ms": floor_ms, "rungs": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(str(n) for n in RUNGS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_ladder: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    comps = swarm_components(args.seed)
    result = ladder(comps, dev, rungs=[int(x) for x in args.rows.split(",")])
    worst = max(max(r["max_abs_err"], r["max_abs_err_offset_view"])
                for r in result["rungs"].values())
    print(json.dumps({"card": card, "kind": torch.cuda.get_device_name(0),
                      "components": list(comps.shape), **result, "k2_tol": K2_TOL,
                      "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}), flush=True)
    return 0 if worst <= K2_TOL else 1


if __name__ == "__main__":
    raise SystemExit(main())
