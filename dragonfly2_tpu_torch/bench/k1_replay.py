"""K1 against its plain version on fixed inputs, many times over.

Three tools for a reading of K1 off its plain version past the limit
(1e-5 × max(1, max |score|)):

- ``save_flush`` writes one flush's inputs with ``torch.save``: the slot
  mirror it gathered from, its parent and child slots, its edge block,
  the scorer's weights (and K1's packed blob), whether each gathered
  slot was bound in the store at the flush, and the reading.
  ``chip_smoke.k1_on_flushes`` calls it for every flush past the limit.
- ``replay(path)`` runs K1 and the plain version ``launches`` times each
  on exactly those tensors, and a float64 plain version once.  A gap on
  every launch, with K1's output the same bits each time, is the input
  (ill-conditioned rows: the f64 reference says which side is nearer) or
  a fault of K1 that depends on the data; a gap on some launches only is
  a race.
- ``stress`` launches K1 on ``flushes`` seeded flushes (sizes 1 to
  1,024 across every pad boundary, slots spread over a 65,536-row
  matrix of store-like rows) ``repeats`` times back to back each, and
  holds every launch to the plain version and to the first launch's
  bits.

    python -m dragonfly2_tpu_torch.bench.k1_replay FILE [--launches 1000] [--device cuda]
    python -m dragonfly2_tpu_torch.bench.k1_replay --stress [--flushes 2000] [--repeats 3]

Prints one JSON line.  Runs on the card unless given ``--device cpu``
(where K1's wrapper takes its plain version, so only the file's format
and the loop are exercised).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import fused_score
from ..records.features import EDGE_FEATURE_DIM, HOST_FEATURE_DIM

K1_TOL = 1e-5          # K1 vs plain, scaled by max(1, max |score|)
STRESS_SLOTS = 65_536
# Every pad boundary of K1's grid (4 rows a block) and so of the serving
# scorer's 128-row candidate block, up to 1,024 rows.
PAD_EDGES = sorted({n for b in range(4, 1025, 4) for n in (b - 1, b, b + 1)
                    if 1 <= n <= 1024} | {1, 2})


def _plain(mat, s, d, e, mlp):
    return fused_score._fused_score_plain(mat, s, d, e, mlp.w0c, mlp.w0p, mlp.w0e, mlp.b0,
                                          mlp.layers())


def _plain_f64(mat, s, d, e, mlp):
    f = [t.double() for t in (mlp.w0c, mlp.w0p, mlp.w0e, mlp.b0)]
    layers = [(w.double(), b.double()) for w, b in mlp.layers()]
    return fused_score._fused_score_plain(mat.double(), s.long(), d.long(), e.double(), *f,
                                          layers)


def scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def save_flush(path: str, *, mat, slots, dslots, edge, weights, mlp,
               post_hoc_masked: bool = True, bound_src=None, bound_dst=None,
               err: Optional[float] = None, **meta) -> str:
    """One flush's inputs (CPU copies), the scorer's exported ``weights``
    and its ``ServingMLP``'s packed blob → ``path``."""
    torch.save({
        "mirror": mat.detach().cpu(), "slots": slots.detach().cpu(),
        "dslots": dslots.detach().cpu(), "edge": edge.detach().cpu(),
        "weights": [(np.asarray(w), np.asarray(b)) for w, b in weights],
        "post_hoc_masked": bool(post_hoc_masked),
        "k1_blob": mlp.k1_blob.detach().cpu(),
        "bound_src": None if bound_src is None else np.asarray(bound_src, bool),
        "bound_dst": None if bound_dst is None else np.asarray(bound_dst, bool),
        "err_scaled": err, "meta": meta,
    }, path)
    return path


def replay(path: str, *, launches: int = 1000, device="cuda") -> Dict:
    """K1 and plain ``launches`` times each on the saved tensors."""
    dev = torch.device(device)
    saved = torch.load(path, weights_only=False)
    mlp = fused_score.ServingMLP(saved["weights"], post_hoc_masked=saved["post_hoc_masked"],
                                 device=dev)
    mat, s, d, e = (saved[k].to(dev) for k in ("mirror", "slots", "dslots", "edge"))
    first = _plain(mat, s, d, e, mlp)
    ref64 = _plain_f64(mat, s, d, e, mlp)
    k1_errs, plain_bits_same, k1_outs = [], True, []
    k1_first = None
    for _ in range(launches):
        got = fused_score.fused_gather_mlp_score(mat, s, d, e, mlp)
        want = _plain(mat, s, d, e, mlp)
        k1_errs.append(scaled_err(got, want))
        plain_bits_same &= bool(torch.equal(want, first))
        if k1_first is None:
            k1_first = got.clone()
        elif not torch.equal(got, k1_first):
            k1_outs.append(len(k1_errs) - 1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    over = sum(x > K1_TOL for x in k1_errs)
    rows = np.concatenate([saved["slots"].numpy(), saved["dslots"].numpy()])
    bound = saved["bound_src"], saved["bound_dst"]
    return {
        "file": path, "rows": int(s.numel()), "launches": launches,
        "saved_err_scaled": saved["err_scaled"],
        "err_scaled_max": max(k1_errs), "err_scaled_min": min(k1_errs),
        "launches_over_tol": int(over),
        "verdict": ("every launch" if over == launches else
                    "some launches" if over else "none"),
        "k1_bits_vary": len(k1_outs), "plain_bits_same": plain_bits_same,
        "k1_vs_f64_scaled": scaled_err(k1_first.double(), ref64),
        "plain_vs_f64_scaled": scaled_err(first.double(), ref64),
        "gathered_row_max_abs": float(mat[torch.from_numpy(rows).long().to(dev)].abs().max()),
        "unbound_rows": None if bound[0] is None else int((~bound[0]).sum() + (~bound[1]).sum()),
        "meta": saved["meta"],
    }


def store_like_rows(seed: int, n_hosts: int = 16_384, slots: int = STRESS_SLOTS) -> np.ndarray:
    """``slots`` host feature rows as the columnar store writes them: the
    seeded synthetic cluster's hosts bound into a ``HostFeatureCache``,
    their rows tiled over the matrix."""
    from ..records.synthetic import SyntheticCluster
    from ..scheduler.featcache import HostFeatureCache
    from ..sim.swarm import host_from_latent

    cluster = SyntheticCluster(num_hosts=n_hosts, seed=seed)
    store = HostFeatureCache(max_hosts=n_hosts)
    rows = store.gather([host_from_latent(lh) for lh in cluster.hosts])
    reps = -(-slots // rows.shape[0])
    return np.ascontiguousarray(np.tile(rows, (reps, 1))[:slots], dtype=np.float32)


def stress(dev, *, flushes: int = 2000, repeats: int = 3, seed: int = 0,
           weights: Optional[Sequence] = None, rows: Optional[np.ndarray] = None,
           edges: Optional[np.ndarray] = None, save_dir: Optional[str] = None) -> Dict:
    """K1 on ``flushes`` seeded flushes, ``repeats`` launches each back to
    back, every launch held to the plain version and to the flush's first
    launch.  ``rows`` is the slot matrix (``store_like_rows`` by default),
    ``edges`` a pool of edge rows to draw from (seeded uniform rows by
    default), ``weights`` the scorer's (the serving shape, seeded, by
    default).  A flush past the limit is saved under ``save_dir``."""
    rng = np.random.default_rng(seed)
    if weights is None:
        dims = (2 * HOST_FEATURE_DIM + EDGE_FEATURE_DIM, 64, 64, 1)
        weights = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
                    rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
                   for i in range(len(dims) - 1)]
    mlp = fused_score.ServingMLP(list(weights), device=dev)
    if rows is None:
        rows = store_like_rows(seed)
    mat = torch.from_numpy(rows).to(dev)
    if edges is None:
        edges = rng.random((4096, EDGE_FEATURE_DIM), dtype=np.float32)
    sizes = list(PAD_EDGES) + [int(n) for n in rng.integers(1, 1025,
                                                            max(0, flushes - len(PAD_EDGES)))]
    sizes = sizes[:flushes]
    worst, over, bits_vary, launches, saved = 0.0, 0, 0, 0, []
    for i, n in enumerate(sizes):
        s = torch.from_numpy(rng.integers(0, rows.shape[0], n).astype(np.int32)).to(dev)
        d = torch.from_numpy(rng.integers(0, rows.shape[0], n).astype(np.int32)).to(dev)
        e = torch.from_numpy(np.ascontiguousarray(edges[rng.integers(0, len(edges), n)])).to(dev)
        outs = [fused_score.fused_gather_mlp_score(mat, s, d, e, mlp) for _ in range(repeats)]
        launches += repeats
        want = _plain(mat, s, d, e, mlp)
        errs = [scaled_err(o, want) for o in outs]
        bits_vary += sum(not torch.equal(o, outs[0]) for o in outs[1:])
        worst = max(worst, *errs)
        if max(errs) > K1_TOL:
            over += 1
            if save_dir is not None and len(saved) < 4:
                os.makedirs(save_dir, exist_ok=True)
                saved.append(save_flush(os.path.join(save_dir, f"k1_stress_{i}.pt"),
                                        mat=mat, slots=s, dslots=d, edge=e, weights=weights,
                                        mlp=mlp, err=max(errs), stress_flush=i))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"flushes": len(sizes), "repeats": repeats, "launches": launches,
            "rows_min": min(sizes), "rows_max": max(sizes),
            "pad_edges_covered": len(PAD_EDGES), "slots": int(rows.shape[0]),
            "max_err_scaled": worst, "flushes_over_tol": over, "k1_bits_vary": bits_vary,
            "tol_scaled": K1_TOL, "saved": saved}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", nargs="?", help="a flush saved by save_flush")
    ap.add_argument("--launches", type=int, default=1000)
    ap.add_argument("--stress", action="store_true", help="run the seeded stress instead")
    ap.add_argument("--flushes", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("k1_replay: no CUDA device (pass --device cpu for the plain loop)",
              file=sys.stderr)
        return 2
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    if args.stress:
        out = stress(dev, flushes=args.flushes, repeats=args.repeats, seed=args.seed)
    elif args.file:
        out = replay(args.file, launches=args.launches, device=dev)
    else:
        ap.error("give a FILE or --stress")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
