"""Where K1's device time goes: clock64() stamps in a copy of the kernel.

Writes an instrumented copy of the package's ``csrc/fused_score.cu``
under ``build/k1_stamps/`` (the source itself holds no stamps): lane 0
of each warp records the SM cycle counter at six points of its row's
walk (``STAMP_POINTS``).  Builds the copy, launches it at the serving
shapes (32→64→64→1, a 65,536-row slot matrix, seeded inputs) and reads
the stamps back after every launch.  Prints one JSON line per row count:
the median and p90 cycles from kernel entry to each stamp, the SM clock
read beside the run, the instrumented kernel's device time and the
launch floor (an empty launch), both timed as ``chip_smoke.py`` times
them.

    python -m dragonfly2_tpu_torch.bench.k1_stamps [--rows 128,512]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.fused_score import ServingMLP
from .timing import device_ms

# (label, a line of the kernel's main path, stamp "before" or "after" it).
# Each line must occur exactly once in the source, so an edit of the
# kernel that moves one fails here instead of stamping the wrong place.
STAMP_POINTS = (
    ("entry", "  const int lane = tid & 31;", "after"),
    ("inputs_gathered", "  mbar_wait0(&bars[0]);", "before"),
    ("part_a_landed", "  mbar_wait0(&bars[0]);", "after"),
    ("layer1_done", "  mbar_wait0(&bars[1]);", "before"),
    ("part_b_landed", "  mbar_wait0(&bars[1]);", "after"),
    ("score_ready", "  if (lane == 0) out[row] = head + s_b2[0];", "before"),
)
MAX_WARPS = 8192   # one row a warp: the most rows a launch may stamp

_HEADER = f"""
__device__ long long g_k1_stamps[{MAX_WARPS}][{len(STAMP_POINTS)}];
#define K1_STAMP(i) \\
  do {{ \\
    const int gw = blockIdx.x * kWarps + warp; \\
    if (lane == 0 && gw < {MAX_WARPS}) g_k1_stamps[gw][i] = clock64(); \\
  }} while (0)
"""
_READER = f"""
extern "C" int df_k1_stamps_read(long long* host, int warps) {{
  if (warps > {MAX_WARPS}) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_k1_stamps, sizeof(long long) * {len(STAMP_POINTS)} * warps));
}}
"""
_P, _I = ctypes.c_void_p, ctypes.c_int


def instrument(source: str) -> str:
    """``source`` with a ``K1_STAMP(i)`` at each of ``STAMP_POINTS``, the
    stamp array after the includes and its reader at the end."""
    lines = source.split("\n")
    out = []
    for line in lines:
        stripped = line.rstrip()
        out.extend(f"  K1_STAMP({i});" for i, (_, at, where) in enumerate(STAMP_POINTS)
                   if where == "before" and stripped == at)
        out.append(line)
        out.extend(f"  K1_STAMP({i});" for i, (_, at, where) in enumerate(STAMP_POINTS)
                   if where == "after" and stripped == at)
        if stripped == "#include <stdint.h>":
            out.append(_HEADER)
    for label, at, _ in STAMP_POINTS:
        if sum(line.rstrip() == at for line in lines) != 1:
            raise ValueError(f"stamp point {label!r}: {at.strip()!r} is not one line of K1")
    if "#include <stdint.h>" not in lines:
        raise ValueError("K1's source does not include <stdint.h>")
    return "\n".join(out) + _READER


def build() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR.parent / "k1_stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fused_score_stamped.cu"
    src.write_text(instrument((_build.SOURCE_DIR / "fused_score.cu").read_text()))
    lib_path = out_dir / "fused_score_stamped.so"
    subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
        check=True,
    )
    return ctypes.CDLL(str(lib_path))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="128,512")
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_stamps: no CUDA device")
    dev = torch.device("cuda")
    lib = build()
    labels = [label for label, _, _ in STAMP_POINTS]

    rng = np.random.default_rng(args.seed)
    dims = (32, 64, 64, 1)
    weights = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
                rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
               for i in range(3)]
    mlp = ServingMLP(weights, device=dev)
    mat = torch.from_numpy(rng.standard_normal((65536, 12)).astype(np.float32)).to(dev)
    stream = _build.stream_handle(dev)
    card = smi("name,power.limit")
    floor_ms = device_ms(lambda: torch.cuda._sleep(1))
    for n in (int(x) for x in args.rows.split(",")):
        if n > MAX_WARPS:
            raise SystemExit(f"k1_stamps: at most {MAX_WARPS} rows")
        s = torch.from_numpy(rng.integers(0, 65536, n).astype(np.int32)).to(dev)
        d = torch.from_numpy(rng.integers(0, 65536, n).astype(np.int32)).to(dev)
        e = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(dev)
        out = torch.empty(n, dtype=torch.float32, device=dev)
        fn_args = (_P(mat.data_ptr()), ctypes.c_longlong(mat.shape[0]), _P(s.data_ptr()),
                   _P(d.data_ptr()), _P(e.data_ptr()), _P(mlp.k1_blob.data_ptr()),
                   _P(out.data_ptr()), _I(n), _I(64), _I(64), _P(stream))

        def launch():
            code = lib.df_fused_gather_mlp_score(*fn_args)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        stamps = np.zeros((n, len(labels)), np.int64)       # warp w scores row w
        samples = []
        for _ in range(args.launches):
            launch()
            torch.cuda.synchronize()
            code = lib.df_k1_stamps_read(stamps.ctypes.data_as(_P), _I(n))
            if code:
                raise RuntimeError(f"stamp read failed: CUDA error {code}")
            samples.append(stamps - stamps[:, :1])
        deltas = np.concatenate(samples)
        clock = smi("clocks.sm,clocks.max.sm")
        ms = device_ms(launch)
        print(json.dumps({
            "rows": n, "card": card, "sm_clock_mhz_now_max": clock,
            "warps_sampled": int(deltas.shape[0]),
            "median_cycles_from_entry": {lab: float(np.median(deltas[:, i]))
                                         for i, lab in enumerate(labels)},
            "p90_cycles_from_entry": {lab: float(np.percentile(deltas[:, i], 90))
                                      for i, lab in enumerate(labels)},
            "kernel_ms": ms, "launch_floor_ms": floor_ms,
            "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
