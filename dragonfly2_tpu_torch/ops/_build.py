"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers, so the build takes seconds.  Each source compiles in
its own ``nvcc`` process, all started together, and one more links them.
The build runs at first use, under an ``fcntl`` lock beside the target
(the batcher's leader thread and the caller's thread can race on it, and
so can processes), into ``build/dragonfly2_tpu_torch_kernels/`` beside
the package, and again whenever the sources' hash changes.  The thread
lock guards only the loaded library, never the build.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception.  Pointers and the stream cross
as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "dragonfly2_tpu_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What the last build in this process said (nvcc's -Xptxas -v report:
# registers, shared memory, spills per kernel) and how long it took.
build_log = ""
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # mat, n_slots, slots, dslots, edge, blob, out, n, d1, d2, stream
    "df_fused_gather_mlp_score": (
        [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        ctypes.c_int,
    ),
    # components, out, n, w0..w5, stream
    "df_rule_weighted_sum": ([_P, _P, _I, _F, _F, _F, _F, _F, _F, _P], ctypes.c_int),
    "df_fused_score_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "df_fused_score_blob_floats": ([_I, _I], ctypes.c_int),
    # values, values_bf16, round_bf16, edge_row, edge_seg, chunk_lo,
    # chunk_hi, chunk_seg_lo, chunk_seg_hi, chunk_slot, n_chunks, long_seg,
    # long_first, n_long, partial, out, d, stream
    "df_segment_sum": (
        [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P],
        ctypes.c_int,
    ),
    "df_error_string": ([_I], ctypes.c_char_p),
}


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.  A CUDA
    device with no card raises: there is no silent CPU path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _compile(target: Path, srcs: List[Path]) -> None:
    """One ``nvcc -c`` per source, all at once, then one link."""
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{target.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(srcs, procs)]
    failed = [src.name for src, proc in zip(srcs, procs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    # Atomic publish: a concurrent process sees the whole library or none.
    os.replace(tmp, target)


def load() -> ctypes.CDLL:
    """The kernels' library, built if these sources have not been built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    srcs = sources()
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    target = BUILD_DIR / f"libdf_kernels_{h.hexdigest()[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # One build at a time, across threads and processes: each open()
        # is its own lock holder, and the first holder's build is what
        # the others find when they get the lock.
        with open(target.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not target.exists():
                    _compile(target, srcs)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(target))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    with _lock:
        if _lib is None:
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise on a non-zero ``cudaError_t`` from a C entry."""
    if code != 0:
        what = lib.df_error_string(code).decode("utf-8", "replace")
        raise RuntimeError(f"{name}: CUDA error {code} ({what}) at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
