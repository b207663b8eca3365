"""ctypes bindings for the port's native (C++) host engine.

``native/src/native.cpp`` holds the engine: the DFC1 record writer
(``re_*``), the daemon's piece store and its in-engine HTTP piece server
(``ps_*``, sendfile on the data path), the piece fetch loop (``pf_*``)
and the online-ingest engine (``oi_*``).  ``load()`` builds it on first
use with ``g++`` (``-O2 -g -std=c++17 -fPIC -shared -lpthread``) into
``build/dragonfly2_tpu_torch_native/`` beside the package, under a file
name keyed by the source's hash.  The build is written to a temporary
file and moved into place with ``os.replace``, under a process lock and
an ``fcntl`` lock beside the target, so processes that reach it at once
share one build.  Nothing is written into the package directory.

Services treat native as an optimization, as the reference does:
``available()`` gates it, and the Python implementations
(``records/columnar.py``, ``daemon/storage._PyPieceStore``, the Python
arm of ``daemon/conductor``, ``trainer/online_graph.WireIngestAdapter``)
stay the spec and the fallback.  ``build_error()`` says why a build
failed.

Port of ``dragonfly2_tpu/native/__init__.py``, verbatim but for the
build (the reference runs its Makefile into its package directory),
``build_self_test``, which builds ``native_test.cpp`` plain or under a
sanitizer into the same directory, and ``NativeColumnarWriter``'s header,
whose keys are sorted as the Python writer sorts them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..records import abi_contracts as _abi

SOURCE_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dragonfly2_tpu_torch_native"
LIB_FLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-shared")
LINK_FLAGS = ("-lpthread",)
# native_test.cpp builds: (compile flags, the environment it runs under),
# the reference Makefile's test / asan / tsan / ubsan targets.
SELF_TESTS = {
    "plain": (("-O2", "-g", "-std=c++17", "-fPIC"), {}),
    "asan": (("-O1", "-g", "-std=c++17", "-fsanitize=address,undefined"),
             {"ASAN_OPTIONS": "detect_leaks=1"}),
    "tsan": (("-O1", "-g", "-std=c++17", "-fsanitize=thread"),
             {"TSAN_OPTIONS": "halt_on_error=1"}),
    "ubsan": (("-O1", "-g", "-std=c++17", "-fsanitize=undefined",
               "-fno-sanitize-recover=all"),
              {"UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1"}),
}
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
# Where the loaded library lies, and how long this process spent building
# it (0.0 when another process or an earlier run had built it).
lib_path: Optional[Path] = None
build_seconds = 0.0

# Shared engine constants, sourced from the ABI registry so the Python
# side can never restate a value the C++ side has moved away from
# (records/abi_contracts.py is the single source).
BATCH_MAX = _abi.constant("kBatchMax")
BATCH_BYTES_MAX = _abi.constant("kBatchBytesMax")
FETCH_BURST_MAX = _abi.constant("kFetchBurstMax")
MAX_FETCH_BODY = _abi.constant("kMaxFetchBody")


def compiler() -> str:
    """The host C++ compiler (``$CXX``, else ``g++``); raises if absent."""
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"C++ compiler {name!r} not found: the native engine cannot be built")
    return found


def _key(sources: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def _build_once(target: Path, cmd_of) -> float:
    """Build ``target`` unless it exists: ``cmd_of(tmp)`` is the compiler
    command writing ``tmp``.  One process builds, under an ``fcntl`` lock
    of its own for this target; the others wait and find the target.
    Returns the seconds this call spent compiling."""
    if target.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{target.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if target.exists():
                return 0.0
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            try:
                subprocess.run(cmd_of(tmp), check=True, capture_output=True,
                               text=True, timeout=BUILD_TIMEOUT_S)
                # Atomic publish: a concurrent process sees the whole file or none.
                os.replace(tmp, target)
            finally:
                if tmp.exists():
                    tmp.unlink()
            return time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _declare(lib: ctypes.CDLL) -> None:
    i64, u32, i32 = ctypes.c_int64, ctypes.c_uint32, ctypes.c_int
    lib.re_open.restype = i64
    lib.re_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u32]
    lib.re_append.restype = i64
    lib.re_append.argtypes = [i64, ctypes.POINTER(ctypes.c_float), i64]
    lib.re_flush.restype = i32
    lib.re_flush.argtypes = [i64]
    lib.re_rows.restype = i64
    lib.re_rows.argtypes = [i64]
    lib.re_close.restype = i32
    lib.re_close.argtypes = [i64]

    p8 = ctypes.POINTER(ctypes.c_uint8)
    lib.ps_open.restype = i64
    lib.ps_open.argtypes = [ctypes.c_char_p]
    lib.ps_create_task.restype = i32
    lib.ps_create_task.argtypes = [i64, ctypes.c_char_p, u32, i64]
    lib.ps_load_task.restype = i32
    lib.ps_load_task.argtypes = [i64, ctypes.c_char_p]
    lib.ps_write_piece.restype = i64
    lib.ps_write_piece.argtypes = [i64, ctypes.c_char_p, u32, p8, u32]
    lib.ps_read_piece.restype = i64
    lib.ps_read_piece.argtypes = [i64, ctypes.c_char_p, u32, p8, u32, i32]
    lib.ps_piece_count.restype = i64
    lib.ps_piece_count.argtypes = [i64, ctypes.c_char_p]
    lib.ps_piece_bitmap.restype = i32
    lib.ps_piece_bitmap.argtypes = [i64, ctypes.c_char_p, p8, u32]
    lib.ps_task_bytes.restype = i64
    lib.ps_task_bytes.argtypes = [i64, ctypes.c_char_p]
    lib.ps_piece_size.restype = i64
    lib.ps_piece_size.argtypes = [i64, ctypes.c_char_p]
    lib.ps_content_length.restype = i64
    lib.ps_content_length.argtypes = [i64, ctypes.c_char_p]
    lib.ps_delete_task.restype = i32
    lib.ps_delete_task.argtypes = [i64, ctypes.c_char_p]
    lib.ps_close.restype = i32
    lib.ps_close.argtypes = [i64]
    lib.ps_serve.restype = i64
    lib.ps_serve.argtypes = [i64, ctypes.c_char_p, ctypes.c_uint16, i32]
    lib.ps_serve_stop.restype = i32
    lib.ps_serve_stop.argtypes = [i64]
    lib.ps_serve_stats2.restype = i32
    lib.ps_serve_stats2.argtypes = [
        i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(i64), ctypes.POINTER(i64)
    ]
    lib.ps_leak_stats.restype = i32
    lib.ps_leak_stats.argtypes = [ctypes.POINTER(i64), ctypes.POINTER(i64)]

    lib.pf_open.restype = i64
    lib.pf_open.argtypes = [i64, i32, ctypes.c_char_p]
    lib.pf_parent.restype = i32
    lib.pf_parent.argtypes = [i64, i32, ctypes.c_char_p, ctypes.c_uint16]
    lib.pf_submit.restype = i32
    lib.pf_submit.argtypes = [i64, ctypes.c_char_p, i32, u32, u32]
    lib.pf_complete.restype = i32
    lib.pf_complete.argtypes = [i64, p8, i32, i32]
    lib.pf_pending.restype = i64
    lib.pf_pending.argtypes = [i64]
    lib.pf_close.restype = i32
    lib.pf_close.argtypes = [i64]

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(i64)
    f64p = ctypes.POINTER(ctypes.c_double)
    dbl = ctypes.c_double
    lib.oi_create.restype = i64
    lib.oi_create.argtypes = [ctypes.c_int32, i64, ctypes.c_int32,
                              ctypes.c_int32, dbl, i64]
    lib.oi_destroy.restype = i32
    lib.oi_destroy.argtypes = [i64]
    lib.oi_feed_download_rows.restype = i64
    lib.oi_feed_download_rows.argtypes = [i64, f32p, i64, dbl, i32]
    lib.oi_map_buckets.restype = i32
    lib.oi_map_buckets.argtypes = [i64, f32p, i64, dbl, i32p]
    lib.oi_lookup.restype = i32
    lib.oi_lookup.argtypes = [i64, f32p, i64, i32p]
    lib.oi_take_edges.restype = i64
    lib.oi_take_edges.argtypes = [i64, i64, i32p, i32p, f32p, i64]
    lib.oi_eof.restype = None
    lib.oi_eof.argtypes = [i64]
    lib.oi_node_features.restype = i32
    lib.oi_node_features.argtypes = [i64, f32p]
    lib.oi_take_recycled.restype = i64
    lib.oi_take_recycled.argtypes = [i64, i32p, i64]
    lib.oi_pending_recycled.restype = i64
    lib.oi_pending_recycled.argtypes = [i64]
    lib.oi_stats.restype = i32
    lib.oi_stats.argtypes = [i64, i64p, i64p, i64p, i64p]
    lib.oi_export_state.restype = i64
    lib.oi_export_state.argtypes = [i64, i32p, i64p, f64p, i32p, i64,
                                    f32p, f32p, i64p]
    lib.oi_import_state.restype = i32
    lib.oi_import_state.argtypes = [i64, i32p, i64p, f64p, i32p, i64,
                                    f32p, f32p, i64, i64, i64]

    # ABI manifest witness (DESIGN.md §30): df_abi_manifest returns a
    # process-lifetime static string — c_char_p is safe (no free).
    lib.df_abi_manifest.restype = ctypes.c_char_p
    lib.df_abi_manifest.argtypes = []
    lib.df_abi_probe_fetchdone.restype = ctypes.c_int32
    lib.df_abi_probe_fetchdone.argtypes = [p8, u32]


def library_target() -> Path:
    src = SOURCE_DIR / "native.cpp"
    return BUILD_DIR / f"libdragonfly_native_{_key([src], LIB_FLAGS + LINK_FLAGS)}.so"


def build_self_test(kind: str = "plain") -> Path:
    """Build ``native_test.cpp`` (which includes ``native.cpp``) as
    ``SELF_TESTS[kind]`` says; → the binary's path.  Run it with the
    environment ``SELF_TESTS[kind][1]`` adds; it prints
    ``native_test: OK`` on success."""
    flags, _env = SELF_TESTS[kind]
    srcs = [SOURCE_DIR / "native_test.cpp", SOURCE_DIR / "native.cpp"]
    target = BUILD_DIR / f"native_test_{kind}_{_key(srcs, flags + LINK_FLAGS)}"
    cxx = compiler()
    _build_once(target, lambda tmp: [cxx, *flags, "-o", str(tmp), str(srcs[0]), *LINK_FLAGS])
    return target


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None on failure
    (``build_error()`` says why)."""
    global _lib, _build_error, lib_path, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            target = library_target()
            cxx = compiler()
            src = SOURCE_DIR / "native.cpp"
            build_seconds = _build_once(
                target, lambda tmp: [cxx, *LIB_FLAGS, "-o", str(tmp), str(src), *LINK_FLAGS])
            lib = ctypes.CDLL(str(target))
            _declare(lib)
        except subprocess.CalledProcessError as exc:
            _build_error = f"g++ exited {exc.returncode}:\n{exc.stderr}"
            return None
        except (subprocess.TimeoutExpired, OSError, RuntimeError, AttributeError) as exc:
            _build_error = f"{type(exc).__name__}: {exc}"
            return None
        _lib = lib
        lib_path = target
        return _lib


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    return _build_error


def leaked_servers() -> tuple:
    """(leaked_servers, stuck_conns): process-wide wedged-shutdown counters.

    A ``ps_serve_stop`` that times out past its grace leaks the server
    struct rather than freeing memory live threads still reference; this
    surfaces the count so teardowns can ASSERT it stayed zero instead of
    scraping stderr.  (0, 0) when the library never loaded.
    """
    lib = load()
    if lib is None:
        return (0, 0)
    s = ctypes.c_int64(0)
    c = ctypes.c_int64(0)
    lib.ps_leak_stats(ctypes.byref(s), ctypes.byref(c))
    return (int(s.value), int(c.value))


# ---------------------------------------------------------------------------
# Pythonic wrappers
# ---------------------------------------------------------------------------


class NativeError(RuntimeError):
    pass


class NativeColumnarWriter:
    """Drop-in for records.columnar.ColumnarWriter backed by the C++ engine.

    Same on-disk format — ColumnarReader reads its files unchanged.
    """

    def __init__(self, path: str, columns, dtype: str = "float32"):
        if dtype != "float32":
            raise ValueError("native writer is float32-only")
        lib = load()
        if lib is None:
            raise NativeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self.path = path
        self.columns = tuple(columns)
        if os.path.exists(path) and os.path.getsize(path) > 0:
            # Same contract as the Python writer: appending to an existing
            # shard requires an identical column set (columnar.py:83-86).
            from ..records.columnar import read_header

            existing, _ = read_header(path)
            if existing.columns != self.columns:
                raise ValueError(
                    f"{path}: existing columns {existing.columns} != {self.columns}"
                )
        # The Python writer's canonical header (sorted keys), so the two
        # writers' shards are byte-equal.
        header = json.dumps(
            {"columns": list(self.columns), "dtype": "float32", "created_at_ns": 0},
            sort_keys=True,
        ).encode()
        self._h = lib.re_open(path.encode(), header, len(self.columns))
        if self._h < 0:
            raise NativeError(f"re_open({path}) -> {self._h}")

    def append(self, rows: np.ndarray) -> int:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[-1] != len(self.columns):
            raise ValueError(f"row width {rows.shape[-1]} != {len(self.columns)}")
        n = self._lib.re_append(
            self._h,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows.shape[0],
        )
        if n < 0:
            raise NativeError(f"re_append -> {n}")
        if n != rows.shape[0]:
            # Short write (disk full): silently dropped rows would corrupt
            # the shard for every downstream reader.
            raise NativeError(
                f"re_append wrote {n}/{rows.shape[0]} rows (disk full?)"
            )
        return int(n)

    def flush(self) -> None:
        self._lib.re_flush(self._h)

    def tell_rows(self) -> int:
        return int(self._lib.re_rows(self._h))

    def close(self) -> None:
        if self._h >= 0:
            self._lib.re_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativePieceStore:
    """The daemon's local piece store (C++ engine).

    Mirrors client/daemon/storage semantics: per-task metadata+data files,
    crc-verified reads, crash reload (re-open sees committed pieces).
    """

    def __init__(self, root: str):
        lib = load()
        if lib is None:
            raise NativeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self.root = root
        self._h = lib.ps_open(root.encode())
        if self._h < 0:
            raise NativeError(f"ps_open({root}) -> {self._h}")

    def create_task(self, task_id: str, piece_size: int, content_length: int) -> None:
        rc = self._lib.ps_create_task(self._h, task_id.encode(), piece_size, content_length)
        if rc != 0:
            raise NativeError(f"ps_create_task -> {rc}")

    def load_task(self, task_id: str) -> bool:
        """Open an existing task (crash reload); False if absent."""
        return self._lib.ps_load_task(self._h, task_id.encode()) == 0

    def write_piece(self, task_id: str, number: int, data: bytes) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        n = self._lib.ps_write_piece(self._h, task_id.encode(), number, buf, len(data))
        if n < 0:
            raise NativeError(f"ps_write_piece -> {n}")
        return int(n)

    def piece_size(self, task_id: str) -> int:
        return int(self._lib.ps_piece_size(self._h, task_id.encode()))

    def read_piece(self, task_id: str, number: int, *, max_len: Optional[int] = None, verify: bool = True) -> bytes:
        if max_len is None:
            # A committed piece is never longer than the task's piece size.
            ps = self.piece_size(task_id)
            max_len = ps if ps > 0 else 8 << 20
        buf = (ctypes.c_uint8 * max_len)()
        n = self._lib.ps_read_piece(
            self._h, task_id.encode(), number, buf, max_len, 1 if verify else 0
        )
        if n == -3:
            raise KeyError(f"piece {number} of {task_id} not present")
        if n == -6:
            raise NativeError(f"piece {number} of {task_id} failed crc verification")
        if n < 0:
            raise NativeError(f"ps_read_piece -> {n}")
        # string_at: one memcpy.  Slicing a ctypes array (`buf[:n]`)
        # materializes n Python ints first — measured 98 ms per 4 MiB
        # piece vs 1.8 ms for the whole python-engine read.
        return ctypes.string_at(buf, int(n))

    def piece_count(self, task_id: str) -> int:
        n = self._lib.ps_piece_count(self._h, task_id.encode())
        return max(int(n), 0)

    def piece_bitmap(self, task_id: str, n_pieces: int) -> np.ndarray:
        buf = (ctypes.c_uint8 * n_pieces)()
        rc = self._lib.ps_piece_bitmap(self._h, task_id.encode(), buf, n_pieces)
        if rc != 0:
            raise NativeError(f"ps_piece_bitmap -> {rc}")
        return np.frombuffer(bytes(buf), dtype=np.uint8)

    def task_bytes(self, task_id: str) -> int:
        return max(int(self._lib.ps_task_bytes(self._h, task_id.encode())), 0)

    def content_length(self, task_id: str) -> int:
        return int(self._lib.ps_content_length(self._h, task_id.encode()))

    def delete_task(self, task_id: str) -> None:
        self._lib.ps_delete_task(self._h, task_id.encode())

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              *, concurrent_limit: int = 64) -> int:
        """Start the in-engine HTTP piece server (native.cpp ps_serve):
        piece/bitmap/range GETs served via sendfile, no GIL on the data
        path.  Returns the bound port."""
        p = self._lib.ps_serve(self._h, host.encode(), port, concurrent_limit)
        if p < 0:
            raise NativeError(f"ps_serve -> {p}")
        return int(p)

    def serve_stop(self) -> None:
        self._lib.ps_serve_stop(self._h)

    def serve_stats(self) -> tuple:
        """(pieces_served, bytes_served) while the server runs.

        Narrow view over ``serve_stats_full`` — the legacy two-pointer
        ``ps_serve_stats`` export is gone (one out-pointer list fewer to
        keep in sync with the ABI registry)."""
        full = self.serve_stats_full()
        return full["pieces"], full["bytes"]

    def serve_stats_full(self) -> dict:
        """Extended counters: adds the batched-burst piece count and the
        live connection-thread count (ps_serve_stats2)."""
        vals = [ctypes.c_int64(0) for _ in range(4)]
        rc = self._lib.ps_serve_stats2(
            self._h, *[ctypes.byref(v) for v in vals]
        )
        if rc != 0:
            return {"pieces": 0, "bytes": 0, "batched": 0, "conns": 0}
        return {
            "pieces": int(vals[0].value),
            "bytes": int(vals[1].value),
            "batched": int(vals[2].value),
            "conns": int(vals[3].value),
        }

    def close(self) -> None:
        if self._h >= 0:
            self._lib.ps_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativePieceFetcher:
    """The in-engine piece fetch loop (pf_* in native.cpp, DESIGN.md §28).

    Python keeps scheduling ownership — it registers parents into slots,
    submits (piece, slot) pairs, and drains a bounded completion queue;
    the engine runs the pooled keep-alive fetch → length check →
    crc+fsync commit per piece with zero Python per-piece overhead.
    Every non-zero completion status simply returns the piece to the
    ordinary Python retry/hedge path (conductor fetch_one is the spec).
    """

    # native.cpp FetchDone: u32 number, i32 status, u32 length,
    # i32 parent slot, i64 cost_ns — format and size come from the ABI
    # registry (the runtime witness, utils/dfabi.py, pins both to the
    # compiled struct).
    RECORD = _abi.record_format("FetchDone")
    RECORD_SIZE = _abi.record_size("FetchDone")
    MAX_DRAIN = 256

    def __init__(self, store: "NativePieceStore", *, workers: int = 4,
                 tenant: str = ""):
        lib = load()
        if lib is None:
            raise NativeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.pf_open(store._h, workers, tenant.encode())
        if self._h < 0:
            raise NativeError(f"pf_open -> {self._h}")
        self._buf = (ctypes.c_uint8 * (self.RECORD_SIZE * self.MAX_DRAIN))()

    def set_parent(self, slot: int, ip: str, port: int) -> None:
        rc = self._lib.pf_parent(self._h, slot, ip.encode(), port)
        if rc != 0:
            raise NativeError(f"pf_parent({slot}, {ip}:{port}) -> {rc}")

    # dflint: hotpath submit
    def submit(self, task_id: str, slot: int, number: int,
               expected_len: int) -> bool:
        return self._lib.pf_submit(
            self._h, task_id.encode(), slot, number, expected_len
        ) == 0

    # dflint: hotpath complete
    def complete(self, *, timeout_ms: int = 1000) -> list:
        """Drain completions: [(number, status, length, slot, cost_ns)].
        Blocks up to timeout_ms for the first record; [] on timeout."""
        n = self._lib.pf_complete(
            self._h, self._buf, self.MAX_DRAIN, timeout_ms
        )
        if n < 0:
            raise NativeError(f"pf_complete -> {n}")
        return list(struct.iter_unpack(
            self.RECORD, ctypes.string_at(self._buf, n * self.RECORD_SIZE)
        ))

    def pending(self) -> int:
        return max(int(self._lib.pf_pending(self._h)), 0)

    def close(self) -> None:
        """Release the engine handle.  Queued (not yet in-flight) jobs
        are DISCARDED, not fetched — by the time the conductor closes,
        its window deadline has already routed unfinished pieces to the
        Python retry path, so close never stalls on a wedged parent."""
        if self._h >= 0:
            self._lib.pf_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _lp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeOnlineIngest:
    """The wire→trainer hot path in C++ (oi_* in native.cpp): bucket→id
    mapping with the TTL lifecycle, host-feature accumulation, and the
    dispatch-block edge ring — one GIL-free call per wire chunk.
    ``trainer.online_graph.WireIngestAdapter`` is the semantic spec and
    delegates here when the library is available."""

    def __init__(self, num_nodes: int, n_buckets: int, feat_dim: int,
                 row_width: int, node_ttl: float, ring_capacity: int):
        lib = load()
        if lib is None:
            raise NativeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self.num_nodes = int(num_nodes)
        self.n_buckets = int(n_buckets)
        self.feat_dim = int(feat_dim)
        self.row_width = int(row_width)
        self._h = lib.oi_create(num_nodes, n_buckets, feat_dim, row_width,
                                float(node_ttl), ring_capacity)
        if self._h < 0:
            raise NativeError(f"oi_create -> {self._h}")

    def feed_download_rows(self, rows: np.ndarray, now: float,
                           *, block: bool = True) -> int:
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.row_width:
            # The engine strides by ITS row_width — a mismatched shape
            # would be an out-of-bounds read, not an error.
            raise NativeError(
                f"rows shape {rows.shape} != [n, {self.row_width}]"
            )
        kept = self._lib.oi_feed_download_rows(
            self._h, _fp(rows), rows.shape[0], now, 1 if block else 0
        )
        if kept < 0:
            raise NativeError(f"oi_feed_download_rows -> {kept}")
        return int(kept)

    def map_buckets(self, buckets: np.ndarray, now: float) -> np.ndarray:
        b = np.ascontiguousarray(buckets, np.float32)
        out = np.empty(len(b), np.int32)
        rc = self._lib.oi_map_buckets(self._h, _fp(b), len(b), now, _ip(out))
        if rc != 0:
            raise NativeError(f"oi_map_buckets -> {rc}")
        return out

    def lookup(self, buckets: np.ndarray) -> np.ndarray:
        """Read-only mapping probe — never allocates ids."""
        b = np.ascontiguousarray(buckets, np.float32)
        out = np.empty(len(b), np.int32)
        rc = self._lib.oi_lookup(self._h, _fp(b), len(b), _ip(out))
        if rc != 0:
            raise NativeError(f"oi_lookup -> {rc}")
        return out

    def take_edges(self, need: int, timeout_s: float):
        """Exactly-`need` edges as (src, dst, y), or None on timeout/EOF
        with fewer than `need` buffered."""
        src = np.empty(need, np.int32)
        dst = np.empty(need, np.int32)
        y = np.empty(need, np.float32)
        got = self._lib.oi_take_edges(
            self._h, need, _ip(src), _ip(dst), _fp(y),
            max(int(timeout_s * 1000), 0),
        )
        if got < 0:
            raise NativeError(f"oi_take_edges -> {got}")
        if got == 0:
            return None
        return src, dst, y

    def eof(self) -> None:
        self._lib.oi_eof(self._h)

    def node_features(self) -> np.ndarray:
        out = np.empty((self.num_nodes, self.feat_dim), np.float32)
        rc = self._lib.oi_node_features(self._h, _fp(out))
        if rc != 0:
            raise NativeError(f"oi_node_features -> {rc}")
        return out

    def take_recycled(self, cap: int = 65536) -> np.ndarray:
        out = np.empty(cap, np.int32)
        n = self._lib.oi_take_recycled(self._h, _ip(out), cap)
        if n < 0:
            raise NativeError(f"oi_take_recycled -> {n}")
        return out[:n].copy()

    def pending_recycled(self) -> int:
        return int(self._lib.oi_pending_recycled(self._h))

    def stats(self) -> dict:
        vals = [ctypes.c_int64(0) for _ in range(4)]
        rc = self._lib.oi_stats(self._h, *[ctypes.byref(v) for v in vals])
        if rc != 0:
            raise NativeError(f"oi_stats -> {rc}")
        return {
            "overflow_edges": vals[0].value,
            "evicted_nodes": vals[1].value,
            "next_id": vals[2].value,
            "rows_in": vals[3].value,
        }

    def export_state(self):
        """Snapshot the mapping for a checkpoint; None while recycled ids
        still await their embedding-row reset (caller drains + retries)."""
        id_table = np.empty(self.n_buckets, np.int32)
        bucket_of = np.empty(self.num_nodes, np.int64)
        last_seen = np.empty(self.num_nodes, np.float64)
        free = np.empty(self.num_nodes, np.int32)
        feat_sum = np.empty((self.num_nodes, self.feat_dim), np.float32)
        feat_cnt = np.empty(self.num_nodes, np.float32)
        scalars = np.zeros(3, np.int64)
        n = self._lib.oi_export_state(
            self._h, _ip(id_table), _lp(bucket_of), _dp(last_seen),
            _ip(free), self.num_nodes, _fp(feat_sum), _fp(feat_cnt),
            _lp(scalars),
        )
        if n == -1:
            return None
        if n < 0:
            raise NativeError(f"oi_export_state -> {n}")
        return {
            "id_table": id_table,
            "bucket_of": bucket_of,
            "last_seen": last_seen,
            "free": free[:n].copy(),
            "feat_sum": feat_sum,
            "feat_cnt": feat_cnt,
            "next_id": int(scalars[0]),
            "overflow_edges": int(scalars[1]),
            "evicted_nodes": int(scalars[2]),
        }

    def import_state(self, id_table, bucket_of, last_seen, free,
                     feat_sum, feat_cnt, next_id, overflow, evicted) -> None:
        id_table = np.ascontiguousarray(id_table, np.int32)
        bucket_of = np.ascontiguousarray(bucket_of, np.int64)
        last_seen = np.ascontiguousarray(last_seen, np.float64)
        free = np.ascontiguousarray(free, np.int32)
        feat_sum = np.ascontiguousarray(feat_sum, np.float32)
        feat_cnt = np.ascontiguousarray(feat_cnt, np.float32)
        # The engine memcpys its OWN sizes out of these buffers — a
        # shape mismatch would be an out-of-bounds read, not an error.
        if (
            len(id_table) != self.n_buckets
            or len(bucket_of) != self.num_nodes
            or len(last_seen) != self.num_nodes
            or len(feat_cnt) != self.num_nodes
            or feat_sum.size != self.num_nodes * self.feat_dim
        ):
            raise NativeError(
                f"import_state shape mismatch: engine has num_nodes="
                f"{self.num_nodes}/n_buckets={self.n_buckets}"
            )
        rc = self._lib.oi_import_state(
            self._h, _ip(id_table), _lp(bucket_of), _dp(last_seen),
            _ip(free), len(free), _fp(feat_sum), _fp(feat_cnt),
            int(next_id), int(overflow), int(evicted),
        )
        if rc != 0:
            raise NativeError(
                f"oi_import_state -> {rc} (corrupt adapter state?)"
            )

    def close(self) -> None:
        if self._h >= 0:
            self._lib.oi_destroy(self._h)
            self._h = -1

    def __del__(self):  # belt & suspenders; close() is the contract
        try:
            self.close()
        except Exception:  # dflint: disable=DF001 — __del__ during
            pass          # interpreter teardown must never raise or log
