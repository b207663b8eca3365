"""Native ABI contracts: the boundary of the port's native engine,
declared once.

The native host engine crosses a C ABI: ``native/src/native.cpp``
exports ~43 ``extern "C"`` symbols that the ctypes table in
``native/__init__.py`` binds, plus packed records (the 24-byte FetchDone
completion, the piece-store metadata/header layouts) and shared
constants (batch caps, status codes, wire magics) that both sides
restate.  Drift on either side compiles clean and corrupts memory at
runtime, so this registry is the single declaration of that boundary:

- ``native/__init__.py`` and ``rpc/piece_transport.py`` read their
  shared constants and the FetchDone format from it instead of restating
  literals;
- ``utils/dfabi.py`` renders it as canonical JSON and diffs it against
  the compiled library's ``df_abi_manifest()`` (an X-macro table inside
  native.cpp: prototype strings, compiler-computed ``sizeof`` /
  ``offsetof`` of every declared record, constant values), so a
  compiler or padding surprise fails even when both source texts agree
  (``tests/test_torch_native_engine.py`` requires byte equality).

Port of ``dragonfly2_tpu/records/abi_contracts.py``: the same registry,
with the file names of the port's own library and bindings.

Canonical type vocabulary (shared by this registry and the C++ alias
table inside native.cpp's manifest section; ``const`` is dropped on both
sides before comparison):

    void  i32(int/int32_t)  i64  u16  u32  f64(double)  cstr(char*)
    u8p  f32p  i32p  i64p  f64p

Keep ``ABI_CONTRACTS`` a pure literal: one dict, no computed entries.
"""

from __future__ import annotations

ABI_CONTRACTS = {
    # -- library geography ---------------------------------------------------
    "library": {
        "source": "dragonfly2_tpu_torch/native/src/native.cpp",
        "bindings": "dragonfly2_tpu_torch/native/__init__.py",
    },
    # -- exported symbols ----------------------------------------------------
    # symbol -> [return, *params] in the canonical type vocabulary.  The
    # C side must define exactly these prototypes inside `extern "C"`
    # blocks; the ctypes side must declare exactly these restype/argtypes.
    "exports": {
        # record engine (DFC1 columnar append)
        "re_open": ["i64", "cstr", "cstr", "u32"],
        "re_append": ["i64", "i64", "f32p", "i64"],
        "re_flush": ["i32", "i64"],
        "re_rows": ["i64", "i64"],
        "re_close": ["i32", "i64"],
        # piece store (per-task {meta,data} pairs, crash reload)
        "ps_open": ["i64", "cstr"],
        "ps_create_task": ["i32", "i64", "cstr", "u32", "i64"],
        "ps_load_task": ["i32", "i64", "cstr"],
        "ps_write_piece": ["i64", "i64", "cstr", "u32", "u8p", "u32"],
        "ps_read_piece": ["i64", "i64", "cstr", "u32", "u8p", "u32", "i32"],
        "ps_piece_count": ["i64", "i64", "cstr"],
        "ps_piece_bitmap": ["i32", "i64", "cstr", "u8p", "u32"],
        "ps_task_bytes": ["i64", "i64", "cstr"],
        "ps_content_length": ["i64", "i64", "cstr"],
        "ps_piece_size": ["i64", "i64", "cstr"],
        "ps_delete_task": ["i32", "i64", "cstr"],
        # in-engine HTTP piece server
        "ps_serve": ["i64", "i64", "cstr", "u16", "i32"],
        "ps_serve_stop": ["i32", "i64"],
        "ps_serve_stats2": ["i32", "i64", "i64p", "i64p", "i64p", "i64p"],
        "ps_leak_stats": ["i32", "i64p", "i64p"],
        "ps_close": ["i32", "i64"],
        # in-engine piece fetch loop (client half)
        "pf_open": ["i64", "i64", "i32", "cstr"],
        "pf_parent": ["i32", "i64", "i32", "cstr", "u16"],
        "pf_submit": ["i32", "i64", "cstr", "i32", "u32", "u32"],
        "pf_complete": ["i32", "i64", "u8p", "i32", "i32"],
        "pf_pending": ["i64", "i64"],
        "pf_close": ["i32", "i64"],
        # online ingest engine (wire -> trainer hot path)
        "oi_create": ["i64", "i32", "i64", "i32", "i32", "f64", "i64"],
        "oi_feed_download_rows": ["i64", "i64", "f32p", "i64", "f64", "i32"],
        "oi_map_buckets": ["i32", "i64", "f32p", "i64", "f64", "i32p"],
        "oi_lookup": ["i32", "i64", "f32p", "i64", "i32p"],
        "oi_take_edges": ["i64", "i64", "i64", "i32p", "i32p", "f32p", "i64"],
        "oi_eof": ["void", "i64"],
        "oi_node_features": ["i32", "i64", "f32p"],
        "oi_take_recycled": ["i64", "i64", "i32p", "i64"],
        "oi_pending_recycled": ["i64", "i64"],
        "oi_stats": ["i32", "i64", "i64p", "i64p", "i64p", "i64p"],
        "oi_export_state": [
            "i64", "i64", "i32p", "i64p", "f64p", "i32p", "i64",
            "f32p", "f32p", "i64p",
        ],
        "oi_import_state": [
            "i32", "i64", "i32p", "i64p", "f64p", "i32p", "i64",
            "f32p", "f32p", "i64", "i64", "i64",
        ],
        "oi_destroy": ["i32", "i64"],
        # ABI witness probes (DESIGN.md §30)
        "df_abi_manifest": ["cstr"],
        "df_abi_probe_fetchdone": ["i32", "u8p", "u32"],
    },
    # -- packed records crossing the boundary --------------------------------
    # Every struct inside a `#pragma pack(push, 1)` region in native.cpp
    # must appear here with its exact field order; offsets/total size are
    # derived (pack(1) => no padding) and cross-checked against the
    # compiler's sizeof/offsetof through the manifest witness.  A
    # `py_struct` entry pins the ctypes-side mirror: the named class
    # attributes must be derived via record_format()/record_size() below.
    "records": {
        "FetchDone": {
            "fields": [
                ["number", "u32"],
                ["status", "i32"],
                ["length", "u32"],
                ["slot", "i32"],
                ["cost_ns", "i64"],
            ],
            "size": 24,
            "py_struct": {
                "qual": "NativePieceFetcher",
                "fmt_attr": "RECORD",
                "size_attr": "RECORD_SIZE",
            },
        },
        "PieceMeta": {
            "fields": [
                ["number", "u32"],
                ["length", "u32"],
                ["offset", "i64"],
                ["crc", "u32"],
                ["flags", "u32"],
            ],
            "size": 24,
        },
        "TaskHeader": {
            "fields": [
                ["magic", "char4"],
                ["piece_size", "u32"],
                ["content_length", "i64"],
            ],
            "size": 16,
        },
    },
    # -- shared constants ----------------------------------------------------
    # name -> value.  The C side must declare `constexpr <int> kName = v`
    # (or `constexpr char kName[] = "v"` for the wire magics) at
    # namespace scope with exactly this value; the manifest witness
    # re-emits the compiled values.
    "constants": {
        # batched submission / pipelining caps (server burst + client window)
        "kBatchMax": 16,
        "kBatchBytesMax": 524288,
        "kFetchBurstMax": 8,
        "kMaxFetchBody": 67108864,
        # worker / slot / serving caps
        "kFetchWorkersDefault": 4,
        "kFetchWorkersMax": 64,
        "kParentSlotMax": 255,
        "kServeLimitDefault": 64,
        "kLongPollMaxMs": 30000,
        # FetchDone.status codes (0 ok, >0 HTTP passthrough, negatives below)
        "kFetchStatusOk": 0,
        "kFetchStatusConn": -1,
        "kFetchStatusProto": -2,
        "kFetchStatusCommit": -3,
        # catch-all containment sentinel: any extern "C" accessor that
        # swallows an exception returns this
        "kAbiTrap": -125,
        # PieceMeta.flags bits
        "kPieceFlagCommitted": 1,
        "kPieceFlagVerified": 2,
        # wire magics
        "kMagic": "DFC1",
        "kTaskMagic": "DFPS",
    },
    # -- Python-side constant mirrors ----------------------------------------
    # Module-level attributes that restate a shared constant; each is
    # derived through constant() below (the reference's DF020 lint checks
    # its own package's mirrors; tests/test_torch_native_engine.py holds
    # the port's).
    "constant_mirrors": [
        {
            "constant": "kMagic",
            "file": "dragonfly2_tpu_torch/records/columnar.py",
            "attr": "MAGIC",
            "kind": "bytes",
        },
        {
            "constant": "kLongPollMaxMs",
            "file": "dragonfly2_tpu_torch/rpc/piece_transport.py",
            "attr": "LONG_POLL_MAX_MS",
            "kind": "int",
        },
        {
            "constant": "kBatchBytesMax",
            "file": "dragonfly2_tpu_torch/native/__init__.py",
            "attr": "BATCH_BYTES_MAX",
            "kind": "int",
        },
        {
            "constant": "kBatchMax",
            "file": "dragonfly2_tpu_torch/native/__init__.py",
            "attr": "BATCH_MAX",
            "kind": "int",
        },
        {
            "constant": "kFetchBurstMax",
            "file": "dragonfly2_tpu_torch/native/__init__.py",
            "attr": "FETCH_BURST_MAX",
            "kind": "int",
        },
        {
            "constant": "kMaxFetchBody",
            "file": "dragonfly2_tpu_torch/native/__init__.py",
            "attr": "MAX_FETCH_BODY",
            "kind": "int",
        },
    ],
    # -- out-pointer stats field order ---------------------------------------
    # Multi-out-pointer stats exports: the declared field order IS the
    # ABI: `py_builder` names the bindings method whose dict carries
    # exactly these keys in this order (held through a real serve by
    # tests/test_torch_native_engine.py).
    "stats_fields": {
        "ps_serve_stats2": {
            "fields": ["pieces", "bytes", "batched", "conns"],
            "py_builder": "NativePieceStore.serve_stats_full",
        },
        "oi_stats": {
            "fields": ["overflow_edges", "evicted_nodes", "next_id", "rows_in"],
            "py_builder": "NativeOnlineIngest.stats",
        },
        "ps_leak_stats": {
            "fields": ["servers", "conns"],
        },
    },
    # -- handle-lifetime discipline ------------------------------------------
    # Which export families hold their objects through the shared_ptr
    # registry pattern (a caller blocked inside the object keeps it alive
    # across a concurrent close) vs raw pointers with explicit
    # leak-on-wedge accounting, as native.cpp declares them.
    "handle_families": {
        "re_": {"registry": "g_records", "lifetime": "shared_ptr"},
        "ps_": {"registry": "g_stores", "lifetime": "raw"},
        "pf_": {"registry": "g_fetchers", "lifetime": "shared_ptr"},
        "oi_": {"registry": "g_oi", "lifetime": "shared_ptr"},
        "df_": {"registry": None, "lifetime": "stateless"},
    },
}

# ---------------------------------------------------------------------------
# Accessor helpers.  The ctypes bindings and wire-constant mirrors read
# through these instead of restating literals, so there is one value.
# ---------------------------------------------------------------------------

_FIELD_SIZES = {
    "u8": 1, "i8": 1, "u16": 2, "i16": 2, "u32": 4, "i32": 4,
    "u64": 8, "i64": 8, "f32": 4, "f64": 8, "char4": 4,
}

_FIELD_FMT = {
    "u8": "B", "i8": "b", "u16": "H", "i16": "h", "u32": "I", "i32": "i",
    "u64": "Q", "i64": "q", "f32": "f", "f64": "d", "char4": "4s",
}


def constant(name: str):
    """Shared-constant value by C-side name (e.g. ``kBatchBytesMax``)."""
    return ABI_CONTRACTS["constants"][name]


def record_fields(name: str):
    """[(field, ctype, offset, size), ...] for a declared packed record."""
    out = []
    offset = 0
    for fname, ctype in ABI_CONTRACTS["records"][name]["fields"]:
        size = _FIELD_SIZES[ctype]
        out.append((fname, ctype, offset, size))
        offset += size
    return out


def record_size(name: str) -> int:
    """Declared total size of a packed record (cross-checked: the field
    sizes must sum to it — the witness asserts the compiler agrees)."""
    return ABI_CONTRACTS["records"][name]["size"]


def record_format(name: str) -> str:
    """``struct`` format string (little-endian, packed) for a record."""
    return "<" + "".join(
        _FIELD_FMT[ctype] for _, ctype in ABI_CONTRACTS["records"][name]["fields"]
    )


def expected_manifest(contracts=None) -> dict:
    """The manifest ``df_abi_manifest()`` must emit, as a Python object.

    Shape (mirrored by the X-macro emission in native.cpp):
    ``{"constants": {...}, "exports": {name: [ret, *args]},
    "records": {name: {"fields": [[fname, offset, size], ...],
    "size": N}}, "version": 1}``.
    """
    c = ABI_CONTRACTS if contracts is None else contracts
    records = {}
    for rname, spec in c["records"].items():
        fields = []
        offset = 0
        for fname, ctype in spec["fields"]:
            size = _FIELD_SIZES[ctype]
            fields.append([fname, offset, size])
            offset += size
        records[rname] = {"fields": fields, "size": spec["size"]}
    return {
        "constants": dict(c["constants"]),
        "exports": {k: list(v) for k, v in c["exports"].items()},
        "records": records,
        "version": 1,
    }


def manifest_json(contracts=None) -> str:
    """Canonical JSON bytes of :func:`expected_manifest` — the exact
    string ``df_abi_manifest()`` must return (sorted keys, compact
    separators; field lists stay in declaration order)."""
    import json

    return json.dumps(
        expected_manifest(contracts), sort_keys=True, separators=(",", ":")
    )
