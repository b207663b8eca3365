"""Runtime ABI witness: the port's compiled native library against its
declared contracts.

Text agreement between ``records/abi_contracts.py``, ``native.cpp`` and
the ctypes bindings can still lie about what the compiler did: a padding
surprise, an ABI-breaking flag, or a stale library whose symbols predate
the sources.  This module closes that loop:

- ``native.cpp`` carries a ``DF_ABI_EXPORTS`` X-macro table expanded
  into per-symbol ``static_assert``s and a ``df_abi_manifest()`` export
  that emits canonical JSON — prototype table, compiler-computed
  ``sizeof``/``offsetof`` for every packed record, compiled constant
  values — byte-compatible with Python's ``json.dumps(...,
  sort_keys=True, separators=(",", ":"))``;
- this module renders the same canonical JSON from
  ``records/abi_contracts.py`` and diffs the two, and round-trips a
  sentinel FetchDone record through ``df_abi_probe_fetchdone()`` (a
  memcpy of the compiled struct, every field distinguishable).

``tests/test_torch_native_engine.py`` calls ``compare`` and
``probe_fetchdone`` directly.  ``install`` / ``armed`` keep the
reference's interface (its test configuration arms the witness); nothing
in the port arms it.  Where the library is unavailable the witness
reports exactly that instead of failing.

Port of ``dragonfly2_tpu/utils/dfabi.py``, verbatim but for this
docstring: it reads the port's registry and loads the port's library.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional

_ARMED = False
_ROOT: Optional[str] = None

# The sentinel df_abi_probe_fetchdone() fills: every field carries a
# value distinguishable by position AND width, so a swapped or widened
# field cannot round-trip clean.  status deliberately reuses a registry
# status constant so one real enum value crosses the boundary too.
PROBE_SENTINEL = {
    "number": 0xA1B2C3D4,
    "status": -2,  # kFetchStatusProto
    "length": 0x00C0FFEE,
    "slot": -7,
    "cost_ns": 0x0102030405060708,
}


def install(root: str) -> None:
    global _ARMED, _ROOT
    _ARMED = True
    _ROOT = root


def armed() -> bool:
    return _ARMED


def expected_manifest() -> dict:
    """The manifest the compiled library must emit, from the registry."""
    from ..records import abi_contracts

    return abi_contracts.expected_manifest()


def expected_manifest_bytes() -> bytes:
    from ..records import abi_contracts

    return abi_contracts.manifest_json().encode()


def live_manifest_bytes() -> Optional[bytes]:
    """``df_abi_manifest()`` from the loaded library; None when the
    native library is unavailable or predates the witness export."""
    from .. import native

    lib = native.load()
    if lib is None:
        return None
    raw = lib.df_abi_manifest()
    return None if raw is None else bytes(raw)


def diff_manifests(expected: dict, live: dict) -> List[str]:
    """Human-readable gaps between two manifest objects, keyed the way
    DF020 keys its findings (symbol/field/constant names) so a witness
    failure and a static failure for the same drift read the same."""
    gaps: List[str] = []
    for section in ("constants", "exports", "records"):
        want = expected.get(section, {})
        got = live.get(section, {})
        for name in sorted(set(want) | set(got)):
            if name not in got:
                gaps.append(f"{section}: {name} missing from the compiled "
                            f"manifest (stale .so?)")
            elif name not in want:
                gaps.append(f"{section}: {name} in the compiled manifest but "
                            f"not declared in records/abi_contracts.py")
            elif want[name] != got[name]:
                gaps.append(f"{section}: {name} declared {want[name]!r} but "
                            f"compiled {got[name]!r}")
    if expected.get("version") != live.get("version"):
        gaps.append(f"version: declared {expected.get('version')!r} vs "
                    f"compiled {live.get('version')!r}")
    return gaps


def compare(
    expected_bytes: Optional[bytes] = None,
    live_bytes: Optional[bytes] = None,
) -> List[str]:
    """Gap descriptions between registry and compiled manifest.  Empty
    list == witness green.  Both sides overridable so the gap fixtures
    (doctored manifest, stale registry) exercise the real comparator."""
    if expected_bytes is None:
        expected_bytes = expected_manifest_bytes()
    if live_bytes is None:
        live_bytes = live_manifest_bytes()
    if live_bytes is None:
        return ["native library unavailable (or df_abi_manifest missing) — "
                "witness cannot run"]
    try:
        live = json.loads(live_bytes.decode())
    except (ValueError, UnicodeDecodeError) as exc:
        return [f"compiled manifest is not valid JSON: {exc}"]
    gaps = diff_manifests(json.loads(expected_bytes.decode()), live)
    if not gaps and expected_bytes != live_bytes:
        # same object, different bytes: the C++ emitter broke canonical
        # form (key order / separators) — the byte contract is the spec
        gaps.append("manifest objects match but bytes differ — the C++ "
                    "emitter no longer produces canonical JSON")
    return gaps


def probe_fetchdone() -> Optional[Dict[str, int]]:
    """Round-trip the sentinel FetchDone: fields unpacked with the
    registry's struct format.  None when the library is unavailable."""
    import ctypes

    from .. import native
    from ..records import abi_contracts

    lib = native.load()
    if lib is None:
        return None
    size = abi_contracts.record_size("FetchDone")
    buf = (ctypes.c_uint8 * (size * 2))()  # slack: a size drift still lands
    n = lib.df_abi_probe_fetchdone(buf, len(buf))
    if n < 0:
        return None
    values = struct.unpack_from(
        abi_contracts.record_format("FetchDone"), bytes(buf), 0
    )
    fields = [f for f, _t in
              abi_contracts.ABI_CONTRACTS["records"]["FetchDone"]["fields"]]
    out = dict(zip(fields, values))
    out["__returned_size__"] = int(n)
    return out
