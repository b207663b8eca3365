"""Shared RFC-7233 byte-range parsing (DESIGN.md §25).

Three HTTP surfaces serve byte ranges — the upload piece server's
``/tasks/<id>`` endpoint, the dfdaemon forward proxy, and the object
gateway — and before this module each parsed ``Range:`` headers with its
own inline arithmetic, which is exactly how the three drift apart one
edge case at a time.  ``parse_range`` is the single owner of the RFC's
shapes, and the conformance sweep (tests/test_stream_tee.py) proves the
three surfaces byte-identical through it.

Contract (single-range ``bytes=`` specs, the shapes real clients send):

- ``bytes=S-E``  → ``(S, min(E, total-1))``; ``S > E`` is syntactically
  invalid → ``None`` (RFC 7233 §3.1: ignore the header, serve 200);
- ``bytes=S-``   → ``(S, total-1)`` (open-ended);
- ``bytes=-N``   → the final N bytes; ``N >= total`` clamps to the whole
  representation; ``N == 0`` is unsatisfiable → 416;
- ``S >= total`` → :class:`RangeNotSatisfiable` (416 with
  ``Content-Range: bytes */total``);
- a missing/foreign-unit/multi-range header → ``None`` (callers serve
  the full 200 body; multi-range responses are out of scope here, and
  ignoring is RFC-legal).

Callers that REQUIRE a range (the piece server's task endpoint has no
un-ranged read) map ``None`` to 416 themselves — that strictness is the
endpoint's contract, not the parser's.

Port of ``dragonfly2_tpu/utils/httprange.py``, verbatim.
"""

from __future__ import annotations

from typing import Optional, Tuple


class RangeNotSatisfiable(ValueError):
    """The range is syntactically valid but lies past EOF (HTTP 416).
    Carries ``total`` for the ``Content-Range: bytes */total`` answer."""

    def __init__(self, spec: str, total: int) -> None:
        super().__init__(f"range {spec!r} not satisfiable (total {total})")
        self.total = total


def parse_range(header: Optional[str], total: int) -> Optional[Tuple[int, int]]:
    """``Range`` header + representation length → inclusive
    ``(start, end)`` byte positions, ``None`` when the request is not a
    servable single byte range (serve the full body), or
    :class:`RangeNotSatisfiable` (answer 416).

    ``total`` must be the representation's byte length; ``total <= 0``
    has no satisfiable range at all.
    """
    if not header or not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):].strip()
    if "," in spec or "-" not in spec:
        # Multi-range (or garbage): we only serve single ranges —
        # ignoring the header is the RFC-sanctioned degrade.
        return None
    start_s, _, end_s = spec.partition("-")
    start_s, end_s = start_s.strip(), end_s.strip()
    try:
        if start_s == "":
            if not end_s.isdigit():
                return None                # bytes=--5 etc.: malformed
            suffix = int(end_s)            # bytes=-N: the final N bytes
            if suffix <= 0 or total <= 0:
                # bytes=-0 is syntactically valid but has no bytes.
                raise RangeNotSatisfiable(header, max(total, 0))
            return (max(total - suffix, 0), total - 1)
        start = int(start_s)
        if start < 0:
            return None
        if total <= 0 or start >= total:
            raise RangeNotSatisfiable(header, max(total, 0))
        if end_s == "":
            return (start, total - 1)      # bytes=S-: open-ended
        end = int(end_s)
        if end < start:
            return None                    # invalid spec → ignore (200)
        return (start, min(end, total - 1))
    except ValueError as exc:
        if isinstance(exc, RangeNotSatisfiable):
            raise
        return None                        # non-numeric → ignore (200)


def content_range(start: int, end: int, total: int) -> str:
    """The 206 response's ``Content-Range`` value."""
    return f"bytes {start}-{end}/{total}"


def unsatisfiable_content_range(total: int) -> str:
    """The 416 response's ``Content-Range`` value."""
    return f"bytes */{total}"
