"""Crash-safe metric journal: the flight recorder's discipline (§21)
applied to metrics (DESIGN.md §23).

Every process appends periodic snapshots of its counter/gauge/sketch
state — plus its process/run identity — to an append-only journal of
length-prefixed, crc32-digest-checked frames:

    b"DFMJ1 <payload_len> <crc32 payload, 8 hex>\n" + payload + b"\n"

Each frame is ONE ``os.write`` on an O_APPEND fd (the kernel serializes
appends), so a SIGKILL costs at most the in-flight frame at the tail.
The replayer follows the DFTL1 rules (utils/tracing.replay_trace_log):
tolerate the torn tail, resync past mid-file truncation, and NEVER
admit a digest-bad frame.

Snapshots are CUMULATIVE (the full registry state, not deltas): the
last admitted frame of a run is that run's final word, so a dead
process's journal is exactly as useful as a live one's ``/metrics``
scrape was.  ``run_id`` gives restart/reset detection its identity —
``tools/fleet_assemble.py`` sums counters per run and merges sketches
losslessly across every run of every process.

Wired into all four binaries next to ``--trace-log``
(``--metric-journal`` / config ``telemetry.journal_path``).

Port of ``dragonfly2_tpu/utils/metric_journal.py``, with the logic
verbatim over this package's own metrics registry.  The DFMJ1 frames are
the reference's byte for byte, so either package replays the other's
journal.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .metrics import Registry, default_registry
from .tracing import _raw_lock

FRAME_MAGIC = b"DFMJ1 "

SNAPSHOT_VERSION = 1


def encode_frame(snapshot: Dict[str, Any]) -> bytes:
    """One canonical DFMJ1 frame for ``snapshot`` — the declared DFMJ1
    artifact writer of DESIGN.md §27.  ``sort_keys=True`` is
    load-bearing: replay byte-identity (and the different-PYTHONHASHSEED
    dual-run drill) holds only while equal snapshots serialize to equal
    bytes regardless of dict insertion/hash order."""
    payload = json.dumps(snapshot, sort_keys=True).encode()
    return (
        FRAME_MAGIC
        + f"{len(payload)} {zlib.crc32(payload) & 0xFFFFFFFF:08x}\n".encode()
        + payload
        + b"\n"
    )


class MetricJournal:
    """Per-process append-only metric journal.

    ``start()`` runs a background snapshot thread every ``interval_s``;
    ``write_snapshot()`` appends one immediately (shutdown hooks, tests,
    drills).  Write failures are counted in ``dropped``, never raised —
    observability must not crash the plane.  The bookkeeping lock comes
    from dflock's REAL factory (the exporter precedent): diagnostics
    must not instrument diagnostics.
    """

    def __init__(
        self,
        path: str,
        *,
        registry: Optional[Registry] = None,
        service: str = "dragonfly",
        interval_s: float = 10.0,
        run_id: Optional[str] = None,
        fsync: bool = False,
    ) -> None:
        import atexit

        self.path = path
        self.registry = registry if registry is not None else default_registry
        self.service = service
        self.interval_s = max(0.05, float(interval_s))
        self.run_id = run_id or uuid.uuid4().hex
        self.fsync = fsync
        self.written = 0
        self.dropped = 0
        # Payload of the most recent write_snapshot (None before the
        # first) — the autopilot's live ingest source.
        self.last_snapshot = None
        # Optional callable(snapshot_dict) invoked after each cadence
        # write (qos/autopilot.py rides the journal's clock: its live
        # input IS the frame replay will read back).  Exceptions are
        # swallowed with a log — a consumer bug must not stop journaling.
        self.on_snapshot = None
        self._seq = 0
        self._closed = False
        self._mu = _raw_lock()
        self._fd: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        atexit.register(self.close)

    # -- writing -------------------------------------------------------------

    def _payload(self) -> Dict[str, Any]:
        with self._mu:
            self._seq += 1
            seq = self._seq
        return {
            "v": SNAPSHOT_VERSION,
            "service": self.service,
            "run_id": self.run_id,
            "pid": os.getpid(),
            "seq": seq,
            "ts": time.time(),
            "metrics": self.registry.snapshot(),
        }

    def write_snapshot(self) -> bool:
        """Append one cumulative snapshot frame; False = write failed
        (counted in ``dropped``).  The frame's payload stays readable on
        ``last_snapshot`` — the SLO autopilot's live loop ingests the
        SAME dict replay will read back off disk (qos/autopilot.py), so
        live decisions and journal replay are identical by construction.
        """
        from . import faultinject

        snapshot = self._payload()
        self.last_snapshot = snapshot
        frame = encode_frame(snapshot)
        # Chaos seam: a ``crash`` fault here SIGKILLs the process at a
        # deterministic journal write — the telemetry kill drill's
        # "mid-storm, mid-journal" point (sim/telemetry.py).
        faultinject.fire("metrics.journal.write")
        with self._mu:
            try:
                if self._fd is None:
                    self._fd = os.open(
                        self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
                    )
                os.write(self._fd, frame)
                if self.fsync:
                    os.fsync(self._fd)
                self.written += 1
                return True
            except OSError:
                self.dropped += 1
                return False

    # -- background cadence --------------------------------------------------

    def start(self) -> "MetricJournal":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="metric-journal", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        # Bounded waits (DF008 timeout sweep): the stop event doubles as
        # the cadence clock, so close() never waits out a full interval.
        while not self._stop.wait(self.interval_s):
            if self.write_snapshot():
                sink = self.on_snapshot
                if sink is not None:
                    try:
                        sink(self.last_snapshot)
                    except Exception:  # noqa: BLE001 — consumer bug ≠ journal outage
                        import logging

                        logging.getLogger(__name__).exception(
                            "metric-journal snapshot consumer failed"
                        )

    def close(self) -> None:
        """Stop the cadence thread, write the final snapshot, close the
        fd.  Idempotent (atexit + explicit shutdown both call it)."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            while t.is_alive():
                t.join(5.0)
                break
        with self._mu:
            if self._closed:
                return
            self._closed = True
        self.write_snapshot()
        with self._mu:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Replay (DFTL1 rules: torn tail tolerated, digest-bad never admitted)
# ---------------------------------------------------------------------------


def replay_metric_journal(
    path: str,
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Replay a metric journal → (snapshots, stats).

    Stats: ``frames`` admitted, ``corrupt`` frames rejected by digest or
    JSON decode (NEVER admitted), ``torn_tail`` True when the file ends
    inside a frame — the expected SIGKILL signature, tolerated."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], {"frames": 0, "corrupt": 0, "torn_tail": False}
    snapshots: List[Dict[str, Any]] = []
    corrupt = 0
    torn = False
    pos = 0
    while True:
        idx = data.find(FRAME_MAGIC, pos)
        if idx < 0:
            break
        nl = data.find(b"\n", idx)
        if nl < 0:
            torn = True  # header itself torn at the tail
            break
        header = data[idx + len(FRAME_MAGIC) : nl]
        try:
            len_s, crc_s = header.split()
            length, crc = int(len_s), int(crc_s, 16)
        except ValueError:
            corrupt += 1
            pos = idx + 1  # garbage where a header should be: resync
            continue
        payload = data[nl + 1 : nl + 1 + length]
        if len(payload) < length:
            # Frame cut mid-payload.  At EOF that's the torn tail a
            # SIGKILL leaves (tolerated); mid-file it's a corrupt frame
            # — reject and resync at the next magic.
            nxt = data.find(FRAME_MAGIC, idx + 1)
            if nxt < 0:
                torn = True
                break
            corrupt += 1
            pos = nxt
            continue
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            corrupt += 1
            pos = idx + 1  # digest mismatch: frame not admitted; resync
            continue
        try:
            snapshots.append(json.loads(payload))
        except ValueError:
            corrupt += 1
            pos = idx + 1
            continue
        pos = nl + 1 + length
    return snapshots, {
        "frames": len(snapshots),
        "corrupt": corrupt,
        "torn_tail": torn,
    }


def final_snapshots_by_run(
    snapshots: List[Dict[str, Any]],
) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """``{(service, run_id): last snapshot}`` — snapshots are cumulative,
    so the highest-seq admitted frame is a run's final state.  Run
    identity IS the restart/reset detector: a restarted process draws a
    fresh run_id, so its counters start a new summand instead of being
    mistaken for a reset of the old series."""
    out: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for snap in snapshots:
        key = (str(snap.get("service", "")), str(snap.get("run_id", "")))
        prev = out.get(key)
        if prev is None or snap.get("seq", 0) >= prev.get("seq", 0):
            out[key] = snap
    return out
