"""Upload manager: serve local pieces to other peers.

Reference: client/daemon/upload/upload_manager.go:59-76 — an HTTP piece
server answering range requests from peers.  Transport-neutral core: the
in-process swarm calls ``serve_piece`` directly; an HTTP binding wraps the
same method.  Concurrency is capped the way the scheduler models it
(Host.concurrent_upload_limit).

Two serve shapes (DESIGN.md §22):

- **buffered** — ``serve_piece`` / ``serve_piece_span`` materialize the
  bytes (the in-process transport, TLS serving, and every chaos drill
  that tears bodies ride this path);
- **zero-copy** — ``piece_sendfile_span`` / ``range_sendfile_span`` hand
  the HTTP server a ``(path, offset, length)`` file span so the bytes go
  kernel→socket via ``os.sendfile`` without ever entering Python.  Both
  shapes share ONE accounting gate (``begin_upload``/``end_upload``), so
  the concurrency cap and the upload counters mean the same thing on
  either path — and tests prove the two byte-identical.

Tenant QoS (DESIGN.md §26): tasks are stamped with the tenant that
created them (``register_task_tenant``); with a ``QoSPolicy`` installed,
the shared gate also enforces each tenant's ``upload_rate_bytes_s`` cap
with a post-paid token bucket — a request is admitted while the
tenant's balance is positive and the ACTUAL bytes are charged at
``end_upload`` (piece sizes are not known before the read), so a
flooding tenant's serves go 503 (``UploadThrottled``) while other
tenants' pieces keep flowing.  Per-tenant byte totals feed the bounded
``tenant_class`` metric label, never raw tenant ids (DF017).

Port of ``dragonfly2_tpu/daemon/upload.py``, verbatim; the tenant caps
read the port's ``qos.policy``.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Dict, Optional, Tuple

from ..utils.metrics import default_registry as _reg
from .storage import DaemonStorage

if TYPE_CHECKING:  # duck-typed at runtime (no qos import on boot)
    from ..qos.policy import QoSPolicy

UPLOAD_THROTTLED_TOTAL = _reg.counter(
    "daemon_upload_throttled_total",
    "Piece serves refused by a tenant's upload-bandwidth cap",
    ["tenant_class"],
)
UPLOAD_TENANT_BYTES_TOTAL = _reg.counter(
    "daemon_upload_tenant_bytes_total",
    "Bytes served from the upload path, by tenant class",
    ["tenant_class"],
)

_DEFAULT_TENANT = "default"

# Hard bound on tenant-keyed accounting state (buckets + byte totals).
# Requester attribution is already gated on KNOWN tenants, so this only
# bites if a runaway registrar stamps thousands of distinct owners —
# overflow folds into the default bucket instead of growing without
# limit (the DF017 discipline applied to memory, not just labels).
_MAX_TRACKED_TENANTS = 4096


class UploadBusy(RuntimeError):
    pass


class UploadThrottled(UploadBusy):
    """A tenant's upload-bandwidth cap refused this serve (the wire
    servers answer 503 exactly like the concurrency cap — the client's
    reschedule/backoff machinery already knows the shape)."""


class _TenantBandwidth:
    """Post-paid byte bucket: admit while balance > 0, charge actual
    bytes afterwards; the balance refills at the capped rate and may go
    negative (the debt model standard for bandwidth shaping where sizes
    are only known after the read)."""

    __slots__ = ("rate", "balance", "last")

    def __init__(self, rate: float) -> None:
        self.rate = rate
        self.balance = rate  # one second of burst headroom
        self.last = time.monotonic()

    def refill(self, now: float) -> None:
        self.balance = min(self.rate, self.balance + (now - self.last) * self.rate)
        self.last = now


class UploadManager:
    def __init__(
        self,
        storage: DaemonStorage,
        *,
        concurrent_limit: int = 50,
        qos_policy: "Optional[QoSPolicy]" = None,
    ) -> None:
        self.storage = storage
        self.concurrent_limit = concurrent_limit
        self._mu = threading.Lock()
        self._active = 0
        self.upload_count = 0
        self.upload_failed_count = 0
        self.bytes_served = 0
        self.throttled_count = 0
        # Tenant plane: task → owning tenant (stamped at download
        # registration), per-tenant post-paid byte buckets, per-tenant
        # served-byte totals (raw ids live HERE, never on metric labels).
        self._policy = qos_policy
        self._task_tenant: Dict[str, str] = {}
        self._registered_tenants: set = set()
        self._tenant_bw: Dict[str, _TenantBandwidth] = {}
        self.tenant_bytes: Dict[str, int] = {}

    @property
    def active(self) -> int:
        with self._mu:
            return self._active

    # -- tenant plane --------------------------------------------------------

    def set_qos_policy(self, policy: "Optional[QoSPolicy]") -> None:
        with self._mu:
            self._policy = policy
            self._tenant_bw.clear()  # rebuilt lazily from the new caps

    def register_task_tenant(self, task_id: str, tenant: str) -> None:
        """Stamp the tenant that created ``task_id`` — serves of the
        task's pieces account (and throttle) against it.  Registration
        also marks the tenant as KNOWN, so its wire-stamped requests on
        other tenants' tasks are honored by requester-pays."""
        with self._mu:
            self._task_tenant[task_id] = tenant or _DEFAULT_TENANT
            self._registered_tenants.add(tenant or _DEFAULT_TENANT)

    def tenant_of(self, task_id: Optional[str]) -> str:
        with self._mu:
            return self._task_tenant.get(task_id or "", _DEFAULT_TENANT)

    def _bw_locked(self, tenant: str) -> Optional[_TenantBandwidth]:
        policy = self._policy
        if policy is None:
            return None
        rate = float(policy.for_tenant(tenant).upload_rate_bytes_s)
        if rate <= 0.0:
            self._tenant_bw.pop(tenant, None)
            return None
        bw = self._tenant_bw.get(tenant)
        if bw is None or bw.rate != rate:
            bw = self._tenant_bw[tenant] = _TenantBandwidth(rate)
        return bw

    # -- shared accounting gate (both serve shapes) --------------------------

    def _known_tenant_locked(self, tenant: str) -> bool:
        """A tenant this daemon can vouch for: a QoS-policy row or a
        locally registered task owner."""
        if tenant in self._registered_tenants:
            return True
        policy = self._policy
        return policy is not None and tenant in policy

    def _tracked_tenant_locked(self, tenant: str) -> str:
        """Accounting key for ``tenant``, folding overflow into the
        default bucket once the per-tenant maps hit their bound."""
        if (
            tenant == _DEFAULT_TENANT
            or tenant in self.tenant_bytes
            or tenant in self._tenant_bw
        ):
            return tenant
        if (
            len(self.tenant_bytes) >= _MAX_TRACKED_TENANTS
            or len(self._tenant_bw) >= _MAX_TRACKED_TENANTS
        ):
            return _DEFAULT_TENANT
        return tenant

    def _charged_tenant_locked(
        self, task_id: Optional[str], requester_tenant: Optional[str]
    ) -> str:
        """Who pays for this serve: the REQUESTING tenant when the wire
        carried one (X-Dragonfly-Tenant) AND it names a tenant this
        daemon already knows — a QoS-policy row or a registered task
        owner — else the task's owner.  Before requester attribution
        existed, a stranger's cross-tenant pulls drained the owner's
        byte bucket (DESIGN.md §28); but the header is UNAUTHENTICATED,
        so an unknown name is treated as absent: honoring it verbatim
        would let any client spoof a victim tenant's bucket into debt
        (the very attack requester-pays fixes, now remotely steerable)
        or rotate fabricated names into fresh default-class buckets
        past their real cap."""
        if requester_tenant and self._known_tenant_locked(requester_tenant):
            return self._tracked_tenant_locked(requester_tenant)
        return self._tracked_tenant_locked(
            self._task_tenant.get(task_id or "", _DEFAULT_TENANT)
        )

    def begin_upload(
        self,
        task_id: Optional[str] = None,
        requester_tenant: Optional[str] = None,
    ) -> None:
        """Claim one upload slot; raises UploadBusy past the cap and
        UploadThrottled when the charged tenant's bandwidth cap is in
        debt (the requester when known, else the task owner).  Callers
        MUST pair with ``end_upload`` (the sendfile server path wraps
        its own stream between the two)."""
        from ..utils import faultinject

        # Throttle chaos seam (DF004): injected drops/delays here prove
        # a wedged/refused gate degrades to the client's reschedule
        # path, never a stuck serve.
        faultinject.fire("daemon.upload.throttle")
        with self._mu:
            if self._active >= self.concurrent_limit:
                raise UploadBusy(f"{self._active} active uploads")
            tenant = self._charged_tenant_locked(task_id, requester_tenant)
            bw = self._bw_locked(tenant)
            if bw is not None:
                bw.refill(time.monotonic())
                if bw.balance <= 0.0:
                    self.throttled_count += 1
                    cls = (
                        self._policy.class_of(tenant)
                        if self._policy is not None else "silver"
                    )
                    UPLOAD_THROTTLED_TOTAL.inc(tenant_class=cls)
                    raise UploadThrottled(
                        f"tenant upload cap: {bw.balance:.0f} byte balance"
                    )
            self._active += 1

    def end_upload(
        self,
        ok: bool,
        nbytes: int = 0,
        task_id: Optional[str] = None,
        requester_tenant: Optional[str] = None,
    ) -> None:
        with self._mu:
            self._active -= 1
            if ok:
                self.upload_count += 1
                self.bytes_served += nbytes
                tenant = self._charged_tenant_locked(task_id, requester_tenant)
                self.tenant_bytes[tenant] = (
                    self.tenant_bytes.get(tenant, 0) + nbytes
                )
                bw = self._bw_locked(tenant)
                if bw is not None and nbytes:
                    bw.refill(time.monotonic())
                    bw.balance -= nbytes
                if nbytes and self._policy is not None:
                    UPLOAD_TENANT_BYTES_TOTAL.inc(
                        amount=nbytes, tenant_class=self._policy.class_of(tenant)
                    )
            else:
                self.upload_failed_count += 1

    # -- buffered serving ----------------------------------------------------

    # dflint: hotpath
    def serve_piece(
        self, task_id: str, number: int,
        requester_tenant: Optional[str] = None,
    ) -> bytes:
        """One piece upload; raises UploadBusy past the concurrency cap,
        KeyError when the piece isn't local."""
        from ..utils import faultinject

        # Upload-path chaos seam (drop/delay/dferror before the read,
        # truncate on the body): covers BOTH piece transports — the HTTP
        # server and the in-process fetcher call through here.
        faultinject.fire("daemon.upload.serve_piece")
        self.begin_upload(task_id, requester_tenant)
        ok = False
        try:
            data = self.storage.read_piece(task_id, number)
            # The body seam may raise (injected drop): that upload FAILED.
            data = faultinject.fire("daemon.upload.body", data)
            ok = True
            return data
        finally:
            self.end_upload(ok, len(data) if ok else 0, task_id,
                            requester_tenant)

    def serve_piece_span(
        self, task_id: str, number: int, offset: int, max_len: int,
        requester_tenant: Optional[str] = None,
    ) -> bytes:
        """Buffered SUB-PIECE upload: only the requested span is read
        (storage.read_piece_at) — a tiny Range request no longer
        materializes a whole 4 MiB piece.  Same cap/counters/seams as
        serve_piece."""
        from ..utils import faultinject

        faultinject.fire("daemon.upload.serve_piece")
        self.begin_upload(task_id, requester_tenant)
        ok = False
        try:
            data = self.storage.read_piece_at(task_id, number, offset, max_len)
            data = faultinject.fire("daemon.upload.body", data)
            ok = True
            return data
        finally:
            self.end_upload(ok, len(data) if ok else 0, task_id,
                            requester_tenant)

    def serve_range(
        self, task_id: str, start: int, length: int, piece_size: int,
        requester_tenant: Optional[str] = None,
    ) -> bytes:
        """Byte-range read assembled from SUB-PIECE reads (HTTP Range
        semantics): each overlapping piece contributes only its requested
        span instead of a whole-piece materialize-then-slice."""
        out = bytearray()
        pos = start
        end = start + length
        while pos < end:
            num = pos // piece_size
            off = pos - num * piece_size
            chunk = self.serve_piece_span(task_id, num, off, end - pos,
                                          requester_tenant)
            if not chunk:
                break
            out += chunk
            pos += len(chunk)
        return bytes(out)

    # -- zero-copy serving ---------------------------------------------------

    def piece_sendfile_span(
        self, task_id: str, number: int
    ) -> Optional[Tuple[str, int, int]]:
        """Zero-copy serve handle for one piece, or None → caller uses the
        buffered path.  A scenario that tears BODIES (truncate faults on
        the upload/serve body seams) needs byte payloads to cut, so it
        forces the buffered path; drop/delay/dferror/crash faults fire
        right here and behave identically on either path."""
        from ..utils import faultinject

        faultinject.fire("daemon.upload.sendfile")
        if faultinject.truncates("daemon.upload.body") or faultinject.truncates(
            "piece.server.body"
        ):
            return None
        return self.storage.piece_file_span(task_id, number)

    def range_sendfile_span(
        self, task_id: str, start: int, length: int
    ) -> Optional[Tuple[str, int, int]]:
        """Zero-copy handle for a byte range (pieces are contiguous in the
        engine's data file); None → buffered serve_range fallback."""
        from ..utils import faultinject

        faultinject.fire("daemon.upload.sendfile")
        if faultinject.truncates("daemon.upload.body") or faultinject.truncates(
            "piece.server.body"
        ):
            return None
        return self.storage.range_file_span(task_id, start, length)
