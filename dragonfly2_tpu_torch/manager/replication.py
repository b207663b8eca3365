"""Manager HA: log-shipping replication over the StateBackend seam.

The reference gets control-plane HA for free from Redis+MySQL (the
manager sits on externally HA-able stores, database.go:50-59); our
embedded manager concentrates every durable surface behind ONE seam —
``manager/state.py``'s ``StateBackend`` — which makes that seam the
right place to replicate.  Three pieces (DESIGN.md §20):

- **write-ahead op log** (``ReplicationLog``): every ``put``/
  ``put_many``/``delete`` a leader commits is first appended to a
  monotonic (term, seq) log riding two reserved namespaces of the same
  backend (``replication_log`` / ``replication_meta``), THEN applied to
  the data namespace.  Ops are absolute upserts/deletes, so boot-time
  replay of the unapplied tail is idempotent — a crash between the log
  append and the data commit converges on restart.

- **roles + lease fencing** (``ReplicatedStateBackend``): a leader may
  commit only while its lease (renewed every ``ttl/3`` by
  ``LeaseKeeper``) is unexpired; an expired or fenced leader's writes
  raise ``NotLeaderError`` — the zombie cannot commit.  The lease is
  HMAC-signed with the shared ``lease_secret`` so a follower only
  honours (and only defers to) a leader that holds the secret; terms
  are fenced monotonically — observing a higher term permanently
  demotes this node for that term.

- **follower tailing + takeover** (``LogFollower``): a standby tails
  the leader's ``/api/v1/replication:*`` REST surface (snapshot
  bootstrap for pre-log rows, then incremental log pulls), applies ops
  into its OWN backend, answers lag/health probes, and — when the last
  fresh lease it saw has aged past expiry — promotes itself with
  ``term+1``.  After promotion it rejects ops from any lower term
  (``StaleTermError``), which is what makes a partitioned old leader's
  history unshippable.

The data-bearing routes (``:log``/``:snapshot``) carry every namespace
of the backend — including users/PATs credential rows on default
deployments — so they require proof of the shared ``lease_secret``: an
HMAC request token (:func:`sign_replication_request`) in the
``X-DF-Replication-Auth`` header.  The log is compacted: entries far
enough below the applied watermark truncate away, and a follower that
has fallen behind the retained floor re-bootstraps from a snapshot.

Every network/commit edge here is a DF004 chaos seam
(``state.replicate.*`` / ``manager.lease.*``) and every write path is
inventoried in ``records/state_contracts.py`` (the ``replicators``
section covers the dynamic-namespace apply sites) so the DF014 static
pass and the runtime crash witness gate this subsystem like any other.

Port of ``dragonfly2_tpu/manager/replication.py``, verbatim: the op log's
entries, the lease and request signatures and the role and term
bookkeeping are the reference's, so a log either package writes ships to
a follower of the other, and a replicated SQLite file opens in both.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Set

from ..utils import faultinject
from .state import KVTable, StateBackend

logger = logging.getLogger(__name__)

# Namespaces reserved for the replication machinery itself: never
# shipped in snapshots, never re-replicated.
REPLICATION_NAMESPACES = ("replication_log", "replication_meta")

# How many lease intervals of silence a follower tolerates beyond the
# advertised expiry before taking over (absorbs one lost poll).
DEFAULT_TAKEOVER_GRACE = 0.5


class NotLeaderError(RuntimeError):
    """Write rejected: this node is a standby or its lease expired."""


class StaleTermError(NotLeaderError):
    """Op or write carries a term older than one already observed —
    the sender is a fenced zombie leader."""


def sign_lease(secret: str, leader_id: str, term: int) -> str:
    """HMAC-SHA256 over the lease identity.  The signature authenticates
    WHO holds WHICH term (a forged lease cannot defer a follower);
    freshness is the transport's job — ``expires_in_s`` is relative to
    the fetch that returned it, so no cross-host clock is compared."""
    msg = f"{leader_id}:{term}".encode()
    return hmac.new(secret.encode(), msg, hashlib.sha256).hexdigest()


def verify_lease(secret: str, lease: dict) -> bool:
    try:
        want = sign_lease(secret, str(lease["leader_id"]), int(lease["term"]))
        return hmac.compare_digest(want, str(lease.get("sig", "")))
    except (KeyError, TypeError, ValueError):
        return False


# Header carrying the replication-fetch auth token.  The ``:log`` and
# ``:snapshot`` routes dump every namespace of the backend — users/PATs
# credential rows included on default deployments — so they are gated
# on possession of the shared ``lease_secret`` rather than left open
# like the role/term health probe (``:status``).
REPLICATION_AUTH_HEADER = "X-DF-Replication-Auth"


def sign_replication_request(secret: str, path: str) -> str:
    """HMAC-SHA256 token a replica presents to fetch ``path`` (the
    route path, query excluded).  Proves possession of ``lease_secret``;
    the routes are read-only, so there is no replay surface to bind —
    an observer close enough to replay could read the response anyway."""
    msg = f"replication-fetch:{path}".encode()
    return hmac.new(secret.encode(), msg, hashlib.sha256).hexdigest()


def verify_replication_request(secret: str, path: str, token: str) -> bool:
    want = sign_replication_request(secret, path)
    return hmac.compare_digest(want, str(token or ""))


def probe_peer_term(urls, *, timeout: float = 3.0):
    """Best-effort sweep of peer replicas' ``:status`` probes; returns
    ``(term, url)`` for the highest term observed (``(0, "")`` when no
    peer answers).  A node configured as leader calls this at boot so a
    restarted fenced leader discovers the successor's term and rejoins
    as a standby instead of resurrecting its stale term."""
    best_term, best_url = 0, ""
    for url in urls:
        url = str(url).rstrip("/")
        if not url:
            continue
        try:
            faultinject.fire(f"state.replicate.{'probe'}")
            with urllib.request.urlopen(
                url + "/api/v1/replication:status", timeout=timeout
            ) as resp:
                status = json.loads(resp.read())
            term = int(status.get("term", 0))
        except Exception as exc:  # noqa: BLE001 — a dead peer is no vote
            logger.debug("peer probe %s unreachable: %s", url, exc)
            continue
        if term > best_term:
            best_term, best_url = term, url
    return best_term, best_url


class ReplicationLog:
    """The durable op log + term/applied watermark, riding two reserved
    namespaces of the inner backend.

    ``append`` is the write-ahead half of every replicated commit; the
    applied watermark is flushed lazily (every ``APPLIED_FLUSH_EVERY``
    ops and at ``flush``) because replaying an already-applied absolute
    op at boot is a no-op — lag in the watermark costs replay work,
    never correctness.

    Locking: this object is owned by ONE ``ReplicatedStateBackend`` and
    every mutator runs under that backend's ``_mu`` (log order must BE
    commit order, so a separate log lock could only reorder or
    deadlock); ``seq``/``term``/``applied`` are single int reads (GIL
    atomic) safe for health probes.
    """

    APPLIED_FLUSH_EVERY = 64

    def __init__(self, backend: StateBackend) -> None:
        self._log = backend.table("replication_log")
        self._meta = backend.table("replication_meta")
        rows = self._log.load_all()
        self._seq = max((int(k) for k in rows), default=0)
        state = self._meta.load_all().get("state") or {}
        self._term = int(state.get("term", 1))
        self._applied = int(state.get("applied", 0))
        # Lowest seq still retained: entries below it were compacted
        # away (a follower that far behind re-bootstraps via snapshot).
        self._floor = int(state.get("floor", 1))
        self._unflushed = 0

    @staticmethod
    def _key(seq: int) -> str:
        return f"{seq:020d}"

    def append(self, entry: dict) -> int:
        """Assign the next seq and durably append ``entry`` (must carry
        ``term``/``ns``/``op`` + payload).  Returns the assigned seq."""
        self._seq += 1
        entry = dict(entry, seq=self._seq)
        self._log.put(self._key(self._seq), entry)
        return self._seq

    def discard(self, seq: int) -> None:
        """Remove a just-appended entry whose data commit FAILED: the
        caller was told the write failed, so the WAL row must not ship
        to followers or replay at boot as a write that never happened.
        The seq stays consumed (a gap) — reusing it could alias two
        different ops at one position."""
        self._log.delete(self._key(seq))

    def append_at(self, entry: dict) -> None:
        """Follower-side copy of a leader-assigned entry (keeps this
        node's log shippable to a cascading follower after promotion)."""
        seq = int(entry["seq"])
        self._log.put(self._key(seq), entry)
        if seq > self._seq:
            self._seq = seq

    def mark_applied(self, seq: int) -> None:
        if seq > self._applied:
            self._applied = seq
        self._unflushed += 1
        if self._unflushed >= self.APPLIED_FLUSH_EVERY:
            self.flush()

    def set_term(self, term: int) -> None:
        self._term = int(term)
        self.flush()

    def flush(self) -> None:
        self._meta.put(
            "state",
            {"term": self._term, "applied": self._applied,
             "floor": self._floor},
        )
        self._unflushed = 0

    @property
    def seq(self) -> int:
        return self._seq

    @property
    def term(self) -> int:
        return self._term

    @property
    def applied(self) -> int:
        return self._applied

    @property
    def floor(self) -> int:
        return self._floor

    def entries_since(self, from_seq: int, limit: int = 500) -> List[dict]:
        """Entries with seq > ``from_seq``, ascending, at most ``limit``.
        Keys are zero-padded, so the lexicographic range scan IS the
        numeric one (SQLite serves it as an indexed WHERE key > ?)."""
        rows = self._log.load_range(self._key(max(from_seq, 0)))
        out = sorted(rows.values(), key=lambda e: int(e["seq"]))
        return out[:limit]

    def truncate_below(self, seq: int) -> None:
        """Compact: drop entries with seq < ``seq``, never past one
        beyond the applied watermark (the unapplied tail is the boot
        replay's crash-recovery record).  Growth stays bounded over a
        deployment's lifetime; a follower behind the new floor falls
        back to snapshot bootstrap."""
        seq = min(int(seq), self._applied + 1)
        if seq <= self._floor:
            return
        self._log.delete_range(self._key(seq))
        self._floor = seq
        self.flush()

    def pending(self) -> List[dict]:
        """The unapplied tail (crash between log append and data
        commit): replayed idempotently at boot."""
        return self.entries_since(self.applied)


class ReplicatedStateBackend(StateBackend):
    """StateBackend wrapper that write-ahead-logs every mutation and
    enforces leader/lease/term fencing at the commit point.

    Reads always pass through.  Writes require a live leader role
    unless issued inside :meth:`applying` (the follower's apply path
    and standby boot-time reconciliation)."""

    def __init__(
        self,
        inner: StateBackend,
        *,
        node_id: str = "manager",
        role: str = "leader",
        lease_ttl_s: float = 10.0,
        lease_secret: str = "dragonfly-manager-lease",
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if role not in ("leader", "standby"):
            raise ValueError(f"unknown replication role {role!r}")
        self._inner = inner
        self.node_id = node_id
        self.lease_ttl_s = float(lease_ttl_s)
        self.lease_secret = lease_secret
        self._clock = clock
        self._mu = threading.RLock()
        self._local = threading.local()
        self.log = ReplicationLog(inner)
        self._role = role
        self._term = self.log.term
        self._lease_expires_at: Optional[float] = None
        self.failovers = 0
        if role == "leader":
            self._lease_expires_at = self._clock() + self.lease_ttl_s
            self._replay_pending()
        self._set_role_metric()

    # -- role / lease ---------------------------------------------------

    def _set_role_metric(self) -> None:
        from ..rpc.metrics import MANAGER_ROLE

        for role in ("leader", "standby"):
            MANAGER_ROLE.set(1.0 if role == self._role else 0.0, role=role)

    @property
    def role(self) -> str:
        with self._mu:
            return self._role

    @property
    def term(self) -> int:
        with self._mu:
            return self._term

    def renew_lease(self) -> dict:
        """Extend this leader's lease by one TTL; raises if no longer
        leader (a fenced node cannot resurrect itself by renewing).

        An ALREADY-EXPIRED lease cannot be renewed either: past expiry a
        standby may have promoted at ``term+1``, and since followers
        pull (nothing pushes the successor's term back here), a paused/
        partitioned leader that resumed would otherwise re-extend its
        stale-term lease and keep committing forever — the split brain
        the lease exists to prevent.  Instead the node steps down; it
        rejoins via ``--replicate-from`` (or the ``ha.peers`` probe at
        next boot)."""
        faultinject.fire(f"manager.lease.{'renew'}")
        with self._mu:
            if self._role != "leader":
                raise NotLeaderError(
                    f"{self.node_id}: cannot renew lease in role {self._role}"
                )
            now = self._clock()
            if (
                self._lease_expires_at is not None
                and now >= self._lease_expires_at
            ):
                self._role = "standby"
                self._lease_expires_at = None
                self._set_role_metric()
                logger.warning(
                    "%s: lease expired before renewal at term %d — "
                    "stepping down (a successor may hold a higher term)",
                    self.node_id, self._term,
                )
                raise NotLeaderError(
                    f"{self.node_id}: lease expired at term {self._term}; "
                    "refusing to resurrect it — stepped down"
                )
            self._lease_expires_at = now + self.lease_ttl_s
            return self._lease_payload_locked()

    def _lease_payload_locked(self) -> dict:
        expires_in = 0.0
        if self._lease_expires_at is not None:
            expires_in = max(self._lease_expires_at - self._clock(), 0.0)
        return {
            "leader_id": self.node_id,
            "term": self._term,
            "ttl_s": self.lease_ttl_s,
            "expires_in_s": expires_in,
            "sig": sign_lease(self.lease_secret, self.node_id, self._term),
        }

    def lease_payload(self) -> dict:
        with self._mu:
            return self._lease_payload_locked()

    def promote(self, term: Optional[int] = None) -> int:
        """Standby → leader at ``term`` (default: observed term + 1).
        Replays any unapplied log tail, persists the new term, and
        starts a fresh lease."""
        faultinject.fire(f"manager.lease.{'promote'}")
        with self._mu:
            new_term = int(term) if term is not None else self._term + 1
            if new_term <= self._term and self._role == "leader":
                return self._term
            if new_term < self._term:
                raise StaleTermError(
                    f"promotion to term {new_term} below observed {self._term}"
                )
            self._term = new_term
            self._role = "leader"
            self._lease_expires_at = self._clock() + self.lease_ttl_s
            self.log.set_term(new_term)
            self.failovers += 1
            self._replay_pending_locked()
            self._set_role_metric()
        from ..rpc.metrics import MANAGER_FAILOVERS_TOTAL

        MANAGER_FAILOVERS_TOTAL.inc(node=self.node_id)
        logger.warning(
            "%s: promoted to leader (term %d)", self.node_id, new_term
        )
        return new_term

    def step_down(self) -> None:
        """Leader → standby (tests / graceful handover)."""
        with self._mu:
            self._role = "standby"
            self._lease_expires_at = None
            self._set_role_metric()

    def observe_term(self, term: int) -> None:
        """Fence: once a higher term is seen, this node can never commit
        under its old term again."""
        with self._mu:
            if term > self._term:
                if self._role == "leader":
                    logger.warning(
                        "%s: fenced by term %d (was leader at term %d)",
                        self.node_id, term, self._term,
                    )
                self._term = term
                self._role = "standby"
                self._lease_expires_at = None
                self.log.set_term(term)
                self._set_role_metric()

    # -- the write gate -------------------------------------------------

    def applying(self) -> "_Applying":
        """``with backend.applying(): ...`` — writes inside the block
        bypass the leader gate (the follower's apply path and standby
        boot-time reconciliation write replicated/derived state, not
        new client mutations)."""
        return _Applying(self)

    def _is_applying(self) -> bool:
        return getattr(self._local, "apply_depth", 0) > 0

    def _check_writable_locked(self) -> None:
        faultinject.fire(f"manager.lease.{'check'}")
        if self._role != "leader":
            raise NotLeaderError(
                f"{self.node_id}: standby (term {self._term}) rejects writes"
            )
        if (
            self._lease_expires_at is not None
            and self._clock() >= self._lease_expires_at
        ):
            raise NotLeaderError(
                f"{self.node_id}: lease expired at term {self._term} — "
                "a successor may hold a higher term; refusing to commit"
            )

    # Every COMPACT_EVERY commits, truncate log entries more than
    # RETAIN_OPS below the applied watermark (followers further behind
    # re-bootstrap via snapshot) — the log must not grow without bound
    # when whole artifacts ride it (KVBlobStore).
    COMPACT_EVERY = 256
    RETAIN_OPS = 1024

    def _commit_op(
        self, ns: str, op: str, payload: dict, fn: Callable[[], None]
    ) -> None:
        """Write-ahead append (term+seq) then the data commit, under one
        lock so the log order IS the commit order."""
        from ..utils.tracing import default_tracer

        faultinject.fire(f"state.replicate.{op}")
        if self._is_applying():
            fn()
            return
        # Span OUTSIDE the commit lock: a span closing while a project
        # lock is held would hand the lock witness a lock→exporter edge
        # the static graph (which doesn't traverse generator
        # contextmanagers) can never corroborate.  Same rule for the
        # commit-lag sketch observe below.
        from ..rpc.metrics import REPLICATION_COMMIT_SECONDS

        t0 = time.monotonic()
        with default_tracer.span(
            "manager/replicate.commit", ns=ns, op=op
        ) as span:
            self._commit_op_locked(ns, op, payload, fn, span)
        REPLICATION_COMMIT_SECONDS.observe(time.monotonic() - t0)

    def _commit_op_locked(
        self, ns: str, op: str, payload: dict, fn: Callable[[], None], span
    ) -> None:
        with self._mu:
            self._check_writable_locked()
            entry = dict(payload, term=self._term, ns=ns, op=op)
            seq = self.log.append(entry)
            span.set(seq=seq, term=self._term)
            try:
                fn()
            except BaseException:
                # The caller is told this write FAILED: the WAL row must
                # not outlive it — left in place it would ship to
                # followers (and replay at boot) as a write the leader's
                # own table never took, and the next successful commit
                # would advance the watermark past it, making the
                # divergence permanent.  A genuine crash (process death
                # between append and commit) still replays at boot: the
                # caller never got an answer there, so applying is the
                # correct resolution of the ambiguity.
                self.log.discard(seq)
                raise
            self.log.mark_applied(seq)
            if seq % self.COMPACT_EVERY == 0:
                self.log.truncate_below(self.log.applied - self.RETAIN_OPS + 1)

    def log_entries(self, from_seq: int, limit: int = 500) -> dict:
        """The ``:log`` route's payload, read under the commit lock so a
        concurrent commit's append-then-discard (failed data commit)
        can never be observed half-done by a polling follower."""
        with self._mu:
            return {
                "entries": self.log.entries_since(from_seq, limit),
                "seq": self.log.seq,
                "term": self._term,
                "floor": self.log.floor,
            }

    # -- follower application ------------------------------------------

    def _apply_entry_locked(self, entry: dict) -> None:
        table = self._inner.table(entry["ns"])
        if entry["op"] == "delete":
            table.delete(entry["key"])
        else:
            table.put_many(dict(entry["items"]))

    def _replay_pending_locked(self) -> None:
        replayed = 0
        for entry in self.log.pending():
            self._apply_entry_locked(entry)
            self.log.mark_applied(int(entry["seq"]))
            replayed += 1
        if replayed:
            self.log.flush()
            logger.info(
                "%s: replayed %d unapplied log entries at boot",
                self.node_id, replayed,
            )

    def _replay_pending(self) -> None:
        with self._mu:
            self._replay_pending_locked()

    def apply_ops(self, entries: List[dict]) -> Set[str]:
        """Apply leader-shipped entries in seq order; returns the set of
        touched namespaces.  Rejects any entry from a term below this
        node's (the zombie fence) and skips already-applied seqs."""
        faultinject.fire(f"state.replicate.{'apply'}")
        touched: Set[str] = set()
        with self._mu:
            for entry in sorted(entries, key=lambda e: int(e["seq"])):
                term = int(entry.get("term", 0))
                if term < self._term:
                    raise StaleTermError(
                        f"op seq={entry.get('seq')} term={term} below "
                        f"observed term {self._term} — rejecting zombie write"
                    )
                seq = int(entry["seq"])
                if seq <= self.log.applied:
                    continue
                self._apply_entry_locked(entry)
                self.log.append_at(entry)
                self.log.mark_applied(seq)
                touched.add(entry["ns"])
        return touched

    # -- snapshot bootstrap ---------------------------------------------

    def snapshot(self) -> dict:
        """Consistent full-state snapshot for follower bootstrap: every
        data namespace's rows + the (term, seq) frontier, assembled
        under the commit lock so no append interleaves."""
        faultinject.fire(f"state.replicate.{'snapshot'}")
        with self._mu:
            namespaces = {}
            for ns in self._inner.namespaces():
                if ns in REPLICATION_NAMESPACES:
                    continue
                namespaces[ns] = self._inner.table(ns).load_all()
            return {
                "term": self._term,
                "seq": self.log.seq,
                "namespaces": namespaces,
            }

    def apply_snapshot(self, snapshot: dict) -> Set[str]:
        """Replace local data state with the leader's snapshot (rows
        absent from the snapshot are deleted — a leader-side delete must
        not survive locally), and fast-forward the applied watermark to
        the snapshot frontier."""
        faultinject.fire(f"state.replicate.{'snapshot'}")
        incoming = snapshot.get("namespaces", {})
        touched: Set[str] = set()
        with self._mu:
            self.observe_term(int(snapshot.get("term", self._term)))
            locals_ = set(self._inner.namespaces()) - set(
                REPLICATION_NAMESPACES
            )
            for ns in sorted(locals_ | set(incoming)):
                table = self._inner.table(ns)
                rows = incoming.get(ns, {})
                stale = set(table.load_all()) - set(rows)
                for key in stale:
                    table.delete(key)
                if rows:
                    table.put_many(dict(rows))
                touched.add(ns)
            seq = int(snapshot.get("seq", 0))
            if seq > self.log.applied:
                self.log.mark_applied(seq)
            self.log.flush()
        return touched

    def status(self) -> dict:
        with self._mu:
            return {
                "node_id": self.node_id,
                "role": self._role,
                "term": self._term,
                "seq": self.log.seq,
                "applied_seq": self.log.applied,
                "failovers": self.failovers,
            }

    # -- StateBackend surface -------------------------------------------

    def table(self, namespace: str) -> KVTable:
        return _ReplicatedTable(self, namespace)

    def namespaces(self) -> List[str]:
        return self._inner.namespaces()

    def close(self) -> None:
        with self._mu:
            self.log.flush()
        self._inner.close()


class _Applying:
    """Thread-local re-entrant apply scope (see
    :meth:`ReplicatedStateBackend.applying`)."""

    def __init__(self, backend: "ReplicatedStateBackend") -> None:
        self._b = backend

    def __enter__(self) -> "ReplicatedStateBackend":
        local = self._b._local
        local.apply_depth = getattr(local, "apply_depth", 0) + 1
        return self._b

    def __exit__(self, *exc) -> None:
        self._b._local.apply_depth -= 1


class _ReplicatedTable(KVTable):
    """One namespace viewed through the replication gate."""

    def __init__(self, backend: ReplicatedStateBackend, ns: str) -> None:
        self._b = backend
        self._ns = ns
        self._table = backend._inner.table(ns)

    def put(self, key: str, doc: dict) -> None:
        self._b._commit_op(
            self._ns, "put_many", {"items": {key: doc}},
            lambda: self._table.put(key, doc),
        )

    def put_many(self, items: Dict[str, dict]) -> None:
        self._b._commit_op(
            self._ns, "put_many", {"items": dict(items)},
            lambda: self._table.put_many(items),
        )

    def delete(self, key: str) -> None:
        self._b._commit_op(
            self._ns, "delete", {"key": key},
            lambda: self._table.delete(key),
        )

    def get(self, key: str) -> Optional[dict]:
        return self._table.get(key)

    def load_all(self) -> Dict[str, dict]:
        return self._table.load_all()


class LeaseKeeper:
    """Leader-side lease renewal loop (ttl/3 cadence, so two missed
    renewals still leave headroom before followers take over)."""

    def __init__(self, backend: ReplicatedStateBackend) -> None:
        self._b = backend
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self._b.lease_ttl_s / 3.0):
                try:
                    self._b.renew_lease()
                except NotLeaderError:
                    logger.warning("lease keeper: no longer leader; stopping")
                    return
                except Exception:  # noqa: BLE001 — renewal loop is forever
                    logger.exception("lease renewal failed")

        self._thread = threading.Thread(
            target=loop, name="manager-lease-keeper", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class LogFollower:
    """Standby-side tailer: snapshot bootstrap, incremental log pulls,
    lease watching, and lease-expiry takeover.

    ``on_apply(namespaces)`` fires after each batch that changed data
    namespaces (the standby composition rebuilds its in-memory
    consumers); ``on_promote()`` fires once after takeover."""

    def __init__(
        self,
        backend: ReplicatedStateBackend,
        leader_url: str,
        *,
        poll_interval_s: float = 1.0,
        timeout: float = 10.0,
        takeover_grace: float = DEFAULT_TAKEOVER_GRACE,
        on_apply: Optional[Callable[[Set[str]], None]] = None,
        on_promote: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.backend = backend
        self.leader_url = leader_url.rstrip("/")
        self.poll_interval_s = poll_interval_s
        self.timeout = timeout
        self.takeover_grace = takeover_grace
        self.on_apply = on_apply
        self.on_promote = on_promote
        self._clock = clock
        self._mu = threading.Lock()
        # Until the first fresh lease arrives, grant the leader one full
        # TTL of benefit-of-the-doubt from follower boot.
        self._lease_deadline = clock() + backend.lease_ttl_s * (
            1.0 + takeover_grace
        )
        self._bootstrapped = False
        self._last_caught_up = clock()
        self._leader_seq = 0
        self.promoted = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wire -----------------------------------------------------------

    def _get_json(self, path: str) -> dict:
        faultinject.fire(f"state.replicate.{'fetch'}")
        # Auth: the data-bearing routes demand proof of the shared
        # lease_secret (the token is over the route path, query aside).
        route = path.split("?", 1)[0]
        req = urllib.request.Request(self.leader_url + path, headers={
            REPLICATION_AUTH_HEADER: sign_replication_request(
                self.backend.lease_secret, route
            ),
        })
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    # -- one poll -------------------------------------------------------

    def poll_once(self) -> int:
        """Fetch leader status + new log entries, apply them, track the
        lease.  Returns the number of entries applied; raises nothing —
        an unreachable leader just lets the lease age toward takeover."""
        if self.promoted:
            return 0
        try:
            status = self._get_json("/api/v1/replication:status")
        except Exception as exc:  # noqa: BLE001 — outage ages the lease
            logger.debug("follower poll: leader unreachable: %s", exc)
            self._maybe_promote()
            return 0
        lease = status.get("lease") or {}
        now = self._clock()
        if verify_lease(self.backend.lease_secret, lease):
            term = int(lease.get("term", 0))
            self.backend.observe_term(term)
            expires_in = float(lease.get("expires_in_s", 0.0))
            ttl = float(lease.get("ttl_s", self.backend.lease_ttl_s))
            with self._mu:
                self._lease_deadline = now + expires_in + ttl * self.takeover_grace
        applied = 0
        try:
            self._leader_seq = int(status.get("seq", 0))
            if not self._bootstrapped:
                self._bootstrap_snapshot()
            while self.backend.log.applied < self._leader_seq:
                from_seq = self.backend.log.applied
                resp = self._get_json(
                    f"/api/v1/replication:log?from_seq={from_seq}"
                )
                if int(resp.get("floor", 1)) > from_seq + 1:
                    # Behind the leader's compaction floor: entries
                    # between our watermark and the floor were truncated
                    # away, and applying the retained tail would
                    # silently skip them — re-bootstrap via snapshot
                    # (fast-forwards the watermark past the gap).
                    self._bootstrap_snapshot()
                    continue
                batch = resp.get("entries", [])
                if not batch:
                    # Nothing retained beyond our watermark: the head of
                    # the leader's log is a gap (a discarded failed
                    # commit) — we ARE caught up, don't report lag.
                    self._leader_seq = from_seq
                    break
                touched = self.backend.apply_ops(batch)
                applied += len(batch)
                if touched and self.on_apply is not None:
                    self.on_apply(touched)
        except StaleTermError:
            raise
        except Exception as exc:  # noqa: BLE001 — retry next poll
            logger.warning("follower poll: log pull failed: %s", exc)
        if self.backend.log.applied >= self._leader_seq:
            with self._mu:
                self._last_caught_up = self._clock()
        self._export_lag()
        return applied

    def _bootstrap_snapshot(self) -> None:
        snap = self._get_json("/api/v1/replication:snapshot")
        touched = self.backend.apply_snapshot(snap)
        self._bootstrapped = True
        if touched and self.on_apply is not None:
            self.on_apply(touched)

    def _export_lag(self) -> None:
        from ..rpc.metrics import REPLICATION_LAG

        REPLICATION_LAG.set(self.lag_seconds())

    def lag_seconds(self) -> float:
        """Seconds since this follower last matched the leader's log
        frontier (≈0 while caught up; grows through an outage)."""
        with self._mu:
            if self.backend.log.applied >= self._leader_seq:
                return 0.0
            return max(self._clock() - self._last_caught_up, 0.0)

    def health(self) -> dict:
        with self._mu:
            lease_remaining = self._lease_deadline - self._clock()
        return {
            "role": self.backend.role,
            "term": self.backend.term,
            "applied_seq": self.backend.log.applied,
            "leader_seq": self._leader_seq,
            "lag_seconds": self.lag_seconds(),
            "lease_remaining_s": lease_remaining,
            "promoted": self.promoted,
        }

    def _maybe_promote(self) -> bool:
        with self._mu:
            expired = self._clock() >= self._lease_deadline
        if not expired or self.promoted:
            return self.promoted
        self.backend.promote()
        self.promoted = True
        if self.on_promote is not None:
            self.on_promote()
        return True

    # -- background serve ----------------------------------------------

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.poll_interval_s):
                try:
                    if self.poll_once() == 0:
                        self._maybe_promote()
                    if self.promoted:
                        return
                except Exception:  # noqa: BLE001 — the tail loop is forever
                    logger.exception("follower poll failed")

        self._thread = threading.Thread(
            target=loop, name="manager-log-follower", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
