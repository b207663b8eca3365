"""Columnar host store: the slot matrix is the SOURCE OF TRUTH.

The first ``HostFeatureCache`` was a cache: the ``Host`` object owned the
serving state and the slot matrix held stamp-validated derived rows, so
every serve paid a per-candidate stamp compare and every stamp miss paid
an object→matrix marshalling hop (``to_record()`` + ``host_features``).
BENCHMARKS.md was honest that this ate the whole ``vector_rule`` win.

This module inverts the ownership (DESIGN.md §18, records "columnar from
birth" §2).  The preallocated struct-of-arrays — the ``[max_hosts, H]``
float32 feature matrix plus parallel columns for upload counters/limit,
peer count, ``updated_at`` timestamps, interned idc/location ids,
pre-scaled rule-score terms and per-slot write stamps — is authoritative
for any host *bound* to a slot.  ``scheduler.resource.Host`` becomes a
thin view: its hot-field properties read and write these columns
directly, announce decode (``SchedulerService.announce_host`` /
``register_peer`` → ``adopt``) writes columns on arrival, and the serve
path is a pure fancy-index gather — no attribute walk, no
``to_record()``, and **no stamp-miss refresh on the steady state**.

Ownership & invalidation rules:

- **bind (adopt/first serve)** — an unbound host is claimed: shadow
  state is copied into a slot's columns, the feature row is computed
  once, and the host's accessors flip to column views.  Flipping holds
  the store lock then the host lock (lock order §16).
- **write-through** — every mutator (upload accounting, ``touch``,
  property setters, peer add/remove) writes its column AND the derived
  cells (feature row entries 5-7, the pre-scaled rule upload-success /
  free-upload terms) with the same float math ``host_features`` uses,
  so the matrix row is always current and byte-identical to what the
  scalar oracle computes from the (column-backed) accessors.
- **detach (eviction / ``invalidate``)** — columns are copied back into
  the object's shadow attributes BEFORE the binding clears and the slot
  recycles, so no state is ever lost to churn; a departed host that
  re-announces rebinds from its shadows.
- **foreign entries** — a host already owned by ANOTHER store (two
  evaluators sharing hosts, tests) gets a stamped copy here (the cache-era form),
  validated against the host's ``_mut`` mutation counter; correctness is
  identical, only the owner gets the stamp-free fast path.

``_stamp_col`` records each slot's last write generation (the owner's
``_mut`` at write time) — ``validate_consistency`` compares it, plus a
full recompute of every bound row, to detect torn slot state (the chaos
drill's no-torn-rows assertion).

Lock ordering: store lock before any per-host lock; no caller may enter
the store while holding a host lock (mutators write columns under the
host lock only — single-cell writes race a concurrent gather exactly as
benignly as the scalar path's per-field reads at 50 different instants).
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict, namedtuple
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from ..records.features import HOST_FEATURE_DIM, _location_affinity, host_bucket
from ..records.features import host_features as _host_features
from ..utils.types import HostType
from . import metrics

if TYPE_CHECKING:  # lock-graph resolver type (§16): Host._mu nests under _mu
    from .resource import Host

# Label-bound metric children: the kwargs-dict label resolution is paid
# once at import, not per announce (utils.metrics._CounterChild).
_CACHE_HIT = metrics.EVAL_CACHE_TOTAL.labels(result="hit")
_CACHE_MISS = metrics.EVAL_CACHE_TOTAL.labels(result="miss")

# rule_serve packs (host slot | peer encoding << 32) into one int per
# parent; slot ids are therefore capped at 2^32 (max_hosts bound).
_SLOT_MASK = np.int64(0xFFFFFFFF)


class _ForeignHost(Exception):
    """Raised inside the lock-free gather's fromiter when a candidate is
    not owner-bound here — aborts the optimistic pass."""


def _foreign():
    raise _ForeignHost

# Rule-evaluator weights (scheduler/evaluator.py base weights), baked into
# the pre-scaled columns/tables so the serve-side weighted sum is pure
# adds.  0.2 * us and 0.15 * fs computed at WRITE time are bit-identical
# to the scalar path computing them at evaluate time from the same ints.
_W_PIECE = 0.2
_W_UPLOAD_SUCCESS = 0.2
_W_FREE_UPLOAD = 0.15
_W_AFFINITY = 0.15
# 0.15 * host_type_score for a NORMAL host (score = MAX_SCORE * 0.5):
# both products are exact-double-identical to the scalar path's.
_W_HT_NORMAL = 0.15 * 0.5

# One announce's ML-path cache product: everything the featurizer needs
# that is a function of host identity/state alone, gathered in one locked
# sweep.  ``rows``/``child_row`` are private copies (fancy-indexed out of
# the slot matrix), never views into it.  ``src_slots``/``child_slot``
# feed the fused gather+score kernel (ops/fused_score.py); they are None
# on the uncached overflow path.
ServingGather = namedtuple(
    "ServingGather",
    (
        "child_row",      # [H] float32
        "rows",           # [n, H] float32, one per parent host
        "src_buckets",    # [n] int64 hash buckets (parents)
        "dst_bucket",     # int hash bucket (child)
        "same_idc",       # [n] float64 — 1.0 iff non-empty EXACT idc match
        "location_affinity",  # [n] float64 — shared '|'-prefix fraction
        "src_slots",      # [n] intp slot ids (None when served uncached)
        "child_slot",     # int slot id (-1 when served uncached)
        "n_hits",
        "n_misses",
    ),
)

# One announce's RULE-path gather: pre-scaled weighted terms straight off
# the columns — the weighted sum is then ~6 numpy adds (evaluator.py).
# The ONE python pass over the candidates resolves slots AND encodes the
# two peer-side inputs into ``peer_enc`` (finished count << 1 | elevated
# fsm state): a single int per peer, no tuple allocation, one fromiter.
RuleGather = namedtuple(
    "RuleGather",
    (
        # [n, 4] float64 — pre-scaled per-HOST terms, one fancy index:
        # (0.2*upload_success, 0.15*free_upload, host-type base,
        #  host-type elevated multiplier).
        "w_host",
        # [n, 2] float64 — pre-scaled per-(idc, location)-PAIR terms,
        # one gather from the per-child pair table:
        # (0.15*idc_affinity, 0.15*location_affinity).
        "w_aff",
        # [n] float64 — the EXACT 0.15 * host_type_score product for
        # each (host type, peer elevated-state) combination.
        "w_ht",
        "peer_enc",      # [n] int64   — finished_pieces << 1 | elevated
        "slots",         # [n] int64
        "n_hits",
        "n_misses",
    ),
)


class HostFeatureCache:
    """Columnar host store: slot columns are authoritative for bound
    hosts; the class name survives from the cache design because every consumer
    (config, CLI wiring, tests) addresses it by this name.

    The first store constructed in a process (while no other is alive)
    is the PRIMARY: hosts it binds additionally carry their slot as a
    plain ``Host._pslot`` attribute, which the lock-free rule gather
    validates with one attribute read per candidate.  A scheduler
    process has exactly one store (the composition root builds it), so
    production serving always runs primary; extra stores (tests, tools)
    stay fully correct through the binding-tuple path."""

    _primary_ref = None  # weakref to the process's primary store

    def __init__(self, max_hosts: int = 65536) -> None:
        import weakref

        prim = HostFeatureCache._primary_ref
        self._is_primary = prim is None or prim() is None
        if self._is_primary:
            HostFeatureCache._primary_ref = weakref.ref(self)
        self.max_hosts = max_hosts
        self._mu = threading.Lock()
        # host id -> (slot, stamp); stamp None == owner-bound (stamp-free
        # fast path), else the host's _mut at copy time (foreign entry).
        self._entries: "OrderedDict[str, Tuple[int, Optional[int]]]" = OrderedDict()
        # -- the struct-of-arrays (DF012 contract featcache.hoststate) --
        # Zeroed, not left uninitialized as in the reference: the scorer
        # batcher pads a flush with rows of slot 0, the last slot the free
        # list hands out, so K1 reads row 0 long before any host is bound
        # there (an uninitialized row scored NaN on the card).
        self._matrix = np.zeros((max_hosts, HOST_FEATURE_DIM), dtype=np.float32)
        self._bucket_col = np.empty(max_hosts, dtype=np.int64)
        self._idc_col = np.empty(max_hosts, dtype=np.int64)
        self._idc_ci_col = np.empty(max_hosts, dtype=np.int64)
        self._loc_col = np.empty(max_hosts, dtype=np.int64)
        self._upload_count_col = np.zeros(max_hosts, dtype=np.int64)
        self._upload_failed_col = np.zeros(max_hosts, dtype=np.int64)
        self._concurrent_upload_col = np.zeros(max_hosts, dtype=np.int64)
        self._upload_limit_col = np.zeros(max_hosts, dtype=np.int64)
        self._peer_count_col = np.zeros(max_hosts, dtype=np.int64)
        self._updated_at_col = np.zeros(max_hosts, dtype=np.float64)
        # Pre-scaled rule-score terms, ONE row per slot so the rule
        # gather is a single [n, 4] fancy index: columns are
        # (0.2*upload_success, 0.15*free_upload, host-type base term,
        # host-type elevated multiplier) — see _derive_upload_cells.
        self._rule_w_cols = np.zeros((max_hosts, 4), dtype=np.float64)
        self._type_normal_col = np.zeros(max_hosts, dtype=np.int8)
        # Interned (idc_ci, location) PAIR id per slot: the two affinity
        # terms gather from one per-child-pair [P, 2] table row.
        self._pair_col = np.zeros(max_hosts, dtype=np.int64)
        self._stamp_col = np.zeros(max_hosts, dtype=np.int64)
        # Owner Host object per slot (None for foreign/free slots) — the
        # eviction path needs the object to copy columns back into.
        self._slot_host: List[Optional[object]] = [None] * max_hosts
        # Stack of recyclable row slots; pop() hands out high slots first.
        self._free: List[int] = list(range(max_hosts))
        # Interning tables.  The idc/location vocabulary is the fleet's
        # topology labels — bounded by deployment shape, not host count.
        # The ci (case-insensitive) idc table serves the RULE affinity
        # (evaluator.idc_affinity_score lowercases); the exact table
        # serves the ML feature's exact-match semantics.
        self._idcs: List[str] = []
        self._idc_ids: Dict[str, int] = {}
        self._idcs_ci: List[str] = []
        self._idc_ci_ids: Dict[str, int] = {}
        self._locs: List[str] = []
        self._loc_ids: Dict[str, int] = {}
        # child loc id -> affinity row over the loc vocabulary (float64),
        # extended lazily as the vocabulary grows; at most vocab² floats.
        # _aff_rows: ML semantics (records.features._location_affinity);
        # _pair_rows: rule semantics pre-scaled by 0.15 (per pair id).
        self._aff_rows: Dict[int, np.ndarray] = {}
        # (ci idc id, loc id) pair vocabulary + per-child-pair [P, 2]
        # tables holding (0.15*idc_affinity, 0.15*location_affinity) —
        # both rule affinity terms come out of ONE gather.
        self._pairs: List[Tuple[int, int]] = []
        self._pair_ids: Dict[Tuple[int, int], int] = {}
        self._pair_rows: Dict[int, np.ndarray] = {}
        # Bumped on every row/cell write: the fused scorer's device
        # mirror (ops/fused_score.py) syncs against it per flush.
        self._row_version = 0
        # Slot-TOPOLOGY seqlock for the lock-free rule fast path: odd
        # while a detach/recycle is in progress, +2 per completed one.
        # Value writes do NOT bump it — single-cell write races are the
        # accepted snapshot envelope; only slot reuse (which would hand a
        # gather another host's row) must be detected.
        self._epoch = 0
        # Slots resolved by the sweep currently holding the lock: the
        # eviction path must not recycle them mid-sweep (a gathered slot
        # changing hosts under the sweep would fancy-index another
        # host's row).  Only ever touched under the store lock.
        self._sweep_slots: Optional[List[int]] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- interning -----------------------------------------------------------

    def _intern_locked(self, s: str, strings: List[str], ids: Dict[str, int]) -> int:
        i = ids.get(s)
        if i is None:
            i = len(strings)
            strings.append(s)
            ids[s] = i
        return i

    # -- write-through (called by Host mutators, host lock held) -------------

    def write_upload_state(
        self,
        slot: int,
        mut: int,
        *,
        upload_count: Optional[int] = None,
        upload_failed_count: Optional[int] = None,
        concurrent_upload_count: Optional[int] = None,
        concurrent_upload_limit: Optional[int] = None,
    ) -> None:
        """Write upload-counter columns AND every cell derived from them:
        feature-row entries 5-7 (same float math as
        ``records.features.host_features``) and the pre-scaled rule
        upload-success / free-upload terms — so the matrix row and rule
        columns are always current and the serve path never refreshes."""
        if upload_count is not None:
            self._upload_count_col[slot] = upload_count
        if upload_failed_count is not None:
            self._upload_failed_col[slot] = upload_failed_count
        if concurrent_upload_count is not None:
            self._concurrent_upload_col[slot] = concurrent_upload_count
        if concurrent_upload_limit is not None:
            self._upload_limit_col[slot] = concurrent_upload_limit
        self._derive_upload_cells(slot)
        self._stamp_col[slot] = mut
        self._row_version += 1

    def _derive_upload_cells(self, slot: int) -> None:
        uploads = int(self._upload_count_col[slot])
        failed = int(self._upload_failed_col[slot])
        conc = int(self._concurrent_upload_col[slot])
        limit = int(self._upload_limit_col[slot])
        # Feature cells — records.features.host_features lines, verbatim
        # math (python float64, one float32 rounding on assignment).
        lim = max(limit, 1)
        self._matrix[slot, 5] = min(conc / lim, 4.0)
        total = max(uploads, 1)
        self._matrix[slot, 6] = 1.0 - min(failed / total, 1.0)
        self._matrix[slot, 7] = math.log1p(max(uploads, 0))
        # Pre-scaled rule terms — evaluator.upload_success_score /
        # free_upload_score × their evaluate() weights, verbatim math.
        if uploads < failed:
            us = 0.0
        elif uploads == 0 and failed == 0:
            us = 1.0
        else:
            us = (uploads - failed) / uploads
        self._rule_w_cols[slot, 0] = _W_UPLOAD_SUCCESS * us
        free = limit - conc
        if limit > 0 and free > 0:
            self._rule_w_cols[slot, 1] = _W_FREE_UPLOAD * (free / limit)
        else:
            self._rule_w_cols[slot, 1] = 0.0

    def write_updated_at(self, slot: int, mut: int, ts: float) -> None:
        self._updated_at_col[slot] = ts
        self._stamp_col[slot] = mut
        self._row_version += 1

    def write_peer_count(self, slot: int, n: int) -> None:
        self._peer_count_col[slot] = n
        self._row_version += 1

    # -- bind / detach -------------------------------------------------------

    def _fill_slot_locked(self, h: "Host", slot: int, stamp: Optional[int]) -> None:
        """Write EVERY column of ``slot`` from the host's current state.
        For a bind, reads hit the shadows (host still unbound); for a
        foreign copy, reads go through the accessors (and therefore the
        owning store's columns)."""
        rec = h.to_record()
        self._matrix[slot] = _host_features(rec)
        self._bucket_col[slot] = host_bucket(h.id)
        idc = h.stats.network.idc
        loc = h.stats.network.location
        self._idc_col[slot] = self._intern_locked(idc, self._idcs, self._idc_ids)
        self._idc_ci_col[slot] = self._intern_locked(
            idc.lower(), self._idcs_ci, self._idc_ci_ids
        )
        self._loc_col[slot] = self._intern_locked(loc, self._locs, self._loc_ids)
        pair = (int(self._idc_ci_col[slot]), int(self._loc_col[slot]))
        pid = self._pair_ids.get(pair)
        if pid is None:
            pid = len(self._pairs)
            self._pairs.append(pair)
            self._pair_ids[pair] = pid
        self._pair_col[slot] = pid
        self._upload_count_col[slot] = rec.upload_count
        self._upload_failed_col[slot] = rec.upload_failed_count
        self._concurrent_upload_col[slot] = rec.concurrent_upload_count
        self._upload_limit_col[slot] = rec.concurrent_upload_limit
        self._peer_count_col[slot] = len(h.peers)
        self._updated_at_col[slot] = h.updated_at
        normal = h.type is HostType.NORMAL
        self._type_normal_col[slot] = 1 if normal else 0
        # Host-type term indexed by the peer's elevated bit: column
        # 2 + elev holds the EXACT scalar product 0.15*host_type_score —
        # NORMAL scores 0.15*0.5 either way, non-NORMAL 0.0 / 0.15.
        self._rule_w_cols[slot, 2] = _W_HT_NORMAL if normal else 0.0
        self._rule_w_cols[slot, 3] = _W_HT_NORMAL if normal else _W_AFFINITY
        self._derive_upload_cells(slot)
        self._stamp_col[slot] = h._mut if stamp is None else stamp
        self._row_version += 1

    def _alloc_slot_locked(self) -> int:
        if self._free:
            return self._free.pop()
        # Evict the least-recently-ENTERED id; a bound owner is detached
        # (columns copied back) so churn never loses state.  Slots the
        # current sweep already resolved are rotated to the back instead
        # of recycled — guaranteed to terminate because serve() rejects
        # candidate sets larger than the store (n + 1 ≤ max_hosts).
        guard = self._sweep_slots
        for _ in range(len(self._entries)):
            evicted_id, (slot, stamp) = self._entries.popitem(last=False)
            if guard is not None and any(
                (x & 0xFFFFFFFF) == slot for x in guard
            ):
                # Guard entries may be rule_serve's packed ints (slot in
                # the low 32 bits) or raw slots — the mask decodes both.
                self._entries[evicted_id] = (slot, stamp)
                continue
            self._epoch += 1  # seqlock: recycle in progress
            try:
                if stamp is None:
                    owner = self._slot_host[slot]
                    if owner is not None:
                        self._detach_locked(owner, slot)
                self._slot_host[slot] = None
                self.evictions += 1
            finally:
                self._epoch += 1
            return slot
        raise RuntimeError("columnar host store exhausted mid-sweep")

    def _bind_locked(self, h: "Host") -> int:
        """Claim ownership of an unbound host: columns become the source
        of truth; the accessors flip to column views."""
        slot = self._alloc_slot_locked()
        with h._mu:
            bound = h._cols is None
            if bound:
                self._fill_slot_locked(h, slot, None)
                h._cols = (self, slot)
                if self._is_primary:
                    h._pslot = slot
        if not bound:
            # Another store won the bind race between our unbound check
            # and here; serve it as a foreign copy instead (outside the
            # host lock — the foreign path may evict/detach OTHER hosts
            # and must not nest host locks).
            self._free.append(slot)
            return self._foreign_miss_locked(h)
        self._slot_host[slot] = h
        self._entries[h.id] = (slot, None)
        return slot

    def _detach_locked(self, h: "Host", slot: int) -> None:
        """Copy column state back into the object's shadows, then clear
        the binding.  Store lock held; takes the host lock (§16 order)."""
        with h._mu:
            h._upload_count = int(self._upload_count_col[slot])
            h._upload_failed_count = int(self._upload_failed_col[slot])
            h._concurrent_upload_count = int(self._concurrent_upload_col[slot])
            h._concurrent_upload_limit = int(self._upload_limit_col[slot])
            h._updated_at = float(self._updated_at_col[slot])
            h._pslot = -1
            h._cols = None

    def refresh_row(self, h: "Host") -> None:
        """Full row recompute for a bound host (the ``touch`` path —
        announce decode may have replaced stats wholesale).  Re-verifies
        the binding under the store lock: a raced detach falls back to a
        shadow timestamp write."""
        now = time.time()
        with self._mu:
            b = h._cols
            if b is None or b[0] is not self:
                h._updated_at = now
                return
            slot = b[1]
            self._fill_slot_locked(h, slot, None)
            self._updated_at_col[slot] = now

    def adopt(self, h: "Host") -> bool:
        """Announce decode writes columns on arrival: bind an unbound
        host (no-op when already bound here; a host owned elsewhere keeps
        its owner — this store will serve it via stamped copies).

        Returns True when THIS call bound the host — the bind just
        computed the full row from the current stats, so the announce
        path stamps ``updated_at`` instead of paying a second identical
        row fill (the double-fill showed up as ~1.75 fills/announce in
        the fleet-swarm profile)."""
        with self._mu:
            if h._cols is not None:
                return False
            before = self.misses
            self._slot_locked(h)
            # _slot_locked counts a miss exactly when it (re)computed the
            # row on the bind/foreign path; a hit means another store's
            # binding already serves it and the caller must still touch.
            return self.misses > before and h._cols is not None and h._cols[0] is self

    def stamp_row(self, h: "Host") -> None:
        """Freshness stamp for a row filled moments ago (the adopt→touch
        announce sequence): updates ``updated_at`` without recomputing
        feature cells.  Falls back to the shadow write on a raced
        detach, exactly like ``refresh_row``."""
        now = time.time()
        with self._mu:
            b = h._cols
            if b is None or b[0] is not self:
                h._updated_at = now
                return
            self._updated_at_col[b[1]] = now

    # -- slot resolution -----------------------------------------------------

    def _foreign_miss_locked(self, h: "Host") -> int:
        """Stamped copy (the cache-era form) for a host owned by another store.
        Stamp is read BEFORE copying: a host mutating mid-copy leaves a
        newer _mut behind, so the next lookup recomputes — this store can
        never serve a copy fresher than its stamp."""
        stamp = h._mut
        old = self._entries.get(h.id)
        if old is not None:
            slot = old[0]
        else:
            slot = self._alloc_slot_locked()
        self._fill_slot_locked(h, slot, stamp)
        self._slot_host[slot] = None
        self._entries[h.id] = (slot, stamp)
        self._entries.move_to_end(h.id)
        return slot

    def _slot_locked(self, h: "Host") -> int:
        b = h._cols
        if b is not None:
            if b[0] is self:
                # Owner fast path: NO stamp compare, NO dict lookup — the
                # columns are maintained by write-through.
                self.hits += 1
                return b[1]
            e = self._entries.get(h.id)
            if e is not None and e[1] == h._mut:
                self.hits += 1
                return e[0]
            self.misses += 1
            return self._foreign_miss_locked(h)
        # Unbound: claim ownership.
        e = self._entries.get(h.id)
        if e is not None:
            # Stale entry from a previous binding epoch (detached by
            # eviction elsewhere, or a foreign owner released) — rebuild.
            self._entries.pop(h.id, None)
            self._free.append(e[0])
            self._slot_host[e[0]] = None
        self.misses += 1
        return self._bind_locked(h)

    # -- affinity tables -----------------------------------------------------

    def _aff_row_locked(self, loc_id: int) -> np.ndarray:
        """ML semantics: affinity of ``loc_id`` against every interned
        location — each cell is the SAME ``_location_affinity`` the
        featurizer calls per pair, so lookups are byte-identical."""
        row = self._aff_rows.get(loc_id)
        if row is None or len(row) < len(self._locs):
            src = self._locs[loc_id]
            row = np.fromiter(
                (_location_affinity(src, dst) for dst in self._locs),
                np.float64,
                count=len(self._locs),
            )
            self._aff_rows[loc_id] = row
        return row

    def _pair_row_locked(self, child_pair: int) -> np.ndarray:
        """Rule semantics, PRE-SCALED, keyed by the child's interned
        (idc_ci, location) PAIR id: row j holds
        ``(0.15 * idc_affinity_score, 0.15 * location_affinity_score)``
        of pair j against the child — the exact products the scalar
        evaluate computes per parent, so BOTH affinity terms come out of
        one [n, 2] gather.  Rows extend lazily as the pair vocabulary
        grows; at most pairs² × 2 floats."""
        row = self._pair_rows.get(child_pair)
        if row is None or row.shape[0] < len(self._pairs):
            from .evaluator import location_affinity_score  # lazy: no cycle

            cci, cloc = self._pairs[child_pair]
            child_has_idc = self._idcs_ci[cci] != ""
            child_loc = self._locs[cloc]
            n_pairs = len(self._pairs)
            row = np.empty((n_pairs, 2), dtype=np.float64)
            for j, (ci, lj) in enumerate(self._pairs):
                row[j, 0] = _W_AFFINITY * (
                    1.0 if (child_has_idc and ci == cci) else 0.0
                )
                row[j, 1] = _W_AFFINITY * location_affinity_score(
                    self._locs[lj], child_loc
                )
            self._pair_rows[child_pair] = row
        return row

    # -- serving surfaces ----------------------------------------------------

    def serve(self, child_host, hosts) -> ServingGather:
        """ONE locked sweep per announce for the ML featurizer: the
        Python loop only resolves slot indices (binding reads, no stamp
        tuples); rows, hash buckets and the vectorized idc/location
        affinity terms all come out as fancy-index gathers."""
        n = len(hosts)
        if n + 1 > self.max_hosts:
            # A candidate set larger than the store would evict-and-reuse
            # slots mid-sweep; serve it uncached (never hit in practice —
            # filter_parent_limit is orders below max_hosts).
            return self._serve_uncached(child_host, hosts)
        with self._mu:
            hits0 = self.hits  # inside the lock: counters are shared
            sweep: List[int] = []
            self._sweep_slots = sweep
            try:
                cslot = self._slot_locked(child_host)
                sweep.append(cslot)
                slot_of = self._slot_locked
                append = sweep.append
                n_hit = 0
                for h in hosts:
                    # Owner fast path inlined: binding read + identity
                    # check per candidate (the per-candidate stamp-tuple
                    # compare this store no longer needs).
                    b = h._cols
                    if b is not None and b[0] is self:
                        n_hit += 1
                        append(b[1])
                    else:
                        append(slot_of(h))
                self.hits += n_hit
            finally:
                self._sweep_slots = None
            idx = np.asarray(sweep[1:], dtype=np.intp)
            rows = self._matrix[idx]             # fancy index == copy
            child_row = self._matrix[cslot].copy()
            src_buckets = self._bucket_col[idx]
            dst_bucket = int(self._bucket_col[cslot])
            child_idc = self._idc_col[cslot]
            if self._idcs[child_idc]:
                same_idc = (self._idc_col[idx] == child_idc).astype(np.float64)
            else:
                same_idc = np.zeros(n, dtype=np.float64)
            location_affinity = self._aff_row_locked(
                int(self._loc_col[cslot])
            )[self._loc_col[idx]]
            n_hits = self.hits - hits0
        n_misses = (n + 1) - n_hits
        _CACHE_HIT.inc(n_hits)
        _CACHE_MISS.inc(n_misses)
        return ServingGather(
            child_row, rows, src_buckets, dst_bucket, same_idc,
            location_affinity, idx, int(cslot), n_hits, n_misses,
        )

    def rule_serve(self, child_host, parents) -> RuleGather:
        """The RULE evaluator's gather: pre-scaled weighted terms off the
        columns — no per-parent Python scoring calls (the attribute
        gathers that kept ``vector_rule`` at ~1×).  ``parents`` are
        PEERS: the single python pass resolves each parent's host slot
        AND encodes the peer-side inputs.

        Steady state (every host owner-bound here, pair table warm) runs
        LOCK-FREE under a slot-topology seqlock: 32 announcer threads on
        a GIL'd box were losing ~35% to store-lock convoy, and the only
        hazard a lock protects against that value-races don't already
        cover is slot RECYCLING — which ``_epoch`` detects, discarding
        the optimistic gather and retrying under the lock."""
        n = len(parents)
        if n + 1 > self.max_hosts:
            return self._rule_serve_uncached(child_host, parents)
        with self._mu:
            hits0 = self.hits
            # ONE append per parent: low 32 bits = host slot, high bits =
            # the peer encoding (finished << 1 | elevated).  The eviction
            # guard decodes with the same mask (_SLOT_MASK).
            sweep: List[int] = []
            self._sweep_slots = sweep
            try:
                cslot = self._slot_locked(child_host)
                sweep.append(cslot)
                slot_of = self._slot_locked
                append = sweep.append
                n_hit = 0
                for p in parents:
                    b = p.host._cols
                    if b is not None and b[0] is self:
                        n_hit += 1
                        append(b[1] | p._enc << 32)
                    else:
                        append(slot_of(p.host) | p._enc << 32)
                self.hits += n_hit
            finally:
                self._sweep_slots = None
            packed = np.asarray(sweep, dtype=np.int64)[1:]
            idx = packed & _SLOT_MASK
            enc = packed >> 32
            w_host = self._rule_w_cols[idx]
            w_ht = self._rule_w_cols[idx, 2 + (enc & 1)]
            w_aff = self._pair_row_locked(
                int(self._pair_col[cslot])
            )[self._pair_col[idx]]
            n_hits = self.hits - hits0
        n_misses = (n + 1) - n_hits
        _CACHE_HIT.inc(n_hits)
        if n_misses:  # steady state is all-hit: skip the zero inc
            _CACHE_MISS.inc(n_misses)
        return RuleGather(w_host, w_aff, w_ht, enc, idx, n_hits, n_misses)

    def rule_scores(self, child, parents, total_piece_count):  # dflint: hotpath
        """Lock-free steady-state rule scoring (the whole announce in
        one function): valid only when the child and every parent host
        are owner-bound HERE and the child's pair row is already built —
        any other condition, or a slot recycle observed via the seqlock,
        returns None and the caller runs the locked ``rule_serve`` +
        shared math instead.  Value-level races (a counter write landing
        mid-gather) are the same accepted envelope as the scalar path's
        per-instant reads.  The arithmetic sequence is bit-identical to
        ``Evaluator.evaluate``'s term order (asserted per element in
        tests/test_sched_vectorized.py)."""
        n = len(parents)
        if not n or n + 1 > self.max_hosts:
            return None
        epoch0 = self._epoch
        if epoch0 & 1:
            return None
        cslot = child.host._pslot
        if cslot < 0 or not self._is_primary:
            return None
        try:
            # One attribute read validates ownership per candidate:
            # _pslot ≥ 0 ⟺ owner-bound to the (unique) primary store.
            packed = np.fromiter(
                (
                    (s | p._enc << 32)
                    if (s := p.host._pslot) >= 0
                    else _foreign()
                    for p in parents
                ),
                np.int64,
                count=n,
            )
        except _ForeignHost:
            return None
        idx = packed & _SLOT_MASK
        w = self._rule_w_cols[idx]
        w_ht = self._rule_w_cols[idx, 2 + ((packed >> 32) & 1)]
        row = self._pair_rows.get(int(self._pair_col[cslot]))
        if row is None:
            return None
        try:
            w_aff = row[self._pair_col[idx]]
        except IndexError:
            # Pair vocabulary grew past this row build; locked path
            # rebuilds the row.
            return None
        if self._epoch != epoch0:
            return None  # a slot recycled under us: discard, go locked
        # Counter updates race-lossy here by design (stats, not truth).
        self.hits += n + 1
        _CACHE_HIT.inc(n + 1)
        # packed >> 33 == finished-piece count (enc = fin << 1 | elev).
        counts = packed >> 33
        if total_piece_count > 0:
            score = _W_PIECE * (counts / total_piece_count)
        else:
            score = _W_PIECE * (counts - child.finished_piece_count())
        np.add(score, w[:, 0], out=score)
        np.add(score, w[:, 1], out=score)
        np.add(score, w_ht, out=score)
        np.add(score, w_aff[:, 0], out=score)
        np.add(score, w_aff[:, 1], out=score)
        return score

    def _rule_serve_uncached(self, child_host, parents) -> RuleGather:
        """Overflow path: the same pre-scaled terms from accessor reads
        (value-identical — the accessors read the owning columns)."""
        from .evaluator import (  # lazy: no import cycle
            free_upload_score,
            host_type_score,
            idc_affinity_score,
            location_affinity_score,
            upload_success_score,
        )

        n = len(parents)
        child_idc = child_host.stats.network.idc
        child_loc = child_host.stats.network.location
        w_host = np.fromiter(
            (
                (
                    _W_UPLOAD_SUCCESS * upload_success_score(p),
                    _W_FREE_UPLOAD * free_upload_score(p),
                    _W_HT_NORMAL if p.host.type is HostType.NORMAL else 0.0,
                    _W_HT_NORMAL
                    if p.host.type is HostType.NORMAL
                    else _W_AFFINITY,
                )
                for p in parents
            ),
            dtype=np.dtype((np.float64, 4)),
            count=n,
        )
        w_ht = np.fromiter(
            (_W_AFFINITY * host_type_score(p) for p in parents),
            np.float64, count=n,
        )
        w_aff = np.fromiter(
            (
                (
                    _W_AFFINITY
                    * idc_affinity_score(p.host.stats.network.idc, child_idc),
                    _W_AFFINITY
                    * location_affinity_score(
                        p.host.stats.network.location, child_loc
                    ),
                )
                for p in parents
            ),
            dtype=np.dtype((np.float64, 2)),
            count=n,
        )
        peer_enc = np.fromiter((p._enc for p in parents), np.int64, count=n)
        _CACHE_MISS.inc(n + 1)
        with self._mu:
            self.misses += n + 1
        return RuleGather(w_host, w_aff, w_ht, peer_enc, None, 0, n + 1)

    def _serve_uncached(self, child_host, hosts) -> ServingGather:
        child_row = _host_features(child_host.to_record())
        rows = np.stack([_host_features(h.to_record()) for h in hosts])
        src_buckets = np.asarray([host_bucket(h.id) for h in hosts], np.int64)
        child_idc = child_host.stats.network.idc
        same_idc = np.asarray(
            [
                1.0 if (child_idc and child_idc == h.stats.network.idc) else 0.0
                for h in hosts
            ],
            np.float64,
        )
        child_loc = child_host.stats.network.location
        location_affinity = np.asarray(
            [_location_affinity(child_loc, h.stats.network.location) for h in hosts],
            np.float64,
        )
        n = len(hosts)
        _CACHE_MISS.inc(n + 1)
        with self._mu:
            self.misses += n + 1
        return ServingGather(
            child_row, rows, src_buckets, host_bucket(child_host.id),
            same_idc, location_affinity, None, -1, 0, n + 1,
        )

    def features(self, host) -> np.ndarray:
        with self._mu:
            hit = self.hits
            slot = self._slot_locked(host)
            row = self._matrix[slot].copy()  # copy: slots get recycled
            hit = self.hits - hit
        (_CACHE_HIT if hit else _CACHE_MISS).inc()
        return row

    def gather(self, hosts) -> np.ndarray:  # dflint: hotpath
        """[n, HOST_FEATURE_DIM] float32 — one row per host, one
        fancy-index copy; metrics batched into two counter bumps."""
        return self.gather_with_buckets(hosts)[0]

    def gather_with_buckets(self, hosts) -> Tuple[np.ndarray, np.ndarray]:
        """(features [n, H] float32, hash buckets [n] int64) in one
        locked sweep."""
        n = len(hosts)
        if not n:
            return (
                np.zeros((0, HOST_FEATURE_DIM), dtype=np.float32),
                np.zeros(0, dtype=np.int64),
            )
        if n > self.max_hosts:
            sv = self._serve_uncached(hosts[0], hosts)
            return sv.rows, sv.src_buckets
        with self._mu:
            hits0 = self.hits  # inside the lock: counters are shared
            sweep: List[int] = []
            self._sweep_slots = sweep
            try:
                slot_of = self._slot_locked
                for h in hosts:
                    sweep.append(slot_of(h))
            finally:
                self._sweep_slots = None
            idx = np.asarray(sweep, dtype=np.intp)
            rows = self._matrix[idx]
            buckets = self._bucket_col[idx]
            n_hits = self.hits - hits0
        _CACHE_HIT.inc(n_hits)
        _CACHE_MISS.inc(n - n_hits)
        return rows, buckets

    def bucket(self, host) -> int:
        """Memoized ``host_bucket(host.id)`` (crc32 skipped on hits)."""
        with self._mu:
            entry = self._entries.get(host.id)
            if entry is not None:
                return int(self._bucket_col[entry[0]])
        return host_bucket(host.id)

    # -- fused-kernel mirror sync (ops/fused_score.py) ----------------------

    def matrix_snapshot(self) -> Tuple[int, np.ndarray]:
        """(row_version, coherent copy of the slot matrix) — the fused
        gather+score kernel keeps a device-resident mirror and re-uploads
        when the version moved (one locked copy per stale flush)."""
        with self._mu:
            return self._row_version, self._matrix.copy()

    # -- maintenance ---------------------------------------------------------

    def invalidate(self, host_id: str) -> None:
        """Departure (``SchedulerService.leave_host``): detach the owner
        binding (state copied back to the object) and free the slot."""
        with self._mu:
            entry = self._entries.pop(host_id, None)
            if entry is None:
                return
            slot, stamp = entry
            self._epoch += 1  # seqlock: recycle in progress
            try:
                if stamp is None:
                    owner = self._slot_host[slot]
                    if owner is not None:
                        self._detach_locked(owner, slot)
                self._slot_host[slot] = None
                self._free.append(slot)
            finally:
                self._epoch += 1

    def clear(self) -> None:
        with self._mu:
            self._epoch += 1  # seqlock: recycle in progress
            try:
                for slot, owner in enumerate(self._slot_host):
                    if owner is not None:
                        self._detach_locked(owner, slot)
                        self._slot_host[slot] = None
                self._entries.clear()
                self._free = list(range(self.max_hosts))
            finally:
                self._epoch += 1

    def validate_consistency(self) -> List[str]:
        """Torn-slot-row detector (chaos drills, churn property tests):
        for every owner-bound slot, recompute the feature row and derived
        rule terms from the host's column-backed accessors and compare
        byte-for-byte against the stored columns; verify the write stamp
        matches the host's mutation counter.  Returns human-readable
        mismatch descriptions (empty == consistent)."""
        problems: List[str] = []
        with self._mu:
            checks = [
                (hid, slot)
                for hid, (slot, stamp) in self._entries.items()
                if stamp is None and self._slot_host[slot] is not None
            ]
            for hid, slot in checks:
                h = self._slot_host[slot]
                expect = _host_features(h.to_record())
                got = self._matrix[slot]
                if not np.array_equal(expect, got):
                    bad = [
                        i for i in range(HOST_FEATURE_DIM)
                        if expect[i] != got[i]
                    ]
                    problems.append(
                        f"{hid}: feature row cells {bad} differ from a "
                        f"recompute off the column-backed accessors"
                    )
                if self._stamp_col[slot] != h._mut:
                    problems.append(
                        f"{hid}: slot stamp {int(self._stamp_col[slot])} != "
                        f"host mutation counter {h._mut} (torn write)"
                    )
                us = self._rule_w_cols[slot, 0]
                fs = self._rule_w_cols[slot, 1]
                self._derive_upload_cells(slot)
                if (
                    us != self._rule_w_cols[slot, 0]
                    or fs != self._rule_w_cols[slot, 1]
                ):
                    problems.append(f"{hid}: stale derived rule columns")
        return problems

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
