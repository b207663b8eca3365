"""Multi-tenant QoS overload drill (DESIGN.md §26).

The headline question the ROADMAP asks: **does a 10× burst from tenant
B move tenant A's announce p99 and download TTLB?**  This module builds
the smallest REAL composition that can answer it on one box:

- one ``SchedulerService`` (columnar host store + rule evaluator)
  behind a ``ShardGuard`` + ``AdmissionController``;
- one seed ``Daemon`` holding every task's pieces (its UploadManager is
  the upload-path chokepoint);
- a tenant-A client daemon running REAL downloads (register → parents →
  piece fetch off the seed → batched reports) plus a measured announce
  loop;
- tenant-B flood threads driving announces and piece pulls flat-out.

Arms differ in ONE thing — whether the QoS plane is installed:

- ``shaped``   — the tenant_qos policy is live: B runs at the
  background class with an announce-rate cap and an upload-bandwidth
  cap; admission carries ``TenantAccounting`` so B's over-quota flood
  sheds first, and refusals carry Retry-After which B's drive loop
  HONORS (sleep-backoff — the real client protocol; shedding works
  because refusals are cheap AND pace the flood);
- ``unshaped`` — same traffic, tenant-blind admission, no caps: B's
  requests all pay full per-request cost and A contends head-on.

Per arm the drill reports tenant A's announce p50/p99 and download
TTLB, B's offered/shed/capped counts, and the seed's per-tenant byte
accounting.  ``run_isolation_drill`` runs baseline (A alone) + burst
arms and computes the MOVEMENT of A's metrics under burst — the <10%
shaped bar is the headline of the reference's tools/bench_qos.py (the
port's bench/bench_qos.py prints it with no regression guard).

Port of ``dragonfly2_tpu/sim/qos.py``, with the logic verbatim and two
keywords on ``_build``, ``_run_arm`` and ``run_isolation_drill`` that the
reference lacks:

- ``evaluator=``: a factory ``cache -> Evaluator`` over the drill's
  ``HostFeatureCache``.  ``None`` builds the reference's rule
  ``Evaluator(feature_cache=cache)``; an ``MLEvaluator`` over a
  ``FusedMLPScorer`` puts K1 on the drill's parent ranking.
- ``extra_parents=``: that many more tenant-A daemons (hosts
  ``qos-p-<i>``, in the same registry) download every one of A's tasks
  off the seed before the measured window, so each measured download
  ranks ``1 + extra_parents`` candidates (the reference's drill ranks one,
  the seed, which no evaluator scores).

With neither keyword the drill is the reference's, call for call.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..daemon.daemon import Daemon
from ..daemon.upload import UploadBusy
from ..qos import QoSPolicy, TenantAccounting
from ..scheduler import (
    AdmissionController,
    Evaluator,
    HostFeatureCache,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
    ShardGuard,
    ShardSaturatedError,
)
from ..scheduler.resource import Host
from ..utils.types import Priority

TENANT_A = "t-a"
TENANT_B = "t-b"


@dataclass
class QoSDrillConfig:
    a_announces: int = 1000        # measured tenant-A announce loop
    a_downloads: int = 6          # real downloads measured for TTLB
    pieces_per_task: int = 8
    piece_size: int = 64 * 1024
    b_threads: int = 2            # tenant-B flood threads
    burst_multiplier: int = 10    # offered B:A announce ratio target
    b_announce_qps: float = 50.0    # shaped: B's announce cap
    b_upload_rate: float = 1e6      # shaped: B-task upload cap (bytes/s)
    b_backoff_s: float = 0.15     # B's Retry-After honor cap (the drill
                                  # clamps the server's 1 s so arms finish)
    max_inflight: int = 256
    p99_budget_ms: float = 20.0
    seed: int = 7

    def policy(self) -> QoSPolicy:
        return QoSPolicy.from_payload({
            TENANT_A: {
                "tenant_class": "gold", "weight": 4.0, "priority": 0,
            },
            TENANT_B: {
                "tenant_class": "background", "weight": 1.0, "priority": 6,
                "announce_qps": self.b_announce_qps,
                "announce_burst": max(int(self.b_announce_qps / 4), 1),
                "upload_rate_bytes_s": self.b_upload_rate,
            },
        })


def _host(name: str, i: int) -> Host:
    h = Host(
        id=f"{name}-{i}", hostname=f"{name}-{i}",
        ip=f"10.9.{i >> 8 & 255}.{i & 255}", port=8002, download_port=8001,
        concurrent_upload_limit=64,
    )
    h.stats.network.idc = "idc-qos"
    return h


class _Origin:
    """Deterministic piece-addressable origin content."""

    def __init__(self, piece_size: int) -> None:
        self.piece_size = piece_size

    def fetch(self, url: str, number: int, piece_size: int) -> bytes:
        # crc32, not builtin hash(): str hashing is salted by
        # PYTHONHASHSEED, which made "deterministic" origin content
        # differ between processes (DESIGN.md §27 seed-sweep gate).
        seed = (zlib.crc32(url.encode()) ^ number) & 0xFF
        return bytes((seed + i) % 256 for i in range(self.piece_size))


@dataclass
class _ArmState:
    service: SchedulerService
    admission: AdmissionController
    seed: Daemon
    client_a: Daemon
    registry: Dict[str, Daemon]
    workdir: str
    a_urls: List[str] = field(default_factory=list)
    b_urls: List[str] = field(default_factory=list)
    warm_url: str = "https://origin.qos/warm"


EvaluatorFactory = Callable[[HostFeatureCache], Evaluator]


def _rule_evaluator(cache: HostFeatureCache) -> Evaluator:
    return Evaluator(feature_cache=cache)


def _build(
    cfg: QoSDrillConfig,
    *,
    shaped: bool,
    workdir: str,
    evaluator: Optional[EvaluatorFactory] = None,
    extra_parents: int = 0,
) -> _ArmState:
    policy = cfg.policy() if shaped else None
    accounting = TenantAccounting(policy) if shaped else None
    admission = AdmissionController(
        max_inflight=cfg.max_inflight,
        p99_budget_s=cfg.p99_budget_ms / 1e3,
        accounting=accounting,
    )
    guard = ShardGuard("qos-shard", admission=admission)
    cache = HostFeatureCache(max_hosts=4096)
    service = SchedulerService(
        Resource(),
        Scheduling(
            (evaluator or _rule_evaluator)(cache),
            SchedulingConfig(retry_interval=0),
        ),
        None,
        None,
        shard_guard=guard,
    )
    if shaped:
        service.set_qos_policy(policy)
    registry: Dict[str, Daemon] = {}
    origin = _Origin(cfg.piece_size)
    seed = Daemon(
        _host("qos-seed", 0), service, storage_root=f"{workdir}/seed",
        daemon_registry=registry, source_fetcher=origin,
    )
    if shaped:
        seed.set_qos_policy(policy)
    client_a = Daemon(
        _host("qos-a", 0), service, storage_root=f"{workdir}/a",
        daemon_registry=registry, tenant=TENANT_A,
    )
    state = _ArmState(
        service=service, admission=admission, seed=seed, client_a=client_a,
        registry=registry, workdir=workdir,
    )
    # Seed every task's content ahead of the measured window; stamp task
    # ownership on the seed's upload gate (production: the requesting
    # tenant's job/daemon stamps it) so serves account — and, shaped,
    # throttle — against the OWNING tenant.
    content = cfg.pieces_per_task * cfg.piece_size
    for i in range(cfg.a_downloads):
        url = f"https://origin.qos/a-{i}"
        state.a_urls.append(url)
    for i in range(max(2, cfg.a_downloads)):
        url = f"https://origin.qos/b-{i}"
        state.b_urls.append(url)
    from ..utils import idgen

    for url in state.a_urls + state.b_urls + [state.warm_url]:
        r = seed.download(
            url, piece_size=cfg.piece_size, content_length=content
        )
        if not r.ok:
            raise RuntimeError(f"seeding {url} failed")
    for url in state.a_urls:
        seed.upload.register_task_tenant(idgen.task_id(url), TENANT_A)
    for url in state.b_urls:
        seed.upload.register_task_tenant(idgen.task_id(url), TENANT_B)
    # More parents for A's tasks, before the measured window: each
    # extra daemon downloads every A task off the seed (and the extras
    # before it), so a measured download has 1 + extra_parents candidates.
    for i in range(extra_parents):
        extra = Daemon(
            _host("qos-p", i), service, storage_root=f"{workdir}/p{i}",
            daemon_registry=registry, tenant=TENANT_A,
        )
        for url in state.a_urls:
            r = extra.download(
                url, piece_size=cfg.piece_size, content_length=content,
                priority=Priority.LEVEL0,
            )
            if not r.ok:
                raise RuntimeError(f"extra parent {i} failed on {url}")
    return state


def _percentile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, int(q * (len(s) - 1) + 0.5))
    return s[idx]


def _run_arm(
    cfg: QoSDrillConfig,
    *,
    shaped: bool,
    burst: bool,
    evaluator: Optional[EvaluatorFactory] = None,
    extra_parents: int = 0,
) -> Dict[str, object]:
    """One arm: measured tenant-A workload, optional tenant-B flood."""
    workdir = tempfile.mkdtemp(prefix="qos-drill-")
    try:
        state = _build(
            cfg, shaped=shaped, workdir=workdir, evaluator=evaluator,
            extra_parents=extra_parents,
        )
        service, seed = state.service, state.seed
        from ..utils import idgen

        stop = threading.Event()
        b_stats = {"announces": 0, "sheds": 0, "pulls": 0, "throttled": 0}
        b_mu = threading.Lock()

        def b_flood(tid: int) -> None:
            """Tenant-B flood: announces + piece pulls every iteration,
            honoring Retry-After/backoff when BOTH are refused (the real
            client protocol — shedding protects tenant A because
            refusals are cheap AND pace the flood)."""
            hosts = [
                _host("qos-b", tid * 64 + i) for i in range(8)
            ]
            b_task = idgen.task_id(state.b_urls[tid % len(state.b_urls)])
            i = 0
            while not stop.is_set():
                i += 1
                refused = 0
                retry_after = cfg.b_backoff_s
                try:
                    service.announce_host(
                        hosts[i % len(hosts)], tenant=TENANT_B
                    )
                    with b_mu:
                        b_stats["announces"] += 1
                except ShardSaturatedError as exc:
                    refused += 1
                    retry_after = min(exc.retry_after_s, cfg.b_backoff_s)
                    with b_mu:
                        b_stats["sheds"] += 1
                try:
                    seed.upload.serve_piece(
                        b_task, i % cfg.pieces_per_task
                    )
                    with b_mu:
                        b_stats["pulls"] += 1
                except UploadBusy:
                    refused += 1
                    with b_mu:
                        b_stats["throttled"] += 1
                if refused == 2:
                    stop.wait(retry_after)

        threads = [
            threading.Thread(target=b_flood, args=(t,), daemon=True)
            for t in range(cfg.b_threads)
        ]
        if burst:
            for t in threads:
                t.start()

        # Measured tenant-A workload: the announce loop + real downloads.
        host_a = state.client_a.host
        announce_walls: List[float] = []
        a_sheds = 0
        download_walls: List[float] = []
        dl_every = max(1, cfg.a_announces // max(cfg.a_downloads, 1))
        content = cfg.pieces_per_task * cfg.piece_size
        # Unmeasured warmup: cold-path costs (first announce's column
        # bind, conductor thread spin-up) land outside the percentiles.
        for _ in range(min(50, cfg.a_announces // 4)):
            try:
                service.announce_host(host_a, tenant=TENANT_A)
            except ShardSaturatedError:
                pass
        state.client_a.download(
            state.warm_url, piece_size=cfg.piece_size, content_length=content,
            priority=Priority.LEVEL0,
        )
        for i in range(cfg.a_announces):
            t0 = time.perf_counter()
            try:
                service.announce_host(host_a, tenant=TENANT_A)
            except ShardSaturatedError:
                a_sheds += 1
            announce_walls.append(time.perf_counter() - t0)
            if i % dl_every == 0 and len(download_walls) < cfg.a_downloads:
                url = state.a_urls[len(download_walls)]
                t0 = time.perf_counter()
                r = state.client_a.download(
                    url, piece_size=cfg.piece_size, content_length=content,
                    priority=Priority.LEVEL0,
                )
                wall = time.perf_counter() - t0
                if r.ok:
                    download_walls.append(wall)
        stop.set()
        for t in threads:
            while t.is_alive():
                t.join(5.0)

        acct = state.admission.accounting
        out: Dict[str, object] = {
            "shaped": shaped,
            "burst": burst,
            "a_announce_p50_ms": round(
                _percentile(announce_walls, 0.50) * 1e3, 4
            ),
            "a_announce_p99_ms": round(
                _percentile(announce_walls, 0.99) * 1e3, 4
            ),
            "a_announces": len(announce_walls),
            "a_sheds": a_sheds,
            "a_downloads_ok": len(download_walls),
            # Median TTLB: robust to the conductor's piece-poll hiccups
            # (a single 50 ms poll sleep would wreck a small-N mean).
            "a_ttlb_ms": round(_percentile(download_walls, 0.50) * 1e3, 3),
            "a_ttlb_p90_ms": round(_percentile(download_walls, 0.90) * 1e3, 3),
            "b_offered": b_stats["announces"] + b_stats["sheds"],
            "b_announces": b_stats["announces"],
            "b_sheds": b_stats["sheds"],
            "b_pulls": b_stats["pulls"],
            "b_throttled": b_stats["throttled"],
            "seed_tenant_bytes": dict(seed.upload.tenant_bytes),
            "seed_throttled": seed.upload.throttled_count,
            "tenant_accounting": acct.snapshot() if acct is not None else {},
        }
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_isolation_drill(
    cfg: Optional[QoSDrillConfig] = None,
    *,
    evaluator: Optional[EvaluatorFactory] = None,
    extra_parents: int = 0,
) -> Dict[str, object]:
    """baseline (A alone) → unshaped burst → shaped burst; movements of
    A's announce p99 and TTLB vs baseline per arm.  The shaped bar the
    bench guards: both movements < 10%."""
    cfg = cfg or QoSDrillConfig()
    kw = {"evaluator": evaluator, "extra_parents": extra_parents}
    baseline = _run_arm(cfg, shaped=False, burst=False, **kw)
    unshaped = _run_arm(cfg, shaped=False, burst=True, **kw)
    shaped = _run_arm(cfg, shaped=True, burst=True, **kw)

    def movement(arm: Dict[str, object], key: str) -> float:
        base = float(baseline[key]) or 1e-9
        return round((float(arm[key]) - base) / base * 100.0, 2)

    return {
        "config": {
            "a_announces": cfg.a_announces,
            "a_downloads": cfg.a_downloads,
            "pieces_per_task": cfg.pieces_per_task,
            "piece_size": cfg.piece_size,
            "b_threads": cfg.b_threads,
            "burst_multiplier": cfg.burst_multiplier,
            "seed": cfg.seed,
        },
        "baseline": baseline,
        "unshaped": unshaped,
        "shaped": shaped,
        "movement": {
            "unshaped_announce_p99_pct": movement(
                unshaped, "a_announce_p99_ms"
            ),
            "unshaped_ttlb_pct": movement(unshaped, "a_ttlb_ms"),
            "shaped_announce_p99_pct": movement(shaped, "a_announce_p99_ms"),
            "shaped_ttlb_pct": movement(shaped, "a_ttlb_ms"),
        },
    }


# -- seed-sweep reproducibility (DESIGN.md §27) ------------------------------

# Arm-report keys that COUNT simulated behavior rather than measure wall
# time.  Latency percentiles, TTLB and byte-rate movements are honest
# wall measurements and legitimately vary run to run; the counts below
# are a pure function of the drill script once the origin content is
# hash-seed-independent (the crc32 fix in ``_Origin.fetch``), so a
# baseline arm replayed under a different PYTHONHASHSEED must agree
# byte-for-byte (tests/test_sim_determinism.py gates this in
# subprocesses).
COUNT_KEYS = (
    "shaped", "burst", "a_announces", "a_sheds", "a_downloads_ok",
    "b_offered", "b_announces", "b_pulls", "seed_tenant_bytes",
)


def deterministic_summary(arm_report: Dict[str, object]) -> Dict[str, object]:
    """The seed-reproducible core of one ``_run_arm`` report."""
    return {k: arm_report[k] for k in COUNT_KEYS if k in arm_report}
