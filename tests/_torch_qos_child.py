"""Subprocess body for the port's multi-tenant QoS chaos drill
(tests/test_torch_qos_drill.py, DESIGN.md §26): the port's copy of
``tests/_qos_child.py``, the same modes and stream over
``dragonfly2_tpu_torch``, and one mode more.

Modes:

- ``hammer``  build the tenant-aware admission plane (SchedulerService +
  ShardGuard + AdmissionController + TenantAccounting + a two-tenant
  policy) and flood it from announcer threads — tenant B at ~10× tenant
  A, so rate caps and priority-band sheds fire continuously.  Prints
  ``qos-child: ready`` once the storm is running; the parent installs a
  ``crash`` FaultSpec on the ``scheduler.qos.shed`` seam, so the
  process SIGKILLs itself at a deterministic shed mid-burst.
- ``rebuild`` the restarted shard: a fresh process replays the SAME
  deterministic single-threaded request stream (nothing is persisted —
  tenant accounting is rebuilt from traffic, which is the restart
  contract) and prints ONE JSON verdict line: the accounting snapshot
  plus internal-consistency invariants.  The parent asserts two
  independent rebuilds produce IDENTICAL snapshots (deterministic
  rebuild ⇒ no torn state survived the kill).
- ``sweep``   the seed sweep (tests/_sim_child.py ``qos``): one baseline arm
  of the port's QoS drill plus a digest over the origin content; prints
  the deterministic projection, which must not move with PYTHONHASHSEED.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ANNOUNCERS_A = 1
ANNOUNCERS_B = 4


def build():
    from dragonfly2_tpu_torch.qos import QoSPolicy, TenantAccounting
    from dragonfly2_tpu_torch.scheduler import (
        AdmissionController,
        Evaluator,
        HostFeatureCache,
        Resource,
        SchedulerService,
        Scheduling,
        SchedulingConfig,
        ShardGuard,
    )

    policy = QoSPolicy.from_payload({
        "t-a": {"tenant_class": "gold", "weight": 4.0},
        "t-b": {"tenant_class": "background", "weight": 1.0, "priority": 6,
                "announce_qps": 200, "announce_burst": 50},
    })
    ctl = AdmissionController(
        max_inflight=128, p99_budget_s=0.005,
        accounting=TenantAccounting(policy, window_s=1e9),
    )
    guard = ShardGuard("qos-chaos", admission=ctl)
    service = SchedulerService(
        Resource(),
        Scheduling(
            Evaluator(feature_cache=HostFeatureCache(max_hosts=512)),
            SchedulingConfig(retry_interval=0),
        ),
        shard_guard=guard,
    )
    service.set_qos_policy(policy)
    return service, ctl


def _host(tenant: str, i: int):
    from dragonfly2_tpu_torch.scheduler.resource import Host

    h = Host(
        id=f"qc-{tenant}-{i}", hostname=f"qc-{tenant}-{i}",
        ip=f"10.7.0.{i & 255}", port=8002, download_port=8001,
    )
    h.stats.network.idc = "idc-qc"
    return h


def hammer():
    from dragonfly2_tpu_torch.scheduler import ShardSaturatedError
    from dragonfly2_tpu_torch.utils import faultinject

    # The parent's DF_FAULTINJECT scenario (the crash FaultSpec on the
    # scheduler.qos.shed seam) arms the deterministic kill switch.
    faultinject.install_from_env()
    service, ctl = build()
    # Pressure the latency signal so band sheds fire alongside rate
    # caps: the admission sketch sees slow announces.
    for _ in range(200):
        ctl.observe(0.008)
    stop = threading.Event()

    go = threading.Event()

    def worker(tenant: str, tid: int):
        hosts = [_host(tenant, tid * 32 + i) for i in range(8)]
        rng = np.random.default_rng(tid)
        go.wait()
        while not stop.is_set():
            try:
                service.announce_host(
                    hosts[int(rng.integers(0, len(hosts)))], tenant=tenant
                )
            except ShardSaturatedError:
                pass

    threads = [
        threading.Thread(target=worker, args=("t-a", i), daemon=True)
        for i in range(ANNOUNCERS_A)
    ] + [
        threading.Thread(target=worker, args=("t-b", 100 + i), daemon=True)
        for i in range(ANNOUNCERS_B)
    ]
    for t in threads:
        t.start()
    # Ready before the storm is released: under load the announcers could
    # otherwise reach the 400th shed (and the kill) before this line runs.
    print("qos-child: ready", flush=True)
    go.set()
    while True:  # the crash fault SIGKILLs us at the Nth shed
        time.sleep(0.1)


def rebuild():
    from dragonfly2_tpu_torch.scheduler import ShardSaturatedError

    service, ctl = build()
    for _ in range(200):
        ctl.observe(0.008)
    # Deterministic replay: single thread, fixed interleave (9 B : 1 A —
    # the same 10x shape the killed process served), fixed virtual clock
    # into the accounting window.
    outcomes = {"t-a": {"ok": 0, "shed": 0}, "t-b": {"ok": 0, "shed": 0}}
    hosts = {
        "t-a": [_host("t-a", i) for i in range(8)],
        "t-b": [_host("t-b", 100 + i) for i in range(8)],
    }
    for i in range(3000):
        tenant = "t-a" if i % 10 == 0 else "t-b"
        try:
            service.announce_host(hosts[tenant][i % 8], tenant=tenant)
            outcomes[tenant]["ok"] += 1
        except ShardSaturatedError:
            outcomes[tenant]["shed"] += 1
    snap = ctl.accounting.snapshot()
    # Internal consistency: every request accounted exactly once, caps
    # a subset of sheds, the noisy tenant identified.
    invariants = {
        "requests_match": all(
            snap[t]["requests"]
            == outcomes[t]["ok"] + outcomes[t]["shed"]
            for t in ("t-a", "t-b")
        ),
        "caps_within_sheds": snap["t-b"]["capped"] <= snap["t-b"]["sheds"],
        "noisy_is_b": snap["t-b"]["over_quota"] > snap["t-a"]["over_quota"],
        "a_never_capped": snap["t-a"]["capped"] == 0,
    }
    print(json.dumps({
        "snapshot": snap,
        "outcomes": outcomes,
        "invariants": invariants,
    }, sort_keys=True), flush=True)


def sweep():
    import hashlib

    from dragonfly2_tpu_torch.sim import qos as simqos

    cfg = simqos.QoSDrillConfig(
        a_announces=80, a_downloads=2, pieces_per_task=2,
        piece_size=16 * 1024, b_threads=1,
    )
    arm = simqos._run_arm(cfg, shaped=False, burst=False)
    out = {"baseline": simqos.deterministic_summary(arm)}
    origin = simqos._Origin(4096)
    digest = hashlib.sha256()
    for url in ("https://origin.qos/a-0", "https://origin.qos/b-1",
                "https://origin.qos/warm"):
        for number in range(4):
            digest.update(origin.fetch(url, number, 4096))
    out["origin_sha256"] = digest.hexdigest()
    sys.stdout.write(json.dumps(out, sort_keys=True))


def main():
    mode = sys.argv[1]
    if mode == "hammer":
        hammer()
    elif mode == "rebuild":
        rebuild()
    elif mode == "sweep":
        sweep()
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
