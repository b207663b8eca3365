"""Fleet-swarm benchmark: aggregate announces/sec across scheduler
shards at 100k+ simulated peers on one box.

Drives the columnar swarm population (sim/fleet.py: slot-matrix peer
state, vectorized per-tick churn draws per idc class) against REAL
``SchedulerService`` shards — each with its own Resource, columnar host
store and ShardGuard behind one consistent-hash ring (DESIGN.md §24).

Two arms, measured in INTERLEAVED rounds (bench_sched.py discipline:
one unmeasured warm round, GC quiesced, identical seeded workload):

- ``shards_1`` — the whole population on ONE scheduler instance (the
  pre-§24 deployment shape);
- ``shards_N`` — the same population split across N instances by ring
  ownership (host announces pin to the host id's owner; task traffic to
  the task id's owner).

The headline — **aggregate announces/sec across shards in the N-shard
arm** — is the fleet-scale serving signal.
``speedup_shards`` reports the N-vs-1 ratio HONESTLY: on a 1-CPU box
the announce row-fill is CPU-bound and O(1) per announce, so sharding
divides *state* (hosts/tasks per instance, bind-miss churn), not
cycles — expect ~1× wall-clock there, and real scaling only where
shards get their own cores/processes (the chaos drill proves the wire
protocol; BENCHMARKS.md documents the wall).

A mid-run membership drill rides every measured N-shard round: one
shard is removed at the halfway tick (ring bump → survivor handoff
sweeps → steering), and the round asserts the drill's downloads still
complete — the migration protocol is exercised under load, not only in
the chaos test.

Port of ``tools/bench_swarm.py``: the same arms (``single`` is
``shards_1``, ``sharded`` is ``shards_N``), the same interleaved rounds
after one warm round, the same mid-run membership drill and ``--smoke``,
and the same JSON keys, without the regression guard against the JAX
package's ``BENCH_SW_r*.json`` rounds (a host number from another
program).  Host-only: the shards run the rule evaluator, no kernel.

Usage: python -m dragonfly2_tpu_torch.bench.fleet_swarm
       [--peers 128000] [--shards 4] [--ticks 4] [--rounds 2]
       [--announce-rate 0.5] [--download-rate 0.0005]
       [--cache-hosts 65536] [--seed 7]
       [--smoke]   # tiny population: the tier-1 JSON-schema gate
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List

SCHEMA_KEYS = (
    "ok",
    "metric",
    "config",
    "arms",
    "speedup_shards",
    "peers",
    "unique_hosts",
    "membership_drill",
)

ARM_KEYS = (
    "announces_per_sec",
    "announces",
    "wall_s",
    "hosts_per_shard_max",
    "bind_misses",
    "downloads_ok",
    "downloads_failed",
    "sheds",
)


def _run_arm(
    n_shards: int,
    *,
    peers: int,
    ticks: int,
    seed: int,
    announce_rate: float,
    download_rate: float,
    cache_hosts: int,
    drill: bool,
) -> Dict[str, object]:
    """One arm run: fresh seeded population + fleet, full tick loop.
    With ``drill`` (N-shard measured rounds), one member is removed at
    the halfway tick — handoff/steering runs under the measured load."""
    from ..sim import (
        ColumnarPopulation,
        FleetConfig,
        FleetSwarmDriver,
        ShardedFleet,
    )

    cfg = FleetConfig(
        num_peers=peers,
        seed=seed,
        announce_rate=announce_rate,
        download_rate=download_rate,
    )
    pop = ColumnarPopulation(cfg)
    fleet = ShardedFleet(n_shards, feature_cache_hosts=cache_hosts)
    driver = FleetSwarmDriver(pop, fleet)
    drill_out: Dict[str, object] = {"ran": False}
    run_drill = drill and n_shards > 1 and ticks >= 4
    first = ticks // 2 if run_drill else ticks
    rep = driver.run(first)
    wall = float(rep["wall_s"])
    if run_drill:
        # Membership drill under load, in two bumps with workload in
        # between so the client-side stale-ring paths really run: one
        # member dies (first downloads hit the dead socket analog and
        # re-route), then a replacement joins (survivor handoff sweeps
        # mark the newcomer's keys; stale-ring downloads get the
        # REDIRECT steering answer and follow it).
        victim = sorted(fleet.shards)[-1]
        victim_tasks = len(fleet.shards[victim].service.resource.task_manager)
        kill_moved = fleet.kill(victim)
        ok_before = driver.downloads_ok
        mid = max(1, (ticks - first) // 2)
        rep = driver.run(mid)
        wall += float(rep["wall_s"])
        add_moved = fleet.add_shard("shard-replacement")
        rep = driver.run(ticks - first - mid)
        wall += float(rep["wall_s"])
        drill_out = {
            "ran": True,
            "victim": victim,
            "victim_tasks": victim_tasks,
            "kill_handoffs": kill_moved,
            "add_handoffs": add_moved,
            "handed_off_tasks": sum(add_moved.values()),
            "ring_version": fleet.ring.version,
            "downloads_after_kill": driver.downloads_ok - ok_before,
            "rehomed_tasks": driver.rehomed_tasks,
            "redirects_followed": sum(
                s.redirects_followed for s in fleet.shards.values()
            ),
        }
    stats = fleet.stats()
    shards = stats["shards"]
    return {
        "announces_per_sec": round(rep["announces_per_sec"], 1),
        "announces": int(stats["announces"]),
        "wall_s": round(wall, 3),
        "announce_wall_s": round(float(rep["announce_wall_s"]), 3),
        "hosts_per_shard_max": max(s["hosts"] for s in shards.values()),
        "bind_misses": sum(s["cache_misses"] for s in shards.values()),
        "downloads_ok": driver.downloads_ok,
        "downloads_failed": driver.downloads_failed,
        "rehomed_tasks": driver.rehomed_tasks,
        "sheds": driver.sheds,
        "unique_hosts": int(rep["unique_hosts"]),
        "online": int(rep["online"]),
        "drill": drill_out,
    }


def run(args) -> Dict[str, object]:
    arms = {"single": 1, "sharded": max(2, args.shards)}
    rounds: Dict[str, List[Dict[str, object]]] = {k: [] for k in arms}
    gc.collect()
    gc.disable()
    try:
        # One unmeasured warm round (tiny) + interleaved measured rounds:
        # machine-wide noise lands on both arms roughly equally.
        for name, n in arms.items():
            _run_arm(
                n, peers=max(2000, args.peers // 50), ticks=2,
                seed=args.seed, announce_rate=args.announce_rate,
                download_rate=args.download_rate,
                cache_hosts=args.cache_hosts, drill=False,
            )
        for _ in range(max(1, args.rounds)):
            for name, n in arms.items():
                rounds[name].append(
                    _run_arm(
                        n, peers=args.peers, ticks=args.ticks,
                        seed=args.seed, announce_rate=args.announce_rate,
                        download_rate=args.download_rate,
                        cache_hosts=args.cache_hosts, drill=True,
                    )
                )
    finally:
        gc.enable()

    def best(name: str) -> Dict[str, object]:
        return max(
            rounds[name], key=lambda r: r["announces_per_sec"]
        )

    single, sharded = best("single"), best("sharded")
    drill = next(
        (r["drill"] for r in rounds["sharded"] if r["drill"].get("ran")),
        {"ran": False},
    )
    return {
        "ok": True,
        "metric": "swarm_announces_per_sec",
        "config": {
            "peers": args.peers,
            "shards": arms["sharded"],
            "ticks": args.ticks,
            "rounds": args.rounds,
            "announce_rate": args.announce_rate,
            "download_rate": args.download_rate,
            "cache_hosts": args.cache_hosts,
            "seed": args.seed,
        },
        "arms": {"single": single, "sharded": sharded},
        "speedup_shards": round(
            float(sharded["announces_per_sec"])
            / max(float(single["announces_per_sec"]), 1e-9),
            3,
        ),
        "peers": args.peers,
        "unique_hosts": int(sharded["unique_hosts"]),
        "membership_drill": drill,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--peers", type=int, default=128_000)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--ticks", type=int, default=4)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--announce-rate", type=float, default=0.5)
    p.add_argument("--download-rate", type=float, default=0.0005)
    p.add_argument("--cache-hosts", type=int, default=65536)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--smoke", action="store_true",
                   help="tiny population: the tier-1 JSON-schema gate")
    args = p.parse_args(argv)
    if args.smoke:
        args.peers, args.ticks, args.rounds = 2500, 4, 1
        args.cache_hosts = 1024
        # Enough downloads that every shard owns tasks and the
        # membership drill's handoff path actually moves keys.
        args.download_rate = 0.02
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        out = run(args)
        missing = [k for k in SCHEMA_KEYS if k not in out]
        for arm, stats in out["arms"].items():
            missing += [f"{arm}.{k}" for k in ARM_KEYS if k not in stats]
        if missing:
            raise RuntimeError(f"schema keys missing: {missing}")
        # The membership drill is part of the measured product: a round
        # where migration broke downloads is a FAILED round, whatever
        # the throughput said.
        drill = out["membership_drill"]
        if drill.get("ran") and out["arms"]["sharded"]["downloads_failed"]:
            raise RuntimeError(
                "downloads failed across the membership drill: "
                f"{out['arms']['sharded']['downloads_failed']}"
            )
    except Exception as exc:  # noqa: BLE001 — one parseable line, never a traceback
        print(json.dumps({
            "ok": False,
            "metric": "swarm_announces_per_sec",
            "error": f"{type(exc).__name__}: {exc}"[:300],
        }))
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
