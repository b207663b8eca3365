"""Port parity: the columnar fleet, ``dragonfly2_tpu_torch/sim/fleet.py``
and ``bench/fleet_swarm.py`` against ``dragonfly2_tpu/sim/fleet.py`` and
``tools/bench_swarm.py``.

- ``deterministic_summary`` of the port's ``FleetSwarmDriver.run`` equals
  the JAX package's at 4,000 peers, 3 shards, 4 ticks, seed 7, with one
  ``kill`` after the second tick and one ``add_shard`` after the third:
  the summary after each leg, and the handoffs each membership change
  returns.  Planted fault: the port's ring placed by ``hash()`` must
  make it differ.
- ``python -m dragonfly2_tpu_torch.bench.fleet_swarm --smoke`` prints the
  reference's JSON schema (the port of ``TestBenchSwarmSmoke``): the
  membership drill ran and no download failed.

Both packages' scheduling engines draw candidates from the global
``random``; the fleet's summary does not depend on those draws (the
reference's seed sweep holds it across interpreters), and the global
generator is seeded before each run all the same.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

import dragonfly2_tpu.sim.fleet as j_fleet
import dragonfly2_tpu_torch.scheduler.sharding as t_sharding
import dragonfly2_tpu_torch.sim.fleet as t_fleet

REPO = Path(__file__).resolve().parents[1]


def _legs(mod):
    """Run the fleet through a kill and an add; → what each leg reports."""
    random.seed(7)
    cfg = mod.FleetConfig(num_peers=4000, seed=7, download_rate=0.01, task_catalog=16)
    fleet = mod.ShardedFleet(3, feature_cache_hosts=2048)
    driver = mod.FleetSwarmDriver(mod.ColumnarPopulation(cfg), fleet)
    out = [mod.deterministic_summary(driver.run(2))]
    out.append({"kill": fleet.kill(sorted(fleet.shards)[-1])})
    out.append(mod.deterministic_summary(driver.run(1)))
    out.append({"add": fleet.add_shard("shard-late")})
    out.append(mod.deterministic_summary(driver.run(1)))
    return out


@pytest.mark.parametrize("fault", [None, "hash_ring"])
def test_deterministic_summary_equals_the_references(monkeypatch, fault):
    if fault:
        monkeypatch.setattr(t_sharding, "shard_hash", lambda k: hash(k) & ((1 << 64) - 1))
    port, ref = _legs(t_fleet), _legs(j_fleet)
    assert ref[0]["announces"] > 0 and ref[-1]["downloads_ok"] > 0
    assert ref[-1]["downloads_failed"] == 0
    assert sum(ref[3]["add"].values()) > 0, "the add handed off no task"
    same = json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert same is (fault is None)
    assert t_fleet.TIMING_KEYS == j_fleet.TIMING_KEYS


def test_fleet_swarm_smoke_schema():
    from dragonfly2_tpu_torch.bench import fleet_swarm

    out = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.bench.fleet_swarm", "--smoke"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stdout + out.stderr
    data = json.loads(out.stdout.strip().splitlines()[-1])
    assert data["ok"] is True
    assert all(k in data for k in fleet_swarm.SCHEMA_KEYS)
    for arm in ("single", "sharded"):
        assert all(k in data["arms"][arm] for k in fleet_swarm.ARM_KEYS)
    assert data["membership_drill"]["ran"] is True
    assert data["arms"]["sharded"]["downloads_failed"] == 0
    assert data["config"]["shards"] == 4 and data["peers"] == 2500
