"""Port parity: the multi-tenant QoS overload drill, ``sim/qos.py``.

- The baseline arm (tenant A alone) on the same config and seed gives the
  same ``deterministic_summary`` in both packages, byte for byte: the
  count keys are a pure function of the drill script.
- The hash-seed sweep of ``tests/test_sim_determinism.py`` (its QoS half),
  for the port, in subprocesses under two ``PYTHONHASHSEED`` values.
- The port's counterparts of ``tests/test_qos_chaos.py``'s three tests,
  with the reference's configs and assertions: the SIGKILL at the 400th
  ``scheduler.qos.shed`` and two clean rebuilds
  (``tests/_torch_qos_child.py``, the port's copy of ``_qos_child.py``),
  the shaped burst isolating tenant A, and the drill wired through the
  real admission plane.
- The port's two keywords: with ``evaluator=`` an ``MLEvaluator`` over a
  ``FusedMLPScorer`` on the CPU (K1's plain version) and
  ``extra_parents=3`` the downloads complete and the scorer is called once
  for each ranking of more than one candidate; with ``extra_parents=0``
  it is called 0 times, as in the reference, where each of A's downloads
  has one candidate (the seed).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import zlib
from pathlib import Path

import pytest

from dragonfly2_tpu.sim import qos as j_qos
from dragonfly2_tpu_torch.sim import qos as t_qos
from dragonfly2_tpu_torch.utils.faultinject import FaultSpec

REPO = Path(__file__).resolve().parents[1]
CHILD = REPO / "tests" / "_torch_qos_child.py"

SMALL = dict(a_announces=80, a_downloads=2, pieces_per_task=2, piece_size=16 * 1024,
             b_threads=1)


def _run_child(mode: str, *, scenario=None, hashseed=None):
    env = {k: v for k, v in os.environ.items() if k != "DF_FAULTINJECT"}
    if scenario is not None:
        env["DF_FAULTINJECT"] = json.dumps(scenario)
    if hashseed is not None:
        env["PYTHONHASHSEED"] = str(hashseed)
    return subprocess.Popen(
        [sys.executable, str(CHILD), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(REPO),
    )


class TestParity:
    def test_baseline_summary_byte_equal_between_packages(self):
        port = t_qos._run_arm(t_qos.QoSDrillConfig(**SMALL), shaped=False, burst=False)
        ref = j_qos._run_arm(j_qos.QoSDrillConfig(**SMALL), shaped=False, burst=False)
        a = json.dumps(t_qos.deterministic_summary(port), sort_keys=True)
        b = json.dumps(j_qos.deterministic_summary(ref), sort_keys=True)
        assert a == b
        assert port["a_downloads_ok"] == 2 and port["a_announces"] == 80
        assert t_qos.COUNT_KEYS == j_qos.COUNT_KEYS

    def test_config_defaults_are_the_references(self):
        assert vars(t_qos.QoSDrillConfig()) == vars(j_qos.QoSDrillConfig())
        assert t_qos.QoSDrillConfig().policy().to_payload() == \
            j_qos.QoSDrillConfig().policy().to_payload()

    def test_origin_content_is_not_hash_salted(self):
        url = "https://origin.qos/a-0"
        seed = (zlib.crc32(url.encode()) ^ 3) & 0xFF
        expect = bytes((seed + i) % 256 for i in range(64))
        assert t_qos._Origin(64).fetch(url, 3, 64) == expect == \
            j_qos._Origin(64).fetch(url, 3, 64)


class TestQoSSeedSweep:
    def test_qos_baseline_byte_identical_across_hashseeds(self):
        procs = [_run_child("sweep", hashseed=h) for h in (0, 42)]
        outs = []
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err.decode()[-3000:]
            outs.append(out)
        doc = json.loads(outs[0])
        assert doc["baseline"]["a_announces"] > 0
        assert doc["baseline"]["a_downloads_ok"] > 0
        assert outs[0] == outs[1], (
            "qos drill baseline diverged across PYTHONHASHSEED "
            "(origin content or accounting is hash-salted again)"
        )


class TestQoSKillDrill:
    def test_sigkill_mid_burst_and_clean_rebuild(self):
        # The storm dies at its 400th QoS shed — deep enough that caps
        # and band sheds have both fired, mid-burst by construction.
        scenario = {
            "seed": 11,
            "faults": [
                FaultSpec(
                    site="scheduler.qos.shed", kind="crash", at=(400,),
                ).to_dict(),
            ],
        }
        proc = _run_child("hammer", scenario=scenario)
        try:
            out, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            pytest.fail(f"hammer child hung: {out!r} {err!r}")
        assert proc.returncode == -signal.SIGKILL, (
            proc.returncode, out, err,
        )
        assert b"qos-child: ready" in out

        # The replacement shard rebuilds accounting from traffic alone;
        # two independent rebuilds must agree.
        verdicts = []
        for _ in range(2):
            proc = _run_child("rebuild")
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, (out, err)
            verdicts.append(json.loads(out.strip().splitlines()[-1]))
        v1, v2 = verdicts
        for v in verdicts:
            assert all(v["invariants"].values()), v["invariants"]
            assert v["snapshot"]["t-b"]["sheds"] > 0, (
                "rebuild never shed the noisy tenant"
            )
        for t in ("t-a", "t-b"):
            assert v1["snapshot"][t]["requests"] == v2["snapshot"][t]["requests"]
            assert v1["outcomes"][t] == pytest.approx(
                v2["outcomes"][t], rel=0.2
            ) or v1["outcomes"][t] == v2["outcomes"][t]
        s1, s2 = v1["snapshot"]["t-b"], v2["snapshot"]["t-b"]
        assert s1["sheds"] == pytest.approx(s2["sheds"], rel=0.2)
        assert s1["over_quota"] == pytest.approx(s2["over_quota"], rel=0.1)


class TestQoSIsolationDrill:
    def test_shaped_burst_isolates_tenant_a(self):
        out = t_qos.run_isolation_drill(t_qos.QoSDrillConfig(
            a_announces=300, a_downloads=4, pieces_per_task=4,
            piece_size=32 * 1024, b_threads=2,
        ))
        shaped, unshaped = out["shaped"], out["unshaped"]
        assert unshaped["b_offered"] > 100
        assert shaped["b_sheds"] + shaped["b_throttled"] > 0
        assert shaped["a_downloads_ok"] == 4
        move = out["movement"]
        assert move["unshaped_ttlb_pct"] > 50.0, move
        assert (
            max(move["shaped_ttlb_pct"], 0.0)
            < move["unshaped_ttlb_pct"] / 2.0
        ), move
        assert shaped["seed_tenant_bytes"].get("t-b", 0) < (
            unshaped["seed_tenant_bytes"].get("t-b", 0)
        )

    def test_drill_is_wired_through_real_admission(self):
        out = t_qos.run_isolation_drill(t_qos.QoSDrillConfig(
            a_announces=120, a_downloads=2, pieces_per_task=2,
            piece_size=16 * 1024, b_threads=1,
        ))
        acct = out["shaped"]["tenant_accounting"]
        assert acct["t-a"]["tenant_class"] == "gold"
        assert acct["t-b"]["tenant_class"] == "background"
        assert acct["t-b"]["requests"] > 0


class TestMLEvaluatorKeywords:
    @pytest.mark.parametrize("extra_parents", [0, 3])
    def test_scorer_called_once_per_ranking_of_several(self, monkeypatch, extra_parents):
        from dragonfly2_tpu_torch.bench.bench_qos import MLEvaluators
        from dragonfly2_tpu_torch.bench.wire_loop import seeded_k1_blob
        from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
        from dragonfly2_tpu_torch.scheduler import MLEvaluator

        ranked, calls = [], []
        evaluate, score = MLEvaluator.evaluate_parents, FusedMLPScorer.score

        def counting_evaluate(self, parents, child, total):
            ranked.append(len(parents))
            return evaluate(self, parents, child, total)

        def counting_score(self, *args, **kwargs):
            calls.append(1)
            return score(self, *args, **kwargs)

        monkeypatch.setattr(MLEvaluator, "evaluate_parents", counting_evaluate)
        monkeypatch.setattr(FusedMLPScorer, "score", counting_score)
        evaluators = MLEvaluators(seeded_k1_blob(0), "cpu")
        cfg = t_qos.QoSDrillConfig(a_announces=120, a_downloads=3, pieces_per_task=2,
                                   piece_size=16 * 1024, b_threads=1)
        arm = t_qos._run_arm(cfg, shaped=True, burst=True, evaluator=evaluators,
                             extra_parents=extra_parents)
        assert arm["a_downloads_ok"] == 3
        assert len(evaluators.built) == 1
        several = sum(1 for n in ranked if n > 1)
        assert len(calls) == several == evaluators.scorer_calls()
        assert evaluators.built[0].degrades == 0
        if extra_parents:
            # Each measured download ranks the seed and the extra parents
            # (the bad-node filter may drop one whose cost sample ran long).
            assert all(2 <= n <= 1 + extra_parents for n in ranked[-cfg.a_downloads:]), ranked
        else:
            assert several == 0 and set(ranked) <= {1}

    def test_default_evaluator_is_the_references_rule(self, tmp_path):
        from dragonfly2_tpu_torch.scheduler import Evaluator, MLEvaluator

        state = t_qos._build(t_qos.QoSDrillConfig(**SMALL), shaped=False,
                             workdir=str(tmp_path))
        ev = state.service.scheduling.evaluator
        assert type(ev) is Evaluator and not isinstance(ev, MLEvaluator)
