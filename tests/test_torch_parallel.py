"""Port parity: the mesh and graph sharding,
``dragonfly2_tpu_torch/parallel/{mesh,graph_sharding,dryrun}.py`` against
``dragonfly2_tpu/parallel/{mesh,graph_sharding}.py``.

The port runs as 4 spawned gloo ranks on the CPU (``parallel.dryrun.
run_ranks``: one spawn for the module, a ``FileStore`` in a fresh
temporary directory, no fixed port), on a (2 data × 2 model) mesh and a
(4 × 1) one; the JAX package on meshes of the same shapes over 4 of the
8 forced CPU devices.  The rank bodies import no JAX.

Tolerances, stated:
- ``MeshSpec.resolve`` and ``build_halo_plan`` (arrays, halo, digest):
  equal (numpy verbatim);
- ``halo_neighbor_aggregate``, ``sharded_neighbor_aggregate`` and
  ``precompute_hop_features_sharded``, each rank's block against the JAX
  package's sharded function: 1e-5 absolute (float32 sums in another
  order);
- the dry run's replicated and node-sharded flagship losses: the
  reference's ``rtol=1e-4``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.parallel import graph_sharding as tgs
from dragonfly2_tpu_torch.parallel import mesh as tpm
from dragonfly2_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks

TOL = 1e-5
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


def _local_graph(n, shard, rng, locality=0.9, n_edges=2000):
    """tests/test_ops.py's graph: ~locality of edges stay within a node's shard."""
    dst = rng.integers(0, n, n_edges)
    local = rng.random(n_edges) < locality
    shard_of = dst // shard
    src_local = shard_of * shard + rng.integers(0, shard, n_edges)
    src_any = rng.integers(0, n, n_edges)
    src = np.where(local, src_local, src_any)
    return src.astype(np.int64), dst.astype(np.int64)


def _cases():
    """Per mesh: the halo graph (128 nodes, D 16, K 8) and the precompute
    graph (256 nodes, 12 features, K 8), made from tests/test_ops.py's seeds."""
    out = {}
    for name, (data, model) in MESHES.items():
        rng = np.random.default_rng(7)
        src, dst = _local_graph(128, 128 // data, rng)
        feats = rng.normal(size=len(src)).astype(np.float32)
        h = rng.normal(size=(128, 16)).astype(np.float32)
        rng = np.random.default_rng(11)
        axis_n = model if model > 1 else data
        psrc, pdst = _local_graph(256, 256 // axis_n, rng, locality=0.8, n_edges=4000)
        pfeats = rng.random(len(psrc)).astype(np.float32)
        nf = rng.normal(size=(256, 12)).astype(np.float32)
        out[name] = dict(halo=(src, dst, feats, h), pre=(psrc, pdst, pfeats, nf))
    return out


def _rank_body(rank, dev, cases):
    """Every case on this rank: its blocks of the aggregates and of the
    sharded precompute, and the stale-plan refusal."""
    res = {}
    for name, (data, model) in MESHES.items():
        mesh = tpm.create_mesh(tpm.MeshSpec(data=data, model=model), device=dev)
        src, dst, feats, h = cases[name]["halo"]
        table = tg.build_neighbor_table(128, src, dst, feats, max_neighbors=8)
        plan = tgs.build_halo_plan(table, mesh)
        S = plan.shard_size
        c = mesh.coord(tpm.DATA_AXIS)
        h_block = torch.from_numpy(h[c * S:(c + 1) * S])
        halo = tgs.halo_neighbor_aggregate(mesh, h_block, table, plan)
        halo_blk = tgs.halo_neighbor_aggregate(mesh, h_block, tgs.make_sharded_table(mesh, table),
                                               plan)
        full = tgs.sharded_neighbor_aggregate(mesh, h_block, table)
        psrc, pdst, pfeats, nf = cases[name]["pre"]
        ptable = tg.build_neighbor_table(256, psrc, pdst, pfeats, max_neighbors=8)
        axis = tpm.MODEL_AXIS if model > 1 else tpm.DATA_AXIS
        pplan = tgs.build_halo_plan(ptable, mesh, axis=axis)
        pre = tgs.precompute_hop_features_sharded(mesh, nf, ptable, pplan, hops=2, axis=axis)
        other = tg.build_neighbor_table(256, pdst, psrc, max_neighbors=8)
        try:
            tgs.precompute_hop_features_sharded(mesh, nf, other, pplan, hops=2, axis=axis)
            stale = "accepted"
        except ValueError as e:
            stale = str(e)
        tpm.reset_collective_counts()
        tgs.halo_neighbor_aggregate(mesh, h_block, table, plan)
        halo_collectives = dict(tpm.COLLECTIVES)
        res[name] = dict(
            coord={a: mesh.coord(a) for a in (tpm.DATA_AXIS, tpm.MODEL_AXIS)},
            halo=halo.numpy(), halo_blk=halo_blk.numpy(), full=full.numpy(), pre=pre.numpy(),
            stale=stale, halo_collectives=halo_collectives,
        )
    return res


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def ranks(cases):
    return run_ranks(_rank_body, 4, device="cpu", args=(cases,))


def _jax_mesh(name):
    import jax

    from dragonfly2_tpu.parallel.mesh import MeshSpec, create_mesh

    data, model = MESHES[name]
    return create_mesh(MeshSpec(data=data, model=model), devices=jax.devices()[:4])


def _stand_in(name):
    """The port's plan reads only the mesh's shape."""
    data, model = MESHES[name]
    return types.SimpleNamespace(shape={tpm.DATA_AXIS: data, tpm.MODEL_AXIS: model})


def _whole(ranks, name, key, axis):
    """The blocks of one axis's line through rank 0, in coordinate order."""
    other = tpm.MODEL_AXIS if axis == tpm.DATA_AXIS else tpm.DATA_AXIS
    line = [r[name] for r in ranks if r[name]["coord"][other] == 0]
    line.sort(key=lambda r: r["coord"][axis])
    return np.concatenate([r[key] for r in line])


@pytest.mark.parametrize("spec, n", [
    ((-1, 1), 8), ((2, 2), 4), ((-1, 2), 8), ((4, 1), 4), ((0, 3), 9), ((3, 2), 4), ((-1, 3), 8),
])
def test_mesh_spec_resolve_matches_jax(spec, n):
    from dragonfly2_tpu.parallel.mesh import MeshSpec as JMeshSpec

    def run(cls):
        try:
            return cls(*spec).resolve(n)
        except ValueError as e:
            return str(e)

    assert run(tpm.MeshSpec) == run(JMeshSpec)


def test_host_local_batch_and_pad_without_a_group():
    assert tpm.host_local_batch(4096) == 4096
    assert tpm.pad_to_multiple(10, 4) == 12 and tpm.pad_to_multiple(12, 4) == 12


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("graph", ["halo", "pre"])
def test_build_halo_plan_equals_jax(cases, name, graph):
    from dragonfly2_tpu.models.gnn import build_neighbor_table as jbuild
    from dragonfly2_tpu.parallel import graph_sharding as jgs

    n, k = (128, 8) if graph == "halo" else (256, 8)
    src, dst, feats, _ = cases[name][graph]
    data, model = MESHES[name]
    axis = tpm.DATA_AXIS if graph == "halo" or model == 1 else tpm.MODEL_AXIS
    jplan = jgs.build_halo_plan(jbuild(n, src, dst, feats, max_neighbors=k), _jax_mesh(name),
                                axis=axis)
    tplan = tgs.build_halo_plan(tg.build_neighbor_table(n, src, dst, feats, max_neighbors=k),
                                _stand_in(name), axis=axis)
    assert (tplan.n_shards, tplan.shard_size, tplan.halo) == (
        jplan.n_shards, jplan.shard_size, jplan.halo)
    assert tplan.table_digest == jplan.table_digest
    assert tplan.send_idx.dtype == np.int32 and tplan.local_idx.dtype == np.int32
    np.testing.assert_array_equal(tplan.send_idx, np.asarray(jplan.send_idx))
    np.testing.assert_array_equal(tplan.local_idx, np.asarray(jplan.local_idx))


@pytest.mark.parametrize("name", list(MESHES))
def test_halo_and_full_gather_aggregates_match_jax(cases, ranks, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dragonfly2_tpu.models.gnn import build_neighbor_table as jbuild
    from dragonfly2_tpu.parallel import graph_sharding as jgs

    mesh = _jax_mesh(name)
    src, dst, feats, h = cases[name]["halo"]
    table = jbuild(128, src, dst, feats, max_neighbors=8)
    plan = jgs.build_halo_plan(table, mesh)
    hs = jax.device_put(jnp.asarray(h), NamedSharding(mesh, P("data")))
    want_halo = np.asarray(jgs.halo_neighbor_aggregate(
        mesh, hs, jgs.make_sharded_table(mesh, table), plan))
    want_full = np.asarray(jgs.sharded_neighbor_aggregate(
        mesh, hs, jgs.make_sharded_table(mesh, table)))
    for key, want in (("halo", want_halo), ("halo_blk", want_halo), ("full", want_full)):
        got = _whole(ranks, name, key, tpm.DATA_AXIS)
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= TOL, key
    # Ranks of one data coordinate hold the same block.
    for r in ranks:
        c = r[name]["coord"][tpm.DATA_AXIS]
        S = 128 // MESHES[name][0]
        assert np.max(np.abs(r[name]["halo"] - want_halo[c * S:(c + 1) * S])) <= TOL
    # One all-to-all per aggregation, and nothing else.
    assert all(r[name]["halo_collectives"] == {**{k: 0 for k in tpm.COLLECTIVES},
                                               "all_to_all": 1} for r in ranks)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_precompute_matches_jax(cases, ranks, name):
    import jax.numpy as jnp

    from dragonfly2_tpu.models.gnn import build_neighbor_table as jbuild
    from dragonfly2_tpu.models.hop import precompute_hop_features
    from dragonfly2_tpu.parallel import graph_sharding as jgs

    mesh = _jax_mesh(name)
    src, dst, feats, nf = cases[name]["pre"]
    table = jbuild(256, src, dst, feats, max_neighbors=8)
    axis = tpm.MODEL_AXIS if MESHES[name][1] > 1 else tpm.DATA_AXIS
    plan = jgs.build_halo_plan(table, mesh, axis=axis)
    want = np.asarray(jgs.precompute_hop_features_sharded(
        mesh, jnp.asarray(nf), table, plan, hops=2, axis=axis))
    oracle = np.asarray(precompute_hop_features(jnp.asarray(nf), table, hops=2))
    got = _whole(ranks, name, "pre", axis)
    assert got.shape == want.shape == oracle.shape
    assert np.max(np.abs(got - want)) <= TOL
    assert np.max(np.abs(got - oracle)) <= TOL


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_precompute_rejects_stale_plan(ranks, name):
    for r in ranks:
        assert "different table" in r[name]["stale"]


def test_halo_smaller_than_shard_with_locality():
    mesh = _stand_in("4x1")
    rng = np.random.default_rng(8)
    src, dst = _local_graph(1024, 1024 // 4, rng, locality=0.95, n_edges=8000)
    table = tg.build_neighbor_table(1024, src, dst, max_neighbors=8)
    plan = tgs.build_halo_plan(table, mesh)
    # The exchange ships n_shards*halo rows instead of the full table:
    # with 95% locality the halo must be far below the shard size.
    assert plan.halo < plan.shard_size / 2, (plan.halo, plan.shard_size)


def test_halo_plan_refuses_an_indivisible_node_count():
    table = tg.build_neighbor_table(10, np.arange(9), np.arange(1, 10), max_neighbors=2)
    with pytest.raises(ValueError, match="not divisible"):
        tgs.build_halo_plan(table, _stand_in("4x1"))


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpm.create_mesh(tpm.MeshSpec(), device="cpu")


def test_dryrun_multichip_on_four_cpu_ranks():
    out = dryrun_multichip(4, device="cpu")
    assert out["ok"] and out["mesh"] == {"data": 2, "model": 2}
    for r in out["ranks"]:
        assert np.isclose(r["hop_mp_loss"], r["hop_loss"], rtol=1e-4, atol=1e-5)
        assert r["online_steps"] == 6
