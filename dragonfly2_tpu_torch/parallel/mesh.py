"""Mesh construction and the port's collectives: one process per device.

Port of ``dragonfly2_tpu/parallel/mesh.py``.  The JAX package has one
controller: it places arrays with ``NamedSharding`` and XLA inserts the
collectives.  The port has one process per device, all running the same
call, and writes its collectives out with ``torch.distributed``:

- the caller starts the ranks (``torchrun``, ``torch.multiprocessing.spawn``
  or ``parallel.dryrun.run_ranks``) and initializes the default process
  group;
- ``create_mesh(MeshSpec(data=…, model=…), device=…)`` lays the world out as
  a (data, model) grid, rank ``r`` at data coordinate ``r // model`` and
  model coordinate ``r % model`` (the reference's ``reshape(data, model)``
  of the device list), with one process group per row and per column;
- every collective the port issues goes through ``all_reduce``,
  ``all_gather_into_tensor``, ``all_to_all_single``, ``broadcast``,
  ``broadcast_object``, ``all_gather_object`` and ``barrier`` here, which
  count what they issue (``COLLECTIVES``).

- ``data`` axis: the batch (each rank of a column takes its rows of every
  global batch) and the gradient average.
- ``model`` axis: node tables (hop features, the learnable node embedding
  and its AdamW moments) partitioned by node (``node_sharding="model"``).

The reference's ``batch_sharding`` and ``replicated`` have no counterpart:
a rank holds its rows of a batch and a whole copy of every replicated
tensor, and each place that reads them in the reference says so here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Collectives issued since the last reset, by kind: each wrapper below
# adds one where it issues its collective, and nowhere else.
COLLECTIVES: Dict[str, int] = {
    "all_reduce": 0, "all_gather": 0, "all_to_all": 0, "broadcast": 0, "barrier": 0,
}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1   # -1 → all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple:
        model = max(self.model, 1)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not tile {n_devices} devices"
            )
        return data, model


class Mesh:
    """This rank's view of the (data, model) grid: ``shape`` (``{"data":
    d, "model": m}``, read as the reference reads ``mesh.shape[axis]``),
    ``group(axis)`` (the process group of the ranks that differ only in
    ``axis``; its group rank is the coordinate), ``coord(axis)``,
    ``device`` and the ``DeviceMesh`` over the same groups."""

    def __init__(self, data: int, model: int, device: torch.device, backend: str) -> None:
        from torch.distributed.device_mesh import DeviceMesh

        self.shape: Dict[str, int] = {DATA_AXIS: data, MODEL_AXIS: model}
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        self.size = data * model
        layout = np.arange(self.size).reshape(data, model)
        self._coord = {
            DATA_AXIS: self.rank // model, MODEL_AXIS: self.rank % model,
        }
        # Every rank creates every group, in one order (new_group's rule).
        self._groups = {}
        for axis, lines in ((DATA_AXIS, layout.T), (MODEL_AXIS, layout)):
            for line in lines:
                g = dist.new_group([int(r) for r in line], backend=backend)
                if self.rank in line:
                    self._groups[axis] = g
        self.world = dist.new_group(list(range(self.size)), backend=backend)
        self.device_mesh = DeviceMesh.from_group(
            [self._groups[DATA_AXIS], self._groups[MODEL_AXIS]], device.type,
            mesh=torch.from_numpy(layout), mesh_dim_names=(DATA_AXIS, MODEL_AXIS),
        )

    def group(self, axis: str):
        return self._groups[axis]

    def coord(self, axis: str) -> int:
        return self._coord[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def create_mesh(
    spec: Optional[MeshSpec] = None, *, device="cuda", backend: Optional[str] = None,
) -> Mesh:
    """The (data, model) mesh over the initialized world, this rank on
    ``device`` (``"cuda"`` means the current card).  The groups' backend
    comes from the device, NCCL for ``cuda`` and gloo for ``cpu``, unless
    ``backend`` names one (gloo over CUDA tensors puts several ranks on
    one card, which NCCL refuses); it never falls back from one to the
    other."""
    from ..ops import _build

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs the default process group: start one process "
            "per device and call torch.distributed.init_process_group first"
        )
    dev = _build.resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    data, model = (spec or MeshSpec()).resolve(dist.get_world_size())
    return Mesh(data, model, dev, backend or _backend_for(dev))


def host_local_batch(global_batch: int) -> int:
    """This process's slice of the global batch.  A process is one device
    here (JAX divides by the number of hosts)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return global_batch // max(world, 1)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round up so shards are equal-size (static shapes; XLA compiles once)."""
    return ((n + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# Collectives: the one place the port issues them
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into_tensor(out: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
    """``out`` [n·rows, ...] ← every group rank's ``t`` in group-rank order."""
    COLLECTIVES["all_gather"] += 1
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def all_to_all_single(out: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
    """Slice ``i`` of ``t``'s dim 0 goes to group rank ``i``; slice ``j`` of
    ``out`` comes from group rank ``j``."""
    COLLECTIVES["all_to_all"] += 1
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` ← global rank ``src``'s ``t``, in place."""
    COLLECTIVES["broadcast"] += 1
    dist.broadcast(t, src=src, group=group)
    return t


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank of the world (other
    ranks pass anything); → the object."""
    COLLECTIVES["broadcast"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.world)
    return box[0]


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    COLLECTIVES["all_gather"] += 1
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.world)
    return out


def barrier(mesh: Mesh) -> None:
    COLLECTIVES["barrier"] += 1
    dist.barrier(group=mesh.world)


_MAX_DIMS = 4


def broadcast_arrays(mesh: Mesh, arrays: Optional[Sequence[np.ndarray]], n: int,
                     src: int = 0) -> list:
    """Rank ``src``'s ``n`` numpy arrays (int32 or float32, at most 4 dims)
    on every rank, over the world: one broadcast of their dtypes and
    shapes, one of their words packed into one buffer.  Other ranks pass
    ``None``."""
    dev = mesh.device
    head = torch.zeros((n, 2 + _MAX_DIMS), dtype=torch.int64)
    if mesh.rank == src:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        for i, a in enumerate(arrays):
            if a.dtype not in (np.int32, np.float32) or a.ndim > _MAX_DIMS:
                raise ValueError(f"broadcast_arrays takes 32-bit arrays, got {a.dtype} {a.shape}")
            head[i, 0] = int(a.dtype == np.float32)
            head[i, 1] = a.ndim
            head[i, 2:2 + a.ndim] = torch.tensor(a.shape)
    head = broadcast(head.to(dev), src, mesh.world).cpu()
    shapes = [tuple(int(s) for s in row[2:2 + int(row[1])]) for row in head]
    sizes = [int(np.prod(s)) for s in shapes]
    words = torch.empty(sum(sizes), dtype=torch.int32)
    if mesh.rank == src:
        if words.numel():
            np.concatenate([a.reshape(-1).view(np.int32) for a in arrays], out=words.numpy())
    words = broadcast(words.to(dev), src, mesh.world).cpu().numpy()
    out, at = [], 0
    for row, shape, size in zip(head, shapes, sizes):
        a = words[at:at + size].reshape(shape)
        out.append(a.view(np.float32) if int(row[0]) else a)
        at += size
    return out
