"""Shared enum types (reference: pkg/types/*.go and api common protos)."""

from __future__ import annotations

import enum


class HostType(enum.IntEnum):
    """Peer host roles (reference: pkg/types — Normal < Super < Strong < Weak seeds).

    The evaluator scores seed types above normal peers
    (scheduler/scheduling/evaluator/evaluator_base.go host-type feature).
    """

    NORMAL = 0
    SUPER_SEED = 1
    STRONG_SEED = 2
    WEAK_SEED = 3

    @property
    def is_seed(self) -> bool:
        return self is not HostType.NORMAL

    @property
    def name_str(self) -> str:
        return _HOST_TYPE_NAMES[self]


_HOST_TYPE_NAMES = {
    HostType.NORMAL: "normal",
    HostType.SUPER_SEED: "super",
    HostType.STRONG_SEED: "strong",
    HostType.WEAK_SEED: "weak",
}


class SizeScope(enum.IntEnum):
    """Task content-size buckets that pick the scheduling shortcut
    (reference: scheduler/resource/task.go:444-470).

    EMPTY → zero-byte response inline; TINY (≤128 B) → bytes inline in the
    scheduler response; SMALL (single piece) → single parent, no DAG;
    NORMAL → full piece-level swarm scheduling; UNKNOWN → length not known yet.
    """

    NORMAL = 0
    SMALL = 1
    TINY = 2
    EMPTY = 3
    UNKNOWN = 4


EMPTY_FILE_SIZE = 0
TINY_FILE_SIZE = 128


class Priority(enum.IntEnum):
    """Download priority levels (reference: common v2 Priority proto).

    LEVEL0 is highest; the scheduler maps priority to seed-peer trigger
    behavior (service_v2.go:1370 downloadTaskBySeedPeer).
    """

    LEVEL0 = 0
    LEVEL1 = 1
    LEVEL2 = 2
    LEVEL3 = 3
    LEVEL4 = 4
    LEVEL5 = 5
    LEVEL6 = 6


class TrainingModelType(enum.Enum):
    """Model families the trainer produces (reference: manager/models/model.go gnn|mlp)."""

    GNN = "gnn"
    MLP = "mlp"
