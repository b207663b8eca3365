"""Fused slot-row gather + mask-folded MLP scoring on the card.

Port of ``dragonfly2_tpu/ops/pallas_score.py``.  The columnar host store
(scheduler/featcache.py, DESIGN.md §18) keys serving state by SLOT ID, so
the scorer needs no host-side feature-matrix assembly: one kernel launch
per batcher flush takes the device mirror of the slot matrix, the
parent/child slot-id vectors and the per-edge feature block, and
produces the scores.

- **gather in kernel** — each row's parent and child rows are read out
  of the device-resident slot matrix by slot id; no ``[n, 2H+E]``
  feature matrix ever exists.
- **split first layer** — ``x @ W0`` over the concatenated layout
  ``[child | parent | edge]`` is ``child @ W0c + parent @ W0p +
  edge @ W0e`` with W0 row-partitioned.
- **mask folded** — post-hoc feature masking is zeroed W0 rows, folded
  once at scorer construction (trainer/export.py ``_serving_weights``).
- **gelu chain on chip** — the rest of the exported serving MLP
  (32→64→64→1) runs without leaving the SM.
- **one weight blob** — the served weights are packed once into one
  16-byte-aligned buffer (``pack_k1_weights``) that each block of the
  kernel copies into shared memory with two bulk asynchronous copies.
- **one upload, one download a flush** — ``FusedMLPScorer.score`` packs
  the slot ids and the edge block into one pinned buffer and reads the
  scores back through another.

The kernels are CUDA C++ (``csrc/fused_score.cu``); each wrapper here
launches its kernel for CUDA tensors and takes the plain PyTorch version
beside it for CPU tensors (the CPU tests), and counts its launches in
``LAUNCHES``.

``FusedMLPScorer`` wraps K1 behind the ``EdgeScorer`` surface with
``static_shapes = True``, so ``ScorerBatcher`` pads flushes up its bucket
ladder, and keeps a device mirror of the slot matrix synced against the
store's ``_row_version``.  ``rule_weighted_sum`` is the rule path's arm:
the evaluator's six component columns reduce to one weighted sum (K2).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..records.features import EDGE_FEATURE_DIM, HOST_FEATURE_DIM, POST_HOC_FEATURE_IDX
from . import _build

if TYPE_CHECKING:
    from ..scheduler.featcache import HostFeatureCache

# The exported serving MLP depth the kernel runs (32→d1→d2→1); other
# depths take the split-matmul torch path.
_KERNEL_LAYERS = 3

# Rule-evaluator component weights in evaluator.evaluate term order:
# piece, upload-success, free-upload, host-type, idc, location.
RULE_COMPONENT_WEIGHTS = (0.2, 0.2, 0.15, 0.15, 0.15, 0.15)

# Launches per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {"fused_gather_mlp_score": 0, "rule_weighted_sum": 0}
_launch_mu = threading.Lock()

# The largest dynamic shared memory one block may use on Hopper.
_MAX_SMEM_BYTES = 232448

# 4-byte words a row of one flush's staging: parent slot, child slot and
# the edge features (FusedMLPScorer.score).
_IN_WORDS = 2 + EDGE_FEATURE_DIM


def _count_launch(name: str) -> None:
    with _launch_mu:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_mu:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """gelu (tanh form) — the scorer's exact serving formula
    (trainer/export._np_gelu): x*x*x, never x**3; not ``F.gelu``, whose
    default is the erf form."""
    x3 = x * x * x
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608 * (x + 0.044715 * x3)))


def fold_post_hoc_weights(
    weights: List[Tuple[np.ndarray, np.ndarray]],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Zero the post-hoc feature ROWS of W0 (bit-identical to zeroing
    the feature columns — both make the dot terms exact 0.0)."""
    w0, b0 = weights[0]
    w0 = np.array(w0, dtype=np.float32, copy=True)
    w0[list(POST_HOC_FEATURE_IDX), :] = 0.0
    return [(w0, np.asarray(b0, np.float32))] + [
        (np.asarray(w, np.float32), np.asarray(b, np.float32))
        for w, b in weights[1:]
    ]


def split_first_layer(
    w0: np.ndarray, host_dim: int = HOST_FEATURE_DIM
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-partition W0 over the ``[child | parent | edge]`` feature
    layout: (W0c [H, D1], W0p [H, D1], W0e [E, D1])."""
    return (
        np.ascontiguousarray(w0[:host_dim]),
        np.ascontiguousarray(w0[host_dim : 2 * host_dim]),
        np.ascontiguousarray(w0[2 * host_dim :]),
    )


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def k1_blob_layout(d1: int, d2: int) -> Tuple[int, int, int, int]:
    """(part A floats, part B floats, padded d1, padded d2) of K1's
    weight blob — the layout ``BlobLayout`` in ``csrc/fused_score.cu``
    reads.  Part A: W0 [32, d1] (child, parent, edge rows) | b0 [d1p];
    part B: W1 [d1p, d2p] | b1 [d2p] | W2 [d2p] | b2, each width padded
    to a multiple of 4; every piece starts on 16 bytes and the pads are
    zero."""
    d1p, d2p = _round4(d1), _round4(d2)
    return 32 * d1 + d1p, d1p * d2p + 2 * d2p + 4, d1p, d2p


def pack_k1_weights(w0c, w0p, w0e, b0, w1, b1, w2, b2) -> np.ndarray:
    """The 3-layer serving MLP as K1's one f32 weight blob."""
    d1, d2 = w0c.shape[1], w1.shape[1]
    a, b, d1p, d2p = k1_blob_layout(d1, d2)
    blob = np.zeros(a + b, np.float32)
    blob[: 32 * d1] = np.concatenate([w0c, w0p, w0e]).reshape(-1)
    blob[32 * d1 : 33 * d1] = np.reshape(b0, -1)
    part_b = blob[a:]
    part_b[: d1p * d2p].reshape(d1p, d2p)[:d1, :d2] = w1
    o = d1p * d2p
    part_b[o : o + d2] = np.reshape(b1, -1)
    part_b[o + d2p : o + d2p + d2] = np.reshape(w2, -1)
    part_b[o + 2 * d2p] = np.reshape(b2, -1)[0]
    return blob


def unpack_k1_weights(blob, d1: int, d2: int) -> Dict:
    """Inverse of ``pack_k1_weights``, in ``ServingMLP``'s buffer shapes:
    views of ``blob`` (a numpy array or a tensor)."""
    a, _, d1p, d2p = k1_blob_layout(d1, d2)
    w0 = blob[: 32 * d1].reshape(32, d1)
    part_b = blob[a:]
    o = d1p * d2p
    return {
        "w0c": w0[:HOST_FEATURE_DIM], "w0p": w0[HOST_FEATURE_DIM : 2 * HOST_FEATURE_DIM],
        "w0e": w0[2 * HOST_FEATURE_DIM :], "b0": blob[32 * d1 : 33 * d1],
        "w1": part_b[:o].reshape(d1p, d2p)[:d1, :d2], "b1": part_b[o : o + d2],
        "w2": part_b[o + d2p : o + d2p + d2].reshape(d2, 1),
        "b2": part_b[o + 2 * d2p : o + 2 * d2p + 1],
    }


class ServingMLP(nn.Module):
    """The served (mask-folded, first-layer-split) weights as
    non-trainable device buffers, in the exported ``[in, out]`` layout:
    ``w0c``/``w0p``/``w0e``/``b0`` for the first layer, then ``w{i}``/
    ``b{i}`` for each later layer.  At the kernel's depth the weights are
    stored once, as ``k1_blob`` (``pack_k1_weights``), the buffer K1
    copies into shared memory, and the per-layer buffers are views of it
    (``unpack_k1_weights``)."""

    def __init__(
        self,
        weights: List[Tuple[np.ndarray, np.ndarray]],
        *,
        post_hoc_masked: bool = True,
        device="cuda",
    ) -> None:
        super().__init__()
        served = (
            fold_post_hoc_weights(weights) if post_hoc_masked
            else [
                (np.asarray(w, np.float32), np.asarray(b, np.float32))
                for w, b in weights
            ]
        )
        device = _build.resolve_device(device)

        def buf(name: str, a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            self.register_buffer(name, t.to(device))
            return getattr(self, name)

        w0c, w0p, w0e = split_first_layer(served[0][0])
        self.depth = len(served)
        if self.depth == _KERNEL_LAYERS:
            (w1, b1), (w2, b2) = served[1:]
            blob = buf("k1_blob", pack_k1_weights(w0c, w0p, w0e, served[0][1], w1, b1, w2, b2))
            for name, view in unpack_k1_weights(blob, w0c.shape[1], w1.shape[1]).items():
                self.register_buffer(name, view)
            return
        buf("w0c", w0c)
        buf("w0p", w0p)
        buf("w0e", w0e)
        buf("b0", served[0][1].reshape(-1))
        for i, (w, b) in enumerate(served[1:], start=1):
            buf(f"w{i}", w)
            buf(f"b{i}", b.reshape(-1))

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """[(W, b)] of the layers after the first."""
        return [
            (getattr(self, f"w{i}"), getattr(self, f"b{i}"))
            for i in range(1, self.depth)
        ]

    def forward(self, matrix, slots, dslots, edge) -> torch.Tensor:
        """[n] scores of rows (parent ``slots``, child ``dslots``,
        ``edge``) over the slot ``matrix``: the kernel at the exported
        depth, the split-matmul torch path at any other."""
        if self.depth == _KERNEL_LAYERS:
            return fused_gather_mlp_score(matrix, slots, dslots, edge, self)
        return _fused_score_plain(
            matrix, slots, dslots, edge,
            self.w0c, self.w0p, self.w0e, self.b0, self.layers(),
        )


# ---------------------------------------------------------------------------
# K1: fused gather + MLP score
# ---------------------------------------------------------------------------


def _fused_score_plain(
    matrix, slots, dslots, edge, w0c, w0p, w0e, b0,
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
) -> torch.Tensor:
    """K1's plain PyTorch version: ``index_select`` gathers, the three
    partial first-layer products, the explicit tanh-gelu stack.  All
    float32; on the card this is float32 only with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's
    default), which the caller sets."""
    x = (
        matrix.index_select(0, dslots) @ w0c
        + matrix.index_select(0, slots) @ w0p
        + edge @ w0e
        + b0
    )
    for w, b in layers:
        x = _gelu(x)
        x = x @ w + b
    return x[:, 0]


def _check_k1_inputs(matrix, slots, dslots, edge, tensors) -> None:
    dev = matrix.device
    for t in (matrix, slots, dslots, edge, *tensors):
        if t.device != dev:
            raise ValueError(f"K1 inputs span devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("K1 inputs must be contiguous")
    for t in (matrix, edge, *tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"K1 takes float32 matrix/edge/weights, got {t.dtype}")
    if slots.dtype != torch.int32 or dslots.dtype != torch.int32:
        raise TypeError("K1 takes int32 slot ids")
    n = edge.shape[0]
    if matrix.dim() != 2 or matrix.shape[1] != HOST_FEATURE_DIM:
        raise ValueError(f"slot matrix must be [S, {HOST_FEATURE_DIM}]")
    if edge.dim() != 2 or edge.shape[1] != EDGE_FEATURE_DIM:
        raise ValueError(f"edge block must be [n, {EDGE_FEATURE_DIM}]")
    if slots.shape != (n,) or dslots.shape != (n,):
        raise ValueError("slot-id vectors must be [n]")


def fused_gather_mlp_score(
    matrix: torch.Tensor,
    slots: torch.Tensor,
    dslots: torch.Tensor,
    edge: torch.Tensor,
    mlp: ServingMLP,
) -> torch.Tensor:
    """[n] f32 scores: row r gathers ``matrix[dslots[r]]`` (child) and
    ``matrix[slots[r]]`` (parent) and runs the 3-layer serving MLP of
    ``mlp`` over ``[child | parent | edge[r]]``.

    CUDA tensors launch K1 (``csrc/fused_score.cu``), which replaces
    ``dragonfly2_tpu/ops/pallas_score.py:114`` ``_fused_score_kernel``;
    CPU tensors take ``_fused_score_plain``.  Slot ids must lie in
    ``[0, S)``: the kernel never reads outside the matrix and scores a
    row whose id does not NaN (``FusedMLPScorer.score`` checks the ids
    on the host before they are uploaded).  The kernel reads the
    weights from ``mlp.k1_blob``; the plain version from the per-layer
    views of it."""
    if mlp.depth != _KERNEL_LAYERS:
        raise ValueError(f"K1 runs the {_KERNEL_LAYERS}-layer serving MLP")
    (w1, b1), (w2, b2) = mlp.layers()
    _check_k1_inputs(matrix, slots, dslots, edge, (mlp.k1_blob,))
    if matrix.device.type == "cpu":
        return _fused_score_plain(
            matrix, slots, dslots, edge,
            mlp.w0c, mlp.w0p, mlp.w0e, mlp.b0, mlp.layers(),
        )
    if matrix.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {matrix.device}")
    n = edge.shape[0]
    d1 = mlp.w0c.shape[1]
    d2 = w1.shape[1]
    if w1.shape != (d1, d2) or w2.shape != (d2, 1) or b2.numel() != 1:
        raise ValueError("K1 takes widths 32→d1→d2→1")
    blob = mlp.k1_blob
    if blob.data_ptr() % 16:
        raise ValueError("K1's weight blob must be 16-byte aligned")
    out = torch.empty(n, dtype=torch.float32, device=matrix.device)
    if n == 0:
        return out
    lib = _build.load()
    if lib.df_fused_score_smem_bytes(d1, d2) > _MAX_SMEM_BYTES:
        raise ValueError(f"K1's weights for widths {d1}, {d2} exceed shared memory")
    if lib.df_fused_score_blob_floats(d1, d2) != blob.numel():
        raise ValueError("K1's weight blob does not match its widths")
    code = lib.df_fused_gather_mlp_score(
        matrix.data_ptr(), matrix.shape[0], slots.data_ptr(), dslots.data_ptr(),
        edge.data_ptr(), blob.data_ptr(), out.data_ptr(),
        n, d1, d2, _build.stream_handle(matrix.device),
    )
    _build.check(lib, "fused_gather_mlp_score", code)
    _count_launch("fused_gather_mlp_score")
    return out


# ---------------------------------------------------------------------------
# EdgeScorer wrapper: the serving form
# ---------------------------------------------------------------------------


class FusedMLPScorer:
    """EdgeScorer over slot ids (scheduler/evaluator.py ``wants_slots``
    protocol): ``score(edge_block, src_buckets=parent_slots,
    dst_buckets=child_slots)`` — the host rows come out of the device
    mirror of the columnar store's slot matrix.

    ``static_shapes = True`` engages the batcher's pad ladder; this
    class additionally pads to its candidate-block multiple, so the
    device sees a handful of shapes.  The mirror re-uploads only when
    the store's row version moved (one locked snapshot per stale flush).

    Standardized artifacts (``feat_mean`` set) are not supported — the
    post-hoc mask cannot fold into W1 there (trainer/export.py), so the
    fused first-layer split would not be mask-correct.
    """

    static_shapes = True
    wants_features = True
    wants_slots = True

    def __init__(
        self,
        store: "HostFeatureCache",
        weights: List[Tuple[np.ndarray, np.ndarray]],
        *,
        post_hoc_masked: bool = True,
        cand_block: int = 128,
        device="cuda",
    ) -> None:
        from ..trainer.export import MLPScorer

        self._store = store
        self.cand_block = int(cand_block)
        self.device = _build.resolve_device(device)
        self.mlp = ServingMLP(weights, post_hoc_masked=post_hoc_masked, device=self.device)
        # Reference path: the numpy serving scorer over assembled rows —
        # byte-identical to the non-fused serving path; used when the
        # store served uncached (no slots) or a shadow engine needs the
        # full feature matrix (scheduler/evaluator.py).
        self._ref = MLPScorer(weights=weights, post_hoc_masked=post_hoc_masked)
        self._mirror_mu = threading.Lock()
        self._mat_dev = None
        self._mat_version = None
        # Staging of one flush (``_staging``): slot ids and edge block in
        # one host buffer (pinned on the card), its device twin, and the
        # pinned buffer the scores come back through.  ``_io_mu`` guards
        # them: the batcher's leader and direct callers both reach score.
        self._io_mu = threading.Lock()
        self._host_in = self._dev_in = self._host_out = None
        # Host<->device copies made by score, the mirror's re-syncs apart.
        self.uploads = 0
        self.downloads = 0

    @classmethod
    def from_scorer(cls, store, scorer, **kw) -> "FusedMLPScorer":
        """Build from an exported ``MLPScorer`` artifact."""
        if scorer.feat_mean is not None:
            raise ValueError(
                "standardized artifacts cannot serve fused: the post-hoc "
                "mask does not fold through (x-mean)/std (export.py)"
            )
        return cls(
            store, scorer.weights, post_hoc_masked=scorer.post_hoc_masked, **kw
        )

    def _sync_mirror(self) -> torch.Tensor:
        ver = self._store._row_version
        if ver == self._mat_version:
            return self._mat_dev
        with self._mirror_mu:
            if self._store._row_version != self._mat_version:
                version, snap = self._store.matrix_snapshot()
                self._mat_dev = torch.from_numpy(snap).to(self.device)
                self._mat_version = version
            return self._mat_dev

    def _staging(self, n_pad: int):
        """(host words, device words, host scores) holding at least
        ``n_pad`` rows: ``_IN_WORDS`` 4-byte words a row — parent slot,
        child slot, then the 8 edge features — and one score a row."""
        words = _IN_WORDS * n_pad
        if self._host_in is None or self._host_in.numel() < words:
            cap = max(words, 2 * (0 if self._host_in is None else self._host_in.numel()))
            pin = self.device.type == "cuda"
            self._host_in = torch.empty(cap, dtype=torch.int32, pin_memory=pin)
            self._host_out = torch.empty(cap // _IN_WORDS, dtype=torch.float32, pin_memory=pin)
            self._dev_in = (
                torch.empty(cap, dtype=torch.int32, device=self.device) if pin
                else self._host_in
            )
        return self._host_in, self._dev_in, self._host_out

    def score(self, features, *, src_buckets=None, dst_buckets=None) -> np.ndarray:
        """[n, EDGE_FEATURE_DIM] edge block + parent/child SLOT ids →
        [n] scores, one kernel launch (row-independent: padded rows and
        co-batched strangers cannot bleed — the batched-score
        contract).  On the card a flush makes one host→device copy (slot
        ids and edge block packed into one pinned buffer) and one
        device→host copy (the scores), besides a mirror re-sync when the
        store moved."""
        if src_buckets is None or dst_buckets is None:
            raise ValueError("FusedMLPScorer needs parent/child slot ids")
        edge = np.asarray(features, dtype=np.float32)
        src = np.asarray(src_buckets)
        dst = np.asarray(dst_buckets)
        n = edge.shape[0]
        cb = self.cand_block
        n_pad = -(-n // cb) * cb
        mat = self._sync_mirror()
        if n and (
            min(src.min(), dst.min()) < 0
            or max(src.max(), dst.max()) >= mat.shape[0]
        ):
            raise ValueError("slot id outside the slot matrix")
        on_card = self.device.type == "cuda"
        with self._io_mu:
            host_in, dev_in, host_out = self._staging(n_pad)
            words = host_in[: _IN_WORDS * n_pad]
            # int32 words, zero-padded: slot ids arrive as int64 and as
            # broadcast views (evaluator.py).
            w = words.numpy()
            w[:n] = src
            w[n:n_pad] = 0
            w[n_pad : n_pad + n] = dst
            w[n_pad + n : 2 * n_pad] = 0
            e = w[2 * n_pad :].view(np.float32).reshape(n_pad, EDGE_FEATURE_DIM)
            e[:n] = edge
            e[n:] = 0.0
            if on_card:
                dev = dev_in[: _IN_WORDS * n_pad]
                dev.copy_(words, non_blocking=True)
                self.uploads += 1
            else:
                dev = words
            out = self.mlp(
                mat, dev[:n_pad], dev[n_pad : 2 * n_pad],
                dev[2 * n_pad :].view(torch.float32).view(n_pad, EDGE_FEATURE_DIM),
            )
            if not on_card:
                return out.numpy()[:n]
            scores = host_out[:n_pad]
            scores.copy_(out, non_blocking=True)
            self.downloads += 1
            torch.cuda.current_stream(self.device).synchronize()
            return scores.numpy()[:n].copy()

    def score_rows(self, features, **buckets) -> np.ndarray:
        """Assembled-row fallback: byte-identical to the plain numpy
        serving scorer."""
        return self._ref.score(features, **buckets)


# ---------------------------------------------------------------------------
# K2: the rule arm's weighted sum
# ---------------------------------------------------------------------------


def _rule_sum_plain(components: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """K2's plain PyTorch version: the six weighted columns summed in
    term order, float32."""
    w = torch.tensor(weights, dtype=torch.float32, device=components.device)
    return (components * w).sum(dim=1)


def rule_sum(components: torch.Tensor, weights=RULE_COMPONENT_WEIGHTS) -> torch.Tensor:
    """[n, 6] f32 rule components → [n] weighted sums.  CUDA tensors
    launch K2 (``csrc/fused_score.cu``), which replaces
    ``dragonfly2_tpu/ops/pallas_score.py:364`` ``_rule_sum_kernel``; CPU
    tensors take ``_rule_sum_plain``."""
    w = [float(x) for x in weights]
    if components.dim() != 2 or components.shape[1] != 6 or len(w) != 6:
        raise ValueError("rule components must be [n, 6] with six weights")
    if components.dtype != torch.float32 or not components.is_contiguous():
        raise TypeError("rule components must be contiguous float32")
    if components.device.type == "cpu":
        return _rule_sum_plain(components, w)
    if components.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {components.device}")
    n = components.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=components.device)
    if n == 0:
        return out
    lib = _build.load()
    code = lib.df_rule_weighted_sum(
        components.data_ptr(), out.data_ptr(), n, *w,
        _build.stream_handle(components.device),
    )
    _build.check(lib, "rule_weighted_sum", code)
    _count_launch("rule_weighted_sum")
    return out


def rule_weighted_sum(
    components: np.ndarray,
    weights=RULE_COMPONENT_WEIGHTS,
    *,
    device="cuda",
) -> np.ndarray:
    """[n, 6] rule component matrix → [n] float32 scores on ``device``:
    the rule path's arm of the fused dispatch."""
    dev = _build.resolve_device(device)
    comp = torch.from_numpy(np.ascontiguousarray(components, dtype=np.float32))
    return rule_sum(comp.to(dev), weights).cpu().numpy()
