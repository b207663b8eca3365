"""Daemon local storage: piece files + quota GC.

Reference: client/daemon/storage/storage_manager.go (TaskStorageDriver
:54-135, ReloadPersistentTask :703-760, Reclaimer :82-91).

Port of ``dragonfly2_tpu/daemon/storage.py`` with the Python piece store
only: its layout (``header.json``, the ``pieces.jsonl`` journal and one
``data`` file a task) is the reference's Python store's, so either
package reloads a task the other wrote.  The reference prefers its
native C++ store when that builds; the port has no native engine
(ROADMAP queue 1 item 14), so ``prefer_native`` defaults to False and
True raises.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np


logger = logging.getLogger(__name__)


class _PyPieceStore:
    """Pure-Python fallback with the same API as native.NativePieceStore."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._meta: Dict[str, dict] = {}
        self._mu = threading.Lock()

    def _dir(self, task_id: str) -> str:
        return os.path.join(self.root, task_id)

    def _load_meta(self, task_id: str) -> Optional[dict]:
        with self._mu:
            if task_id in self._meta:
                return self._meta[task_id]
        header_path = os.path.join(self._dir(task_id), "header.json")
        if not os.path.exists(header_path):
            return None
        with open(header_path) as f:
            meta = json.load(f)
        meta["pieces"] = {}
        # Piece commits are an append-only journal (one JSON line each) so
        # per-piece metadata I/O is O(1), matching the native engine; a torn
        # trailing line (crash mid-append) is skipped.
        journal = os.path.join(self._dir(task_id), "pieces.jsonl")
        if os.path.exists(journal):
            with open(journal) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    meta["pieces"][int(rec["n"])] = {
                        "length": rec["length"],
                        "crc": rec["crc"],
                    }
        with self._mu:
            self._meta[task_id] = meta
        return meta

    def _append_journal(self, task_id: str, number: int, info: dict) -> None:
        journal = os.path.join(self._dir(task_id), "pieces.jsonl")
        with open(journal, "a") as f:
            f.write(
                json.dumps({"n": number, "length": info["length"], "crc": info["crc"]})
                + "\n"
            )

    def create_task(self, task_id: str, piece_size: int, content_length: int) -> None:
        os.makedirs(self._dir(task_id), exist_ok=True)
        if self._load_meta(task_id) is None:
            meta = {
                "piece_size": piece_size,
                "content_length": content_length,
                "pieces": {},
            }
            with self._mu:
                self._meta[task_id] = meta
            header_path = os.path.join(self._dir(task_id), "header.json")
            tmp = header_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"piece_size": piece_size, "content_length": content_length}, f)
            os.replace(tmp, header_path)

    def load_task(self, task_id: str) -> bool:
        return self._load_meta(task_id) is not None

    def write_piece(self, task_id: str, number: int, data: bytes) -> int:
        meta = self._load_meta(task_id)
        if meta is None:
            raise KeyError(task_id)
        path = os.path.join(self._dir(task_id), "data")
        with self._mu:
            # Serialized create+write: a concurrent first-write pair must
            # not both open "wb" (the second truncates the first's piece).
            if not os.path.exists(path):
                open(path, "wb").close()
            with open(path, "r+b") as f:
                f.seek(number * meta["piece_size"])
                f.write(data)
            info = {"length": len(data), "crc": zlib.crc32(data)}
            meta["pieces"][number] = info
            self._append_journal(task_id, number, info)
        return len(data)

    def piece_size(self, task_id: str) -> int:
        meta = self._load_meta(task_id)
        return meta["piece_size"] if meta else -1

    def read_piece(self, task_id: str, number: int, *, max_len: Optional[int] = None, verify: bool = True) -> bytes:
        meta = self._load_meta(task_id)
        if meta is None or number not in meta["pieces"]:
            raise KeyError(f"piece {number} of {task_id}")
        info = meta["pieces"][number]
        length = info["length"] if max_len is None else min(max_len, info["length"])
        with open(os.path.join(self._dir(task_id), "data"), "rb") as f:
            f.seek(number * meta["piece_size"])
            data = f.read(length)
        # A max_len-limited read can't cover the whole-piece digest; the
        # write-time crc stands for it (read_piece_at documents the same).
        if verify and length == info["length"] and zlib.crc32(data) != info["crc"]:
            raise IOError(f"crc mismatch piece {number} of {task_id}")
        return data

    def read_piece_at(
        self, task_id: str, number: int, offset: int, max_len: int
    ) -> bytes:
        """Sub-piece read: ``max_len`` bytes of piece ``number`` starting
        ``offset`` bytes in — a Range request for 100 bytes reads 100
        bytes, not a 4 MiB piece.  The whole-piece crc can't cover a
        partial read; the write-time digest stands for the span."""
        meta = self._load_meta(task_id)
        if meta is None or number not in meta["pieces"]:
            raise KeyError(f"piece {number} of {task_id}")
        info = meta["pieces"][number]
        if offset >= info["length"] or max_len <= 0:
            return b""
        take = min(max_len, info["length"] - offset)
        with open(os.path.join(self._dir(task_id), "data"), "rb") as f:
            f.seek(number * meta["piece_size"] + offset)
            return f.read(take)

    def piece_file_span(
        self, task_id: str, number: int
    ) -> Optional[Tuple[str, int, int]]:
        """(path, byte offset, length) of a committed piece inside the
        plain data file — the zero-copy (``os.sendfile``) serve handle.
        None when the piece isn't committed."""
        meta = self._load_meta(task_id)
        if meta is None or number not in meta["pieces"]:
            return None
        return (
            os.path.join(self._dir(task_id), "data"),
            number * meta["piece_size"],
            meta["pieces"][number]["length"],
        )

    def piece_count(self, task_id: str) -> int:
        meta = self._load_meta(task_id)
        return len(meta["pieces"]) if meta else 0

    def piece_bitmap(self, task_id: str, n_pieces: int) -> np.ndarray:
        out = np.zeros(n_pieces, dtype=np.uint8)
        meta = self._load_meta(task_id)
        if meta:
            for n in meta["pieces"]:
                if n < n_pieces:
                    out[n] = 1
        return out

    def task_bytes(self, task_id: str) -> int:
        meta = self._load_meta(task_id)
        if not meta:
            return 0
        return sum(p["length"] for p in meta["pieces"].values())

    def content_length(self, task_id: str) -> int:
        meta = self._load_meta(task_id)
        return meta["content_length"] if meta else -1

    def delete_task(self, task_id: str) -> None:
        import shutil

        with self._mu:
            self._meta.pop(task_id, None)
        shutil.rmtree(self._dir(task_id), ignore_errors=True)

    def close(self) -> None:
        pass


class DaemonStorage:
    """Task-level storage manager with quota GC, on the Python piece
    store.  ``prefer_native=True`` asks for the native engine, which is
    not ported (ROADMAP queue 1 item 14), and raises."""

    def __init__(
        self,
        root: str,
        *,
        quota_bytes: int = 10 << 30,
        prefer_native: bool = False,
    ) -> None:
        if prefer_native:
            raise NotImplementedError(
                "DaemonStorage(prefer_native=True): the native piece store is "
                "not ported yet (ROADMAP queue 1 item 14)"
            )
        self.root = root
        self.quota_bytes = quota_bytes
        self.engine = _PyPieceStore(root)
        self._mu = threading.Lock()
        self._tasks: Dict[str, dict] = {}  # task_id → {piece_size, atime}

    @property
    def is_native(self) -> bool:
        return not isinstance(self.engine, _PyPieceStore)

    # -- task lifecycle ------------------------------------------------------

    def register_task(self, task_id: str, *, piece_size: int, content_length: int) -> None:
        self.engine.create_task(task_id, piece_size, content_length)
        with self._mu:
            self._tasks[task_id] = {"piece_size": piece_size, "atime": time.time()}

    def reload_persistent_tasks(self, task_ids: List[str]) -> List[str]:
        """Crash restart: reopen tasks that survived on disk
        (storage_manager.go:703-760 ReloadPersistentTask)."""
        loaded = []
        for tid in task_ids:
            if self.engine.load_task(tid):
                with self._mu:
                    self._tasks[tid] = {
                        "piece_size": 0,
                        "atime": time.time(),
                    }
                loaded.append(tid)
        return loaded

    def scan_disk_tasks(self) -> List[str]:
        """Task dirs present on disk (restart discovery)."""
        try:
            return sorted(
                d
                for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))
            )
        except FileNotFoundError:
            return []

    # -- pieces --------------------------------------------------------------

    def write_piece(self, task_id: str, number: int, data: bytes) -> int:
        with self._mu:
            if task_id in self._tasks:
                self._tasks[task_id]["atime"] = time.time()
        return self.engine.write_piece(task_id, number, data)

    def touch_task(self, task_id: str) -> None:
        """LRU-evidence touch for commits that bypassed ``write_piece`` —
        the in-engine fetch loop (DESIGN.md §28) writes pieces directly
        through the native engine; without the touch a task filled that
        way would look idle to quota reclaim."""
        with self._mu:
            if task_id in self._tasks:
                self._tasks[task_id]["atime"] = time.time()

    def read_piece(self, task_id: str, number: int, *, verify: bool = True) -> bytes:
        with self._mu:
            if task_id in self._tasks:
                self._tasks[task_id]["atime"] = time.time()
        return self.engine.read_piece(task_id, number, verify=verify)

    def read_piece_at(
        self, task_id: str, number: int, offset: int, max_len: int
    ) -> bytes:
        """Sub-piece read for Range serving: only the requested span hits
        the disk when the engine supports offset reads; engines without
        them (the native store's ctypes surface) fall back to a
        whole-piece read + slice."""
        with self._mu:
            if task_id in self._tasks:
                self._tasks[task_id]["atime"] = time.time()
        at = getattr(self.engine, "read_piece_at", None)
        if at is not None:
            return at(task_id, number, offset, max_len)
        data = self.engine.read_piece(task_id, number)
        return data[offset : offset + max_len]

    def piece_file_span(
        self, task_id: str, number: int
    ) -> Optional[Tuple[str, int, int]]:
        """Zero-copy serve handle: (path, offset, length) of a committed
        piece inside the engine's plain data file, or None when the
        engine doesn't expose one (native store — its own in-engine
        server already serves via sendfile)."""
        span_fn = getattr(self.engine, "piece_file_span", None)
        return span_fn(task_id, number) if span_fn is not None else None

    def range_file_span(
        self, task_id: str, start: int, length: int
    ) -> Optional[Tuple[str, int, int]]:
        """Zero-copy handle for a BYTE RANGE: pieces are laid out at
        ``number * piece_size`` in one data file, so a content byte range
        maps 1:1 onto a contiguous file span — IF every overlapping piece
        is committed.  None otherwise (serve falls back to piece reads)."""
        ps = self.piece_size(task_id)
        total = self.content_length(task_id)
        if ps <= 0 or total < 0 or length <= 0 or start < 0:
            return None
        end = min(start + length, total)
        if end <= start:
            return None
        first, last = start // ps, (end - 1) // ps
        path = None
        for num in range(first, last + 1):
            span = self.piece_file_span(task_id, num)
            if span is None:
                return None
            path = span[0]
        return (path, start, end - start)

    def piece_bitmap(self, task_id: str, n_pieces: int) -> np.ndarray:
        return self.engine.piece_bitmap(task_id, n_pieces)

    def has_piece(self, task_id: str, number: int) -> bool:
        bm = self.engine.piece_bitmap(task_id, number + 1)
        return bool(bm[number])

    def task_bytes(self, task_id: str) -> int:
        return self.engine.task_bytes(task_id)

    def held_pieces(self, task_id: str) -> int:
        """Pieces actually written and committed — NOT the header total
        (n_pieces): progress reporting must count data on disk."""
        try:
            return self.engine.piece_count(task_id)
        except Exception as exc:  # noqa: BLE001 — unknown task → nothing held
            logger.debug("piece_count(%s): %s", task_id, exc)
            return 0

    def content_length(self, task_id: str) -> int:
        """Header content length; -1 when the task is unknown."""
        return self.engine.content_length(task_id)

    def piece_size(self, task_id: str) -> int:
        """Header piece size; -1 when the task is unknown."""
        return self.engine.piece_size(task_id)

    def n_pieces(self, task_id: str) -> int:
        """Piece count from the task header; -1 when the header is absent
        or invalid (single owner of the ceil-div + validity idiom)."""
        total = self.engine.content_length(task_id)
        ps = self.engine.piece_size(task_id)
        if total < 0 or ps <= 0:
            return -1
        return (total + ps - 1) // ps

    def read_task_bytes(self, task_id: str) -> bytes:
        """Reassemble a completed task's content from its pieces."""
        total = self.engine.content_length(task_id)
        ps = self.engine.piece_size(task_id)
        if total < 0 or ps <= 0:
            raise KeyError(f"task {task_id} has no header")
        out = bytearray()
        remaining = total
        n = 0
        while remaining > 0:
            piece = self.read_piece(task_id, n)
            out += piece[: min(len(piece), remaining)]
            remaining -= len(piece)
            n += 1
        return bytes(out)

    def total_bytes(self) -> int:
        with self._mu:
            tids = list(self._tasks)
        return sum(self.engine.task_bytes(t) for t in tids)

    def delete_task(self, task_id: str) -> None:
        with self._mu:
            self._tasks.pop(task_id, None)
        self.engine.delete_task(task_id)

    # -- quota GC (Reclaimer) ------------------------------------------------

    def reclaim(self) -> List[str]:
        """Evict least-recently-used tasks until under quota
        (storage_manager.go Reclaimer :82-91)."""
        reclaimed: List[str] = []
        while self.total_bytes() > self.quota_bytes:
            with self._mu:
                if not self._tasks:
                    break
                victim = min(self._tasks, key=lambda t: self._tasks[t]["atime"])
            self.delete_task(victim)
            reclaimed.append(victim)
        return reclaimed

    def close(self) -> None:
        self.engine.close()
