"""The port's serve modes catch SIGINT and SIGTERM before they print their
ready line, so a supervisor may signal as soon as it reads the line: the
binary then stops its serving handle and exits 0, where a signal that came
first killed it with -15 before the handle was stopped.

Each binary's ``run`` goes in process with its ``serve`` replaced by a stub
that reads the SIGTERM handler at the moment the real ``serve`` prints the
ready line.  A thread sends SIGTERM once ``run`` has put its own handler in,
so the test process never takes the signal unhandled.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import pytest

from dragonfly2_tpu_torch.cli import manager, scheduler, trainer

CASES = {
    "manager": (manager, []),
    "scheduler": (scheduler, ["--device", "cpu"]),
    "trainer": (trainer, ["--device", "cpu"]),
}


class _Serving:
    """What ``run`` needs of a serve handle."""

    stopped = False

    def stop(self) -> None:
        self.stopped = True


@pytest.mark.parametrize("kind", list(CASES))
def test_serve_mode_catches_sigterm_before_its_ready_line(kind, monkeypatch, tmp_path):
    module, argv = CASES[kind]
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_METRICS_ENABLE", "false")
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_STORAGE_DIR", str(tmp_path / "records"))
    monkeypatch.setenv("DRAGONFLY_TRAINER_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR", str(tmp_path / "blobs"))
    before = signal.getsignal(signal.SIGTERM)
    serving = _Serving()
    at_ready_line = []

    def serve(cfg, **kwargs):
        at_ready_line.append(signal.getsignal(signal.SIGTERM))
        return serving

    monkeypatch.setattr(module, "serve", serve)

    def terminate_once_caught():
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if at_ready_line and signal.getsignal(signal.SIGTERM) is not before:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.01)

    sender = threading.Thread(target=terminate_once_caught, daemon=True)
    sender.start()
    rc = module.run(argv)
    sender.join(timeout=30.0)
    assert not sender.is_alive()
    assert rc == 0 and serving.stopped
    assert len(at_ready_line) == 1
    assert at_ready_line[0] is not before and callable(at_ready_line[0])
    assert signal.getsignal(signal.SIGTERM) is before
