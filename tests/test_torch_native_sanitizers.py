"""The sanitizer gates of the port's native engine: the port's
``native_test.cpp`` (which includes its ``native.cpp``) built and run
plain, under AddressSanitizer with UndefinedBehaviorSanitizer, under
ThreadSanitizer and under UndefinedBehaviorSanitizer alone, each with the
reference Makefile's flags and options (``native.SELF_TESTS``).

The counterpart of ``tests/test_native_sanitizers.py``, with one
difference: the reference's gates run binaries its Makefile built and
skip where none was; these build their own binary into
``build/dragonfly2_tpu_torch_native/`` (keyed by the sources' hash) and
never skip.  A gate passes on exit 0 with the self-test's own
``native_test: OK`` marker.  The self-test's scratch directories go under
the test's temporary directory (``TMPDIR``).  The ASan gate, over a minute
with its build, carries the ``slow`` marker; run every gate with
``python -m pytest tests/test_torch_native_sanitizers.py``.
"""

from __future__ import annotations

import os
import subprocess

import pytest

from dragonfly2_tpu_torch import native


def _run_gate(kind: str, tmp_path) -> None:
    binary = native.build_self_test(kind)
    env = dict(os.environ, TMPDIR=str(tmp_path), **native.SELF_TESTS[kind][1])
    proc = subprocess.run([str(binary)], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, (
        f"{binary.name} exited {proc.returncode}\n"
        f"--- stdout ---\n{proc.stdout[-4000:]}\n"
        f"--- stderr ---\n{proc.stderr[-4000:]}"
    )
    # The binary's own success marker, so a crash after the last assert
    # (or an exec of the wrong file) cannot pass on exit-code luck.
    assert "native_test: OK" in proc.stdout, proc.stdout[-2000:]


class TestNativeSanitizerGates:
    def test_plain_self_test(self, tmp_path):
        _run_gate("plain", tmp_path)

    # ~64 s here with its build (g++ 12.2, the asan link): past the
    # suite's ~30 s a test, so deselected by ``-m 'not slow'``.
    @pytest.mark.slow
    def test_asan_gate(self, tmp_path):
        _run_gate("asan", tmp_path)

    def test_tsan_gate(self, tmp_path):
        _run_gate("tsan", tmp_path)

    def test_ubsan_gate(self, tmp_path):
        _run_gate("ubsan", tmp_path)
