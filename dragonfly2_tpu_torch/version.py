"""Build metadata (reference: version/ — git/go version + platform embedded
in announces and version commands).

Port of ``dragonfly2_tpu/version.py``; the version is the port package's.
"""

from __future__ import annotations

import platform
import subprocess
import sys
from dataclasses import dataclass, field


@dataclass(frozen=True)
class BuildInfo:
    version: str
    git_commit: str
    python_version: str
    platform: str

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "git_commit": self.git_commit,
            "python_version": self.python_version,
            "platform": self.platform,
        }


def _git_commit() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
        )
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build_info() -> BuildInfo:
    from . import __version__

    return BuildInfo(
        version=__version__,
        git_commit=_git_commit(),
        python_version=sys.version.split()[0],
        platform=f"{platform.system().lower()}/{platform.machine()}",
    )
