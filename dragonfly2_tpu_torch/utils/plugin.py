"""Plugin loader (reference: internal/dfplugin — Go plugin.Open of
``d7y-<type>-plugin-<name>.so``, used for evaluator/searcher/source
plugins, dfplugin.go:43-88).

The Python analog loads ``df_<type>_plugin_<name>.py`` from a plugin dir
and calls its ``create_plugin(**options)`` factory.  Same naming
discipline, same late binding: the scheduler's ``algorithm: plugin``
resolves its evaluator here.

Port of ``dragonfly2_tpu/utils/plugin.py``, verbatim: the same file
names, so one plugin directory serves either package.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict, List

PLUGIN_PREFIX = "df"


class PluginError(RuntimeError):
    pass


def plugin_filename(plugin_type: str, name: str) -> str:
    return f"{PLUGIN_PREFIX}_{plugin_type}_plugin_{name}.py"


def load_plugin(plugin_dir: str, plugin_type: str, name: str, **options: Any) -> Any:
    """Load and instantiate a plugin; raises PluginError with context."""
    path = os.path.join(plugin_dir, plugin_filename(plugin_type, name))
    if not os.path.exists(path):
        raise PluginError(f"plugin not found: {path}")
    spec = importlib.util.spec_from_file_location(
        f"df_plugin_{plugin_type}_{name}", path
    )
    if spec is None or spec.loader is None:
        raise PluginError(f"cannot load spec for {path}")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    except Exception as exc:  # noqa: BLE001 — plugin boundary
        raise PluginError(f"{path}: import failed: {exc}") from exc
    factory = getattr(module, "create_plugin", None)
    if factory is None:
        raise PluginError(f"{path}: no create_plugin() factory")
    return factory(**options)


def list_plugins(plugin_dir: str) -> List[Dict[str, str]]:
    """Installed plugins (cmd/dependency plugin listing)."""
    out: List[Dict[str, str]] = []
    if not os.path.isdir(plugin_dir):
        return out
    for fname in sorted(os.listdir(plugin_dir)):
        if not fname.startswith(f"{PLUGIN_PREFIX}_") or not fname.endswith(".py"):
            continue
        parts = fname[: -len(".py")].split("_plugin_")
        if len(parts) != 2:
            continue
        ptype = parts[0][len(PLUGIN_PREFIX) + 1 :]
        out.append({"type": ptype, "name": parts[1], "file": fname})
    return out
