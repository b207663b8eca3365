"""The scheduler's config file in both packages: the same YAML and the same
environment give the same outcome.

Each file is read by ``load_config(SchedulerConfigFile, path, env=False)``
in both packages: both load it with equal fields, or both refuse it with
``ConfigError``.  ``DRAGONFLY_SCHEDULER_LOG_LEVEL`` with no file is read
by ``load_config(SchedulerConfigFile)`` in both.  The field walk holds
every key and default of the two dataclasses equal, so a key one package
lacks shows here before a file that sets it reaches a binary.
"""

from __future__ import annotations

import dataclasses

import pytest

from dragonfly2_tpu.config import schema as j_schema
from dragonfly2_tpu_torch.config import schema as p_schema

FILES = {
    "log_level": "log: {level: info}\n",
    "back_to_source_count": "scheduling: {back_to_source_count: 3}\n",
    "log_all_keys": "log: {level: debug, dir: /var/log/dragonfly, console: true, "
                    "max_bytes: 1024, backups: 2}\n",
    "log_level_unknown": "log: {level: verbose}\n",
    "log_key_unknown": "log: {colour: red}\n",
    "scheduling_key_unknown": "scheduling: {back_to_source_counts: 3}\n",
}


def _fields(obj, prefix=""):
    """Every leaf field of a config dataclass as {dotted name: value}."""
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_fields(value, prefix + f.name + "."))
        else:
            out[prefix + f.name] = value
    return out


def _outcome(schema, **kwargs):
    try:
        return "loaded", _fields(schema.load_config(schema.SchedulerConfigFile, **kwargs))
    except schema.ConfigError:
        return "refused", None


@pytest.mark.parametrize("name", list(FILES))
def test_a_scheduler_file_loads_alike_in_both_packages(tmp_path, name):
    path = tmp_path / "scheduler.yaml"
    path.write_text(FILES[name])
    want = _outcome(j_schema, path=str(path), env=False)
    got = _outcome(p_schema, path=str(path), env=False)
    assert got == want
    if name in ("log_level", "back_to_source_count", "log_all_keys"):
        assert got[0] == "loaded"


@pytest.mark.parametrize("level,outcome", [("verbose", "refused"), ("debug", "loaded"),
                                           ("error", "loaded")])
def test_the_log_level_variable_is_read_alike(monkeypatch, level, outcome):
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_LOG_LEVEL", level)
    want = _outcome(j_schema)
    got = _outcome(p_schema)
    assert got == want and got[0] == outcome
    if outcome == "loaded":
        assert got[1]["log.level"] == level


def test_the_scheduler_files_have_the_same_keys_and_defaults():
    want = _fields(j_schema.SchedulerConfigFile())
    got = _fields(p_schema.SchedulerConfigFile())
    assert sorted(got) == sorted(want)
    assert got == want
