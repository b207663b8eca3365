"""The port's persistence inventory (DF014's half of the reference's
``records/state_contracts.py``), declared once and checked twice.

- **statically**, ``tools/dflint/staterules.py`` reads ``STATE_CONTRACTS``
  with ``ast.literal_eval`` when it is pointed at this file (its
  ``STATE_CONTRACTS_RELPATH`` names the reference's): every KVTable write
  site of the port is indexed by (namespace, callsite, method), and the
  declared multi-row sites must stay ONE ``put_many``;
- **dynamically**, the port's crash witness (``utils/dfcrash.py``)
  records every KVTable write issued from port code, and
  ``tests/test_torch_witnesses.py`` holds the observations to the static
  index built from this file.

Entry for entry with the reference's ``persistence`` section, keyed by
the port's relpaths, for the namespaces the port writes.  The reference's
``users``/``pats`` (``manager/users.py``) and ``replication_log``/
``replication_meta`` (``manager/replication.py``) have no port module yet
(ROADMAP item 14), so they have no entry, and neither has the replicated
table's wildcard writers.  The FSM (DF013) and RPC (DF015) sections are
not ported: no port rule reads them.

Keep this a PURE LITERAL: one dict, no names, calls or comprehensions.
"""

from __future__ import annotations

STATE_CONTRACTS = {
    "machines": {},
    "persistence": {
        "namespaces": {
            "models": {
                "owner": "dragonfly2_tpu_torch/manager/registry.py",
                "lock": ["dragonfly2_tpu_torch/manager/registry.py",
                         "ModelRegistry", "_mu"],
                "loader": "ModelRegistry.__init__",
                # The single-ACTIVE flip touches two rows; a crash
                # between separate commits would leave two ACTIVEs.
                "multi_row": ["ModelRegistry._persist"],
                "unlocked_ok": ["migrate_legacy_sqlite"],
                "invariant": "single_active",
            },
            "rollouts": {
                "owner": "dragonfly2_tpu_torch/rollout/controller.py",
                "lock": ["dragonfly2_tpu_torch/rollout/controller.py",
                         "RolloutController", "_mu"],
                "loader": "RolloutController.__init__",
                "multi_row": [],
                "unlocked_ok": [],
                "invariant": "no_dangling_rollout",
            },
            "jobs": {
                "owner": "dragonfly2_tpu_torch/jobs/queue.py",
                "lock": ["dragonfly2_tpu_torch/jobs/queue.py", "JobQueue", "_mu"],
                "loader": "JobQueue._reload",
                "multi_row": [],
                "unlocked_ok": [],
                "invariant": "jobs_absent_or_complete",
            },
            "job_groups": {
                "owner": "dragonfly2_tpu_torch/jobs/queue.py",
                "lock": ["dragonfly2_tpu_torch/jobs/queue.py", "JobQueue", "_mu"],
                "loader": "JobQueue._reload",
                "multi_row": [],
                "unlocked_ok": [],
                "invariant": "jobs_absent_or_complete",
            },
            "crud": {
                "owner": "dragonfly2_tpu_torch/manager/crud.py",
                "lock": ["dragonfly2_tpu_torch/manager/crud.py", "CrudStore", "_mu"],
                "loader": "CrudStore.__init__",
                "multi_row": [],
                "unlocked_ok": ["migrate_legacy_sqlite"],
                "invariant": "rows_load",
            },
            "topology": {
                "owner": "dragonfly2_tpu_torch/manager/rest.py",
                "lock": ["dragonfly2_tpu_torch/manager/rest.py",
                         "ManagerRESTServer", "_topology_mu"],
                "loader": "ManagerRESTServer.__init__",
                "multi_row": [],
                "unlocked_ok": [],
                "invariant": "rows_load",
            },
            # One row per blob; put() is reached only from
            # ModelRegistry.create_model under ModelRegistry._mu.
            "blobs": {
                "owner": "dragonfly2_tpu_torch/manager/registry.py",
                "lock": ["dragonfly2_tpu_torch/manager/registry.py",
                         "ModelRegistry", "_mu"],
                "loader": "KVBlobStore.__init__",
                "multi_row": [],
                "unlocked_ok": ["KVBlobStore.put"],
                "invariant": "rows_load",
            },
            "shard_membership": {
                "owner": "dragonfly2_tpu_torch/scheduler/sharding.py",
                "lock": ["dragonfly2_tpu_torch/scheduler/sharding.py",
                         "ShardDirectory", "_mu"],
                "loader": "ShardDirectory.__init__",
                "multi_row": [],
                "unlocked_ok": [],
                "invariant": "rows_load",
            },
            "lifecycle": {
                "owner": "dragonfly2_tpu_torch/lifecycle/state.py",
                "lock": ["dragonfly2_tpu_torch/lifecycle/state.py",
                         "LifecycleStore", "_mu"],
                "loader": "LifecycleStore.__init__",
                "multi_row": [],
                "unlocked_ok": [],
                "invariant": "rows_load",
            },
        },
        "replicators": {
            "dragonfly2_tpu_torch/manager/state.py": [
                "StateBackend.put_namespaces",
            ],
        },
        # The job row commits before the group row that names its id.
        "write_order": [["jobs", "job_groups"]],
        "foreign_keys": [
            {
                "parent": "models",
                "child": "rollouts",
                "primitive": "ModelRegistry.delete",
                "cleanup": "RolloutController.delete_model",
                "cleanup_file": "dragonfly2_tpu_torch/rollout/controller.py",
            },
        ],
        "implementation": ["dragonfly2_tpu_torch/manager/state.py"],
    },
    "rpc": {},
}
