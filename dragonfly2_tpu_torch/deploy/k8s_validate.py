"""Offline structural validation for the port's Kubernetes manifests.

kubeconform validates manifests against the upstream-generated OpenAPI
schemas; with no network, the schema subset for every kind/field the
manifests use is VENDORED here as strict structural checks — unknown
keys at checked levels, wrong types, bad enum values, out-of-range
ports, selector/label mismatches and dangling volume references all
fail.  Deliberately weaker than a live API server: admission,
defaulting, RBAC and scheduling only exist on a real cluster — see
``README.md`` beside this file for what still needs one.

Also exposes the NORMALIZED deployment topology of both the k8s
manifests and ``docker-compose.yaml`` so tests diff them
programmatically (same entry modules, same config files, same ports)
instead of by substring.

Port of ``deploy/k8s_validate.py``, verbatim but for two things:
``compose_topology`` keys on the port's ``dragonfly2_tpu_torch.``
modules, and with no argument ``main`` reads ``k8s/dragonfly.yaml``
beside this file.  ``validate_documents`` gives the reference's errors
on any manifest.

Usage:
  python -m dragonfly2_tpu_torch.deploy.k8s_validate [MANIFEST ...]   # exit 1 on errors
"""

from __future__ import annotations

import os
import re
import sys
from typing import Any, Dict, List

import yaml

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_QUANTITY = re.compile(r"^[0-9]+(\.[0-9]+)?(m|k|Ki|M|Mi|G|Gi|T|Ti|P|Pi|E|Ei)?$")

# kind → the apiVersion the cluster serves it under (a wrong pair is the
# single most common manifest rot: removed beta groups).
KIND_API = {
    "Service": "v1",
    "ConfigMap": "v1",
    "Deployment": "apps/v1",
    "StatefulSet": "apps/v1",
    "DaemonSet": "apps/v1",
}

WORKLOAD_KINDS = ("Deployment", "StatefulSet", "DaemonSet")

# The port's manifest, beside this module.
MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k8s", "dragonfly.yaml")


class _Ctx:
    def __init__(self) -> None:
        self.errors: List[str] = []

    def err(self, path: str, msg: str) -> None:
        self.errors.append(f"{path}: {msg}")


def _check_keys(ctx: _Ctx, path: str, obj: Any, allowed: set, required: set):
    if not isinstance(obj, dict):
        ctx.err(path, f"expected mapping, got {type(obj).__name__}")
        return False
    for k in obj:
        if k not in allowed:
            ctx.err(path, f"unknown field {k!r} (allowed: {sorted(allowed)})")
    for k in required:
        if k not in obj:
            ctx.err(path, f"missing required field {k!r}")
    return True


def _check_labels(ctx: _Ctx, path: str, labels: Any) -> None:
    if not isinstance(labels, dict) or not all(
        isinstance(k, str) and isinstance(v, str) for k, v in labels.items()
    ):
        ctx.err(path, "labels must be a string→string map")


def _check_port_number(ctx: _Ctx, path: str, v: Any) -> None:
    if not isinstance(v, int) or isinstance(v, bool) or not 1 <= v <= 65535:
        ctx.err(path, f"port must be an int in [1, 65535], got {v!r}")


def _check_metadata(ctx: _Ctx, path: str, meta: Any) -> None:
    if not _check_keys(
        ctx, path, meta, {"name", "labels", "namespace", "annotations"},
        {"name"},
    ):
        return
    name = meta.get("name")
    if not isinstance(name, str) or not _DNS1123.match(name or ""):
        ctx.err(path + ".name", f"{name!r} is not a DNS-1123 label")
    if "labels" in meta:
        _check_labels(ctx, path + ".labels", meta["labels"])


def _check_probe(ctx: _Ctx, path: str, probe: Any) -> None:
    ok = _check_keys(
        ctx, path, probe,
        {"httpGet", "tcpSocket", "exec", "periodSeconds",
         "initialDelaySeconds", "timeoutSeconds", "failureThreshold"},
        set(),
    )
    if not ok:
        return
    if "httpGet" in probe and _check_keys(
        ctx, path + ".httpGet", probe["httpGet"], {"path", "port", "scheme"},
        {"path", "port"},
    ):
        port = probe["httpGet"]["port"]
        if isinstance(port, int):
            _check_port_number(ctx, path + ".httpGet.port", port)


def _check_container(ctx: _Ctx, path: str, c: Any, volumes: set) -> None:
    if not _check_keys(
        ctx, path, c,
        {"name", "image", "command", "args", "ports", "env", "volumeMounts",
         "readinessProbe", "livenessProbe", "resources", "workingDir"},
        {"name", "image"},
    ):
        return
    if "command" in c and not (
        isinstance(c["command"], list)
        and all(isinstance(x, str) for x in c["command"])
    ):
        ctx.err(path + ".command", "must be a list of strings")
    for i, p in enumerate(c.get("ports", [])):
        pp = f"{path}.ports[{i}]"
        if _check_keys(ctx, pp, p, {"containerPort", "name", "protocol",
                                    "hostPort"}, {"containerPort"}):
            _check_port_number(ctx, pp + ".containerPort", p["containerPort"])
    for i, m in enumerate(c.get("volumeMounts", [])):
        mp = f"{path}.volumeMounts[{i}]"
        if _check_keys(ctx, mp, m, {"name", "mountPath", "readOnly",
                                    "subPath"}, {"name", "mountPath"}):
            if m["name"] not in volumes:
                ctx.err(mp, f"mounts volume {m['name']!r} that the pod "
                            f"spec does not define")
    for probe in ("readinessProbe", "livenessProbe"):
        if probe in c:
            _check_probe(ctx, f"{path}.{probe}", c[probe])


def _check_pod_spec(ctx: _Ctx, path: str, spec: Any,
                    *, extra_volumes: set = frozenset()) -> None:
    if not _check_keys(
        ctx, path, spec,
        {"containers", "initContainers", "volumes", "hostNetwork",
         "nodeSelector", "tolerations", "serviceAccountName",
         "terminationGracePeriodSeconds"},
        {"containers"},
    ):
        return
    volumes = set(extra_volumes)
    for i, v in enumerate(spec.get("volumes", [])):
        vp = f"{path}.volumes[{i}]"
        if _check_keys(ctx, vp, v, {"name", "configMap", "emptyDir",
                                    "hostPath", "secret",
                                    "persistentVolumeClaim"}, {"name"}):
            volumes.add(v["name"])
            if "configMap" in v:
                _check_keys(ctx, vp + ".configMap", v["configMap"],
                            {"name", "items", "optional"}, {"name"})
    if not spec.get("containers"):
        ctx.err(path + ".containers", "must be a non-empty list")
        return
    for i, c in enumerate(spec["containers"]):
        _check_container(ctx, f"{path}.containers[{i}]", c, volumes)


def _check_workload(ctx: _Ctx, path: str, doc: Dict[str, Any]) -> None:
    kind = doc["kind"]
    # Per-kind field sets: Deployments roll with `strategy`, the other
    # two with `updateStrategy`; serviceName/volumeClaimTemplates are
    # StatefulSet-only — a real apiserver rejects the cross-kind mixups.
    allowed = {"selector", "template", "minReadySeconds",
               "revisionHistoryLimit"}
    if kind != "DaemonSet":
        allowed.add("replicas")  # a real apiserver rejects it on DaemonSet
    if kind == "Deployment":
        allowed |= {"strategy", "paused", "progressDeadlineSeconds"}
    else:
        allowed.add("updateStrategy")
    if kind == "StatefulSet":
        allowed |= {"serviceName", "volumeClaimTemplates",
                    "podManagementPolicy"}
    required = {"selector", "template"}
    if kind == "StatefulSet":
        required.add("serviceName")
    spec = doc.get("spec")
    if not _check_keys(ctx, path + ".spec", spec, allowed, required):
        return
    if kind == "DaemonSet" and "replicas" in spec:
        ctx.err(path + ".spec.replicas", "DaemonSet has no replicas field")
    if kind != "DaemonSet" and "replicas" in spec:
        r = spec["replicas"]
        if not isinstance(r, int) or isinstance(r, bool) or r < 0:
            ctx.err(path + ".spec.replicas", f"must be a non-negative int, got {r!r}")
    sel = spec.get("selector")
    match = None
    if _check_keys(ctx, path + ".spec.selector", sel,
                   {"matchLabels", "matchExpressions"}, {"matchLabels"}):
        match = sel.get("matchLabels")
        _check_labels(ctx, path + ".spec.selector.matchLabels", match)
    tmpl = spec.get("template")
    if not isinstance(tmpl, dict):
        ctx.err(path + ".spec.template", "missing/invalid pod template")
        return
    meta = tmpl.get("metadata", {})
    labels = meta.get("labels", {}) if isinstance(meta, dict) else {}
    _check_labels(ctx, path + ".spec.template.metadata.labels", labels)
    if isinstance(match, dict) and isinstance(labels, dict):
        for k, v in match.items():
            if labels.get(k) != v:
                ctx.err(
                    path + ".spec.selector",
                    f"matchLabels {k}={v!r} not present on the pod "
                    f"template labels {labels!r} — the workload would "
                    f"select none of its own pods",
                )
    pvc_names = set()
    for i, vct in enumerate(spec.get("volumeClaimTemplates", [])):
        vp = f"{path}.spec.volumeClaimTemplates[{i}]"
        if not _check_keys(ctx, vp, vct, {"metadata", "spec"},
                           {"metadata", "spec"}):
            continue
        if not isinstance(vct["metadata"], dict):
            ctx.err(vp + ".metadata", "expected mapping")
            continue
        pvc_names.add(vct["metadata"].get("name"))
        vspec = vct["spec"]
        if _check_keys(ctx, vp + ".spec", vspec,
                       {"accessModes", "resources", "storageClassName"},
                       {"accessModes", "resources"}):
            modes = vspec["accessModes"]
            if not isinstance(modes, list):
                ctx.err(vp + ".spec.accessModes", "expected list")
                modes = []
            for m in modes:
                if m not in ("ReadWriteOnce", "ReadOnlyMany",
                             "ReadWriteMany", "ReadWriteOncePod"):
                    ctx.err(vp + ".spec.accessModes", f"bad mode {m!r}")
            res = vspec["resources"]
            storage = (
                res.get("requests", {}).get("storage")
                if isinstance(res, dict) and isinstance(
                    res.get("requests", {}), dict
                )
                else None
            )
            if not isinstance(storage, str) or not _QUANTITY.match(storage):
                ctx.err(vp + ".spec.resources.requests.storage",
                        f"bad quantity {storage!r}")
    _check_pod_spec(ctx, path + ".spec.template.spec", tmpl.get("spec"),
                    extra_volumes=pvc_names)


def _check_service(ctx: _Ctx, path: str, doc: Dict[str, Any]) -> None:
    spec = doc.get("spec")
    if not _check_keys(
        ctx, path + ".spec", spec,
        {"selector", "ports", "clusterIP", "type", "sessionAffinity"},
        {"ports"},
    ):
        return
    if "selector" in spec and not isinstance(spec["selector"], dict):
        ctx.err(path + ".spec.selector", "must be a string→string map")
    cip = spec.get("clusterIP")
    if cip is not None and cip != "None" and not re.match(
        r"^\d+\.\d+\.\d+\.\d+$", str(cip)
    ):
        ctx.err(path + ".spec.clusterIP",
                f"must be 'None' or an IP, got {cip!r}")
    for i, p in enumerate(spec.get("ports", [])):
        pp = f"{path}.spec.ports[{i}]"
        if _check_keys(ctx, pp, p, {"name", "port", "targetPort",
                                    "protocol", "nodePort"}, {"port"}):
            _check_port_number(ctx, pp + ".port", p["port"])
            tp = p.get("targetPort")
            if isinstance(tp, int):
                _check_port_number(ctx, pp + ".targetPort", tp)


def validate_documents(docs: List[Dict[str, Any]]) -> List[str]:
    """Structural validation of a manifest list; returns error strings."""
    ctx = _Ctx()
    seen = set()
    for idx, doc in enumerate(docs):
        if not isinstance(doc, dict):
            ctx.err(f"doc[{idx}]", "not a mapping")
            continue
        kind = doc.get("kind")
        name = (doc.get("metadata") or {}).get("name", "?")
        path = f"{kind}/{name}"
        top = {"apiVersion", "kind", "metadata"}
        top |= {"data", "binaryData", "immutable"} if kind == "ConfigMap" \
            else {"spec"}
        if not _check_keys(ctx, path, doc, top,
                           {"apiVersion", "kind", "metadata"}):
            continue
        if kind not in KIND_API:
            ctx.err(path, f"unsupported kind {kind!r} (vendored schema set: "
                          f"{sorted(KIND_API)})")
            continue
        if doc["apiVersion"] != KIND_API[kind]:
            ctx.err(path + ".apiVersion",
                    f"{doc['apiVersion']!r} — {kind} is served under "
                    f"{KIND_API[kind]!r}")
        _check_metadata(ctx, path + ".metadata", doc.get("metadata"))
        key = (kind, name)
        if key in seen:
            ctx.err(path, "duplicate kind/name")
        seen.add(key)
        if kind in WORKLOAD_KINDS:
            _check_workload(ctx, path, doc)
        elif kind == "Service":
            _check_service(ctx, path, doc)
        elif kind == "ConfigMap":
            data = doc.get("data") or {}  # bare `data:` parses to None
            if not isinstance(data, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in data.items()
            ):
                ctx.err(path + ".data",
                        "must be a string→string map (a mis-indented "
                        "value becomes a nested mapping)")

    # Cross-document: every Service selector must select at least one
    # workload pod template (a dangling selector routes nothing).
    pods = []
    for doc in docs:
        if isinstance(doc, dict) and doc.get("kind") in WORKLOAD_KINDS:
            try:
                pods.append(
                    doc["spec"]["template"]["metadata"]["labels"]
                )
            except (KeyError, TypeError):
                pass
    for doc in docs:
        if not (isinstance(doc, dict) and doc.get("kind") == "Service"):
            continue
        spec = doc.get("spec")
        sel = spec.get("selector") if isinstance(spec, dict) else None
        if not sel:
            continue
        if not isinstance(sel, dict):
            ctx.err(
                f"Service/{doc.get('metadata', {}).get('name', '?')}"
                f".spec.selector",
                f"must be a string→string map, got {type(sel).__name__}",
            )
            continue
        if not any(
            isinstance(labels, dict)
            and all(labels.get(k) == v for k, v in sel.items())
            for labels in pods
        ):
            ctx.err(
                f"Service/{doc['metadata']['name']}.spec.selector",
                f"{sel!r} selects no workload pod template in this manifest",
            )
    return ctx.errors


# ---------------------------------------------------------------------------
# Normalized topology (for the programmatic compose diff)
# ---------------------------------------------------------------------------


def k8s_topology(docs: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """workload name → {module, config, ports, replicas} from manifests."""
    out: Dict[str, Dict[str, Any]] = {}
    for doc in docs:
        if not (isinstance(doc, dict) and doc.get("kind") in WORKLOAD_KINDS):
            continue
        c = doc["spec"]["template"]["spec"]["containers"][0]
        cmd = c.get("command", [])
        module = cmd[2] if cmd[:2] == ["python", "-m"] and len(cmd) > 2 else None
        config = None
        if "--config" in cmd:
            config = cmd[cmd.index("--config") + 1].rsplit("/", 1)[-1]
        out[doc["metadata"]["name"]] = {
            "kind": doc["kind"],
            "module": module,
            "config": config,
            "ports": sorted(p["containerPort"] for p in c.get("ports", [])),
            "replicas": doc["spec"].get("replicas", 1),
            "image": c.get("image"),
        }
    return out


def compose_topology(compose: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """service name → {module, config, ports} from docker-compose.yaml.
    Compose commands are the `python -m` image entrypoint's argv."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, svc in compose.get("services", {}).items():
        cmd = svc.get("command", [])
        module = (cmd[0] if cmd and str(cmd[0]).startswith("dragonfly2_tpu_torch.")
                  else None)
        config = None
        if "--config" in cmd:
            config = str(cmd[cmd.index("--config") + 1]).rsplit("/", 1)[-1]
        ports = []
        for p in svc.get("expose", []) or []:
            ports.append(int(p))
        for p in svc.get("ports", []) or []:
            ports.append(int(str(p).split(":")[-1]))
        out[name] = {
            "module": module,
            "config": config,
            "ports": sorted(set(ports)),
        }
    return out


def main(argv: List[str]) -> int:
    errors: List[str] = []
    for path in argv or [MANIFEST]:
        with open(path) as f:
            docs = [d for d in yaml.safe_load_all(f) if d is not None]
        errs = validate_documents(docs)
        for e in errs:
            print(f"{path}: {e}")
        errors.extend(errs)
    if not errors:
        print("k8s manifests: structurally valid")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
