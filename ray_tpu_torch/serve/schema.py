"""Declarative Serve config: deploy applications from a YAML/dict spec.
Port of ``ray_tpu/serve/schema.py``.

Reference parity: python/ray/serve/schema.py (ServeDeploySchema /
ServeApplicationSchema) + build_app.py + `serve deploy`. Compressed to the
fields this runtime drives:

    http:
      host: 127.0.0.1
      port: 8000          # optional; omit for no HTTP ingress
    grpc:
      port: 9000          # optional
    applications:
      - name: my_llm                # deployment name override
        import_path: my_pkg.mod:app  # Deployment | Application | builder fn
        args: {model: gpt2}          # kwargs for a builder fn import_path
        num_replicas: 2
        max_concurrent_queries: 16
        user_config: {temperature: 0.7}
        autoscaling_config: {min_replicas: 1, max_replicas: 4}
        request_affinity: prompt_prefix
        admission_config: {tenant_rate: 50, queue_high: 12}
        ray_actor_options: {num_cpus: 1}

``import_path`` resolves "module.sub:attr"; the attr may be a Deployment
(bound with no args), an Application (already bound), or a callable
returning either (called with ``args``).
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Optional

_APP_KEYS = {
    "name",
    "import_path",
    "args",
    "num_replicas",
    "max_concurrent_queries",
    "user_config",
    "autoscaling_config",
    "request_affinity",
    "admission_config",
    "disagg_config",
    "ray_actor_options",
}
_TOP_KEYS = {"applications", "http", "grpc"}


def load_serve_config(path: str) -> dict:
    import yaml

    with open(os.path.expanduser(path)) as f:
        raw = yaml.safe_load(f)
    return validate_serve_config(raw)


def validate_serve_config(raw: Any) -> dict:
    if not isinstance(raw, dict):
        raise ValueError("serve config must be a mapping")
    unknown = set(raw) - _TOP_KEYS
    if unknown:
        raise ValueError(
            f"serve config: unknown top-level keys {sorted(unknown)}"
        )
    for section in ("http", "grpc"):
        sub = raw.get(section)
        if sub is None:
            continue
        if not isinstance(sub, dict):
            raise ValueError(f"serve config: {section} must be a mapping")
        bad = set(sub) - {"host", "port"}
        if bad:
            raise ValueError(
                f"serve config: unknown {section} keys {sorted(bad)} "
                f"(known: host, port)"
            )
    apps = raw.get("applications")
    if not isinstance(apps, list) or not apps:
        raise ValueError("serve config: 'applications' list is required")
    for i, app in enumerate(apps):
        if not isinstance(app, dict):
            raise ValueError(f"applications[{i}] must be a mapping")
        unknown = set(app) - _APP_KEYS
        if unknown:
            raise ValueError(
                f"applications[{i}]: unknown keys {sorted(unknown)}"
            )
        if "import_path" not in app:
            raise ValueError(f"applications[{i}]: import_path is required")
        if ":" not in app["import_path"]:
            raise ValueError(
                f"applications[{i}]: import_path must be 'module:attr', "
                f"got {app['import_path']!r}"
            )
    return raw


def _resolve_import(import_path: str):
    module_name, _, attr = import_path.partition(":")
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _to_application(entry: dict):
    from ray_tpu_torch.serve.api import Application, Deployment

    obj = _resolve_import(entry["import_path"])
    args = entry.get("args") or {}
    if isinstance(obj, (Application, Deployment)):
        if args:
            raise ValueError(
                f"{entry['import_path']}: args only apply to builder "
                f"functions, not bound deployments"
            )
    elif callable(obj):
        obj = obj(**args)
    if isinstance(obj, Deployment):
        obj = obj.bind()
    if not isinstance(obj, Application):
        raise TypeError(
            f"{entry['import_path']} resolved to {type(obj).__name__}; "
            f"expected Deployment, Application, or a builder returning one"
        )
    # Apply the per-entry overrides on top of the code-level options.
    overrides = {
        k: entry[k]
        for k in (
            "num_replicas",
            "max_concurrent_queries",
            "user_config",
            "autoscaling_config",
            "request_affinity",
            "admission_config",
            "disagg_config",
            "ray_actor_options",
        )
        if k in entry
    }
    if entry.get("name"):
        overrides["name"] = entry["name"]
    if overrides:
        dep = obj.deployment.options(**overrides)
        from ray_tpu_torch.serve.api import Application as _App

        obj = _App(dep, obj.args, obj.kwargs)
    return obj


def deploy_from_config(
    config: dict, *, wait_timeout_s: float = 120.0
) -> list:
    """Deploy every application in a validated config dict; returns the
    DeploymentHandles in order. The cluster connection (ray_tpu_torch.init)
    must already exist."""
    from ray_tpu_torch.serve import api as serve_api

    config = validate_serve_config(config)
    http = config.get("http") or {}
    grpc = config.get("grpc") or {}
    handles = []
    for i, entry in enumerate(config["applications"]):
        app = _to_application(entry)
        kwargs: dict = {"wait_timeout_s": wait_timeout_s}
        if i == 0 and "port" in http:
            kwargs["host"] = http.get("host", "127.0.0.1")
            kwargs["port"] = int(http["port"])
        handles.append(serve_api.run(app, **kwargs))
    if "port" in grpc:
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(
            controller.ensure_grpc.remote(
                grpc.get("host", "127.0.0.1"), int(grpc["port"])
            ),
            timeout=60,
        )
    return handles


def deploy_from_file(path: str, **kw) -> list:
    return deploy_from_config(load_serve_config(path), **kw)


def serve_status() -> dict:
    """Controller's status table; {} when serve isn't running (CLI
    `raytpu serve status`)."""
    from ray_tpu_torch.serve import api as serve_api

    try:
        return serve_api.status()
    except ValueError:  # no controller: serve was never started
        return {}
