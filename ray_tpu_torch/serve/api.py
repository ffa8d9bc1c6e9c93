"""serve public API: @deployment, run, shutdown, handles.
Port of ``ray_tpu/serve/api.py``.

Reference parity: python/ray/serve/api.py (serve.deployment :306, serve.run
:686, serve.shutdown, get_deployment_handle).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.serve.batching import batch  # noqa: F401 (serve.batch)
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.multiplex import (  # noqa: F401 (serve.multiplexed)
    get_multiplexed_model_id,
    multiplexed,
)


@dataclasses.dataclass
class DeploymentConfig:
    name: str
    num_replicas: int = 1
    # None = the cluster default (config knob serve_max_concurrent,
    # historically a hard-coded 8); the controller resolves it into the
    # routing table so routers and replicas agree on one number.
    max_concurrent_queries: Optional[int] = None
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    user_config: Any = None
    # {"min_replicas", "max_replicas", "target_ongoing_requests",
    #  "downscale_delay_s"} — demand-driven replica count (reference:
    # serve autoscaling_config). None = fixed num_replicas.
    autoscaling_config: Optional[dict] = None
    # "prompt_prefix": routers derive an affinity key from the request's
    # prompt prefix and prefer replicas that recently served it — their
    # engine's prefix-KV pool is warm (reference:
    # serve/_private/request_router/prefix_aware/prefix_aware_router.py).
    request_affinity: Optional[str] = None
    # Prefix-digest routing contract for "prompt_prefix" deployments:
    # {"scheme": <token hashing scheme>, "chunk": <tokens per block>}.
    # Routers hash a prompt's leading blocks under this contract and
    # bias pow-2 toward replicas whose ADVERTISED prefix pool already
    # holds them (see util/prefix_digest.py). None = router-local
    # affinity only.
    request_affinity_config: Optional[dict] = None
    # Overload protection (serve/admission.py). None = this deployment
    # opts out entirely (no admission keys in its routing table, no
    # bounded replica queue). A dict opts in; unset fields inherit the
    # serve_shed_*/serve_queue_cap_factor cluster knobs:
    #   {"tenant_rate": req/s refill (0 = unlimited), "tenant_burst": n,
    #    "tenants": {key: {"rate", "burst"}},       # per-tenant override
    #    "queue_high"/"queue_low": per-replica mean queue watermarks,
    #    "ttft_high_ms"/"ttft_low_ms": rolling-TTFT watermarks (0 = off),
    #    "down_hold_s": hysteresis dwell, "retry_after_s": shed hint}
    admission_config: Optional[dict] = None
    # Disaggregated LLM serving (llm/disagg.py). None = unified replicas
    # (every replica prefills AND decodes).
    # {"prefill_replicas": n} assigns the deployment's first n replicas
    # the "prefill" role and the rest "decode"; the controller advertises
    # per-replica roles in the routing table and routers run the two-hop
    # prefill->handoff->decode placement. RAY_TPU_DISAGG=0 strips the
    # roles from every table (unified routing, byte-identical).
    disagg_config: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Application:
    """A deployment bound to its init args (reference: serve 2.x
    Deployment.bind output)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, target: Callable, config: DeploymentConfig):
        self._target = target
        self._config = config

    @property
    def name(self) -> str:
        return self._config.name

    def options(self, **kw) -> "Deployment":
        cfg = dataclasses.replace(self._config, **kw)
        return Deployment(self._target, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(_target=None, **kw):
    """@serve.deployment decorator (optionally with options)."""

    def wrap(target):
        cfg = DeploymentConfig(name=kw.pop("name", target.__name__), **kw)
        return Deployment(target, cfg)

    if _target is not None:
        return wrap(_target)
    return wrap


def ingress(app_or_factory, *, name: str = "asgi", **kw) -> Application:
    """Mount an ASGI 3.0 app (FastAPI/Starlette/bare callable) as a
    deployment (reference: serve.ingress + the ASGI replica wrapper,
    serve/_private/replica.py:1139). Pass the app object, or a zero-arg
    factory when the app doesn't pickle (the usual FastAPI case); the
    proxy then serves /{name}/* with the app's own status, headers, and
    body — streamed responses (SSE) forward chunk-by-chunk."""
    from ray_tpu_torch.serve.asgi import ASGIAppWrapper

    cfg = DeploymentConfig(name=name, **kw)
    return Deployment(ASGIAppWrapper, cfg).bind(app_or_factory)


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        cls = ray_tpu_torch.remote(ServeController)
        return cls.options(
            name=CONTROLLER_NAME, num_cpus=0, max_concurrency=64
        ).remote()


def run(
    app: Application | Deployment,
    *,
    host: str = "127.0.0.1",
    port: Optional[int] = None,
    wait_timeout_s: float = 120.0,
) -> DeploymentHandle:
    """Deploy an application and return a handle. With ``port``, also
    ensure an HTTP proxy serving /{deployment_name} on that port (0 picks a
    free port — read it back via `proxy_port`)."""
    if isinstance(app, Deployment):
        app = app.bind()
    dep = app.deployment
    controller = _get_or_create_controller()
    payload = cloudpickle.dumps(dep._target)
    init_payload = serialization.dumps((app.args, app.kwargs))[0]
    ray_tpu_torch.get(
        controller.deploy.remote(
            dep.name, payload, init_payload, dep._config.to_dict()
        ),
        timeout=60,
    )
    ok = ray_tpu_torch.get(
        controller.wait_healthy.remote(dep.name, wait_timeout_s),
        timeout=wait_timeout_s + 10,
    )
    if not ok:
        raise RuntimeError(
            f"deployment {dep.name!r} did not become healthy in "
            f"{wait_timeout_s}s"
        )
    if port is not None:
        bound = ray_tpu_torch.get(
            controller.ensure_proxy.remote(host, port), timeout=60
        )
        if port not in (0, bound):
            raise RuntimeError(
                f"proxy bound port {bound} != requested {port}"
            )
    return DeploymentHandle(dep.name)


def proxy_port() -> int:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(controller.ensure_proxy.remote("127.0.0.1", 0))


def grpc_port(host: str = "127.0.0.1", port: int = 0) -> int:
    """Ensure the gRPC ingress (reference: ray.serve gRPC proxy) and return
    its bound port; see ray_tpu_torch.serve.grpc_ingress for the wire contract."""
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(controller.ensure_grpc.remote(host, port))


def get_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def status() -> dict:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def delete(name: str) -> None:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)


def shutdown() -> None:
    from ray_tpu_torch.serve import handle as _handle_mod

    # Cached routers hold handles into the controller being torn down; a
    # later serve.run() in this process must start routing fresh. Their
    # long-poll listeners are cancelled so no task keeps polling a corpse.
    for router in _handle_mod._routers.values():
        try:
            router.close()
        except Exception:  # raylint: disable=RL006 -- router close during serve shutdown; endpoint already stopping
            pass
    _handle_mod._routers.clear()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        ray_tpu_torch.get(controller.shutdown_serve.remote(), timeout=60)
    finally:
        ray_tpu_torch.kill(controller)
