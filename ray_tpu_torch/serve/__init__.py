"""ray_tpu_torch.serve — model serving tier. Port of ``ray_tpu/serve``.

Reference parity: python/ray/serve (controller `_private/controller.py:106`,
proxy `_private/proxy.py:710`, router `_private/router.py:473` with
power-of-two-choices `request_router/pow_2_router.py:27`, replica
`_private/replica.py:1139`). Replicas are actors of the port's runtime and
hold cards through its ``GPU`` resource (``ray_actor_options={"num_gpus":
...}``); the data plane is the runtime's own RPC fabric (no uvicorn/grpc
dependency — the HTTP ingress is a stdlib asyncio server inside a proxy
actor). The YAML config (:mod:`.schema`) imports ``yaml`` and the gRPC
ingress (:mod:`.grpc_ingress`) imports ``grpc`` only when called.
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_handle,
    ingress,
    run,
    shutdown,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.schema import (
    deploy_from_config,
    deploy_from_file,
    load_serve_config,
)

__all__ = [
    "Application",
    "Deployment",
    "DeploymentHandle",
    "batch",
    "delete",
    "deploy_from_config",
    "deploy_from_file",
    "deployment",
    "get_handle",
    "ingress",
    "load_serve_config",
    "get_multiplexed_model_id",
    "multiplexed",
    "run",
    "shutdown",
    "status",
]
