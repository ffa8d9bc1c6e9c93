"""DeploymentHandle — call a deployment from a driver or another replica.
Port of ``ray_tpu/serve/handle.py``.

Reference parity: python/ray/serve/handle.py (DeploymentHandle /
DeploymentResponse). Each handle owns a router; handles pickle by
deployment name and rebind lazily in the destination process (that is how
model composition passes handles between replicas).
"""

from __future__ import annotations

from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.serve.router import Router

# Process-wide router cache: deployment name -> Router (see _ensure_router).
_routers: dict = {}


class DeploymentHandle:
    def __init__(
        self,
        deployment: str,
        method: str = "__call__",
        stream: bool = False,
        multiplexed_model_id: str = "",
        tenant: str = "",
        priority: str = "",
    ):
        self._deployment = deployment
        self._method = method
        self._stream = stream
        self._model_id = multiplexed_model_id
        # Admission identity (overload plane): explicit options win over
        # the request envelope's headers; empty = derive from headers.
        self._tenant = tenant
        self._priority = priority
        self._router: Router | None = None

    def __reduce__(self):
        return (
            DeploymentHandle,
            (
                self._deployment,
                self._method,
                self._stream,
                self._model_id,
                self._tenant,
                self._priority,
            ),
        )

    async def _ensure_router(self) -> Router:
        if self._router is None:
            # One router per deployment per process, shared across ALL
            # handles (and their .options() clones): routing state — load
            # estimates, dead-replica memory, model-affinity — must
            # accumulate across calls, not reset per handle.
            router = _routers.get(self._deployment)
            if router is None:
                from ray_tpu_torch.serve.controller import CONTROLLER_NAME

                controller = await core_api.get_actor_async(CONTROLLER_NAME)
                router = _routers.setdefault(
                    self._deployment, Router(controller, self._deployment)
                )
            self._router = router
        return self._router

    def method(self, name: str) -> "DeploymentHandle":
        h = DeploymentHandle(
            self._deployment,
            name,
            self._stream,
            self._model_id,
            self._tenant,
            self._priority,
        )
        h._router = self._router  # share routing state
        return h

    def options(
        self,
        *,
        stream: bool | None = None,
        multiplexed_model_id: str | None = None,
        tenant: str | None = None,
        priority: str | None = None,
    ) -> "DeploymentHandle":
        """``stream=True``: remote() / remote_async() return an iterator of
        response chunks instead of one value. ``multiplexed_model_id``:
        route to a replica with that model resident and bind
        serve.get_multiplexed_model_id() there (reference: serve/handle.py
        DeploymentHandle.options). ``tenant``/``priority``: explicit
        admission identity for the overload plane (overrides the request
        envelope's headers; priority in admission.PRIORITIES)."""
        h = DeploymentHandle(
            self._deployment,
            self._method,
            self._stream if stream is None else stream,
            self._model_id
            if multiplexed_model_id is None
            else multiplexed_model_id,
            self._tenant if tenant is None else tenant,
            self._priority if priority is None else priority,
        )
        h._router = self._router
        return h

    async def remote_async(self, *args, **kwargs):
        """Await the result (for async contexts: replicas, proxies). With
        stream=True this returns an async generator of chunks."""
        router = await self._ensure_router()
        if self._stream:
            return router.route_stream(
                self._method,
                args,
                kwargs,
                self._model_id,
                tenant=self._tenant,
                priority=self._priority,
            )
        return await router.route(
            self._method,
            args,
            kwargs,
            self._model_id,
            tenant=self._tenant,
            priority=self._priority,
        )

    def remote(self, *args, **kwargs):
        """Route from a sync context (driver). Plain: a Future whose
        .result() is the response value. stream=True: a blocking iterator
        of response chunks."""
        worker = core_api._require_worker()
        if self._stream:
            return _SyncChunkIterator(worker, self, args, kwargs)
        return worker.endpoint.submit(self.remote_async(*args, **kwargs))


class _SyncChunkIterator:
    """Drives an async chunk generator from a non-loop thread."""

    def __init__(self, worker, handle: DeploymentHandle, args, kwargs):
        self._worker = worker
        self._agen = None
        self._handle = handle
        self._call = (args, kwargs)

    def __iter__(self):
        return self

    def __next__(self):
        if self._agen is None:
            args, kwargs = self._call
            self._agen = self._worker.endpoint.submit(
                self._handle.remote_async(*args, **kwargs)
            ).result(timeout=60)
        try:
            return self._worker.endpoint.submit(
                self._agen.__anext__()
            ).result()
        except StopAsyncIteration:
            raise StopIteration
