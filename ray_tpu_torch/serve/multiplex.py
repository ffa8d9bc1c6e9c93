"""@serve.multiplexed — many models behind one deployment's replicas.

Reference parity: python/ray/serve/multiplex.py (@serve.multiplexed +
get_multiplexed_model_id). A replica holds an LRU cache of loaded models
(device memory is the scarce resource: max_num_models_per_replica bounds it); the
request's model id rides the routing metadata, and the router prefers
replicas it has recently sent that model to, so repeat traffic for a model
lands where its weights are already resident instead of thrashing device memory
with reloads. Port of ``ray_tpu/serve/multiplex.py``.

    @serve.deployment
    class MultiModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return load_weights(model_id)        # expensive: upload to the card

        async def __call__(self, request):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model(request)

Callers: handle.options(multiplexed_model_id="m1").remote(...) or the HTTP
header `serve_multiplexed_model_id: m1` through the proxy.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
from collections import OrderedDict
from typing import Any, Callable

_model_id_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """The model id of the CURRENT request (empty if the caller set none).
    Reference: python/ray/serve/api.py get_multiplexed_model_id."""
    return _model_id_ctx.get()


def _set_model_id(model_id: str):
    return _model_id_ctx.set(model_id or "")


class _ModelCache:
    """Per-instance LRU of loaded models with single-flight loading (two
    concurrent requests for the same cold model trigger ONE load)."""

    def __init__(self, loader: Callable, max_models: int):
        self._loader = loader
        self._max = max_models
        self._models: OrderedDict[str, Any] = OrderedDict()
        self._loading: dict[str, asyncio.Future] = {}

    async def get(self, model_id: str):
        if model_id in self._models:
            self._models.move_to_end(model_id)
            return self._models[model_id]
        pending = self._loading.get(model_id)
        if pending is not None:
            return await asyncio.shield(pending)
        fut = asyncio.get_running_loop().create_future()
        self._loading[model_id] = fut
        try:
            # Make room BEFORE the load: the cap bounds device memory, and
            # uploading a (max+1)-th model while max are still resident
            # would OOM exactly the workload the cap was sized for.  The
            # capacity check counts in-flight loads too (including this
            # one), so N concurrent cold-model requests cannot each see a
            # half-empty cache and leave max+N models resident.
            self._evict_for_capacity()
            model = await self._loader(model_id)
            self._loading.pop(model_id, None)
            self._models[model_id] = model
            # Re-trim: another load may have filled the cache while ours
            # was in flight. Never evict the model just inserted — that
            # would discard the upload this call was made for; concurrent
            # in-flight loads each re-trim when they land.
            self._evict_for_capacity(protect=model_id)
            fut.set_result(model)
            return model
        except BaseException as e:
            # Includes CancelledError: waiters sharing this single-flight
            # future must never hang on an unresolved future.
            if not fut.done():
                fut.set_exception(
                    RuntimeError(f"model load {model_id!r} failed: {e!r}")
                )
                fut.exception()  # consumed here if nobody else awaited
            raise
        finally:
            self._loading.pop(model_id, None)

    def _evict_for_capacity(self, protect: str | None = None) -> None:
        # GC of a popped entry frees its device tensors.
        while (
            self._models
            and len(self._models) + len(self._loading) > self._max
        ):
            victim = next(iter(self._models))
            if victim == protect:
                if len(self._models) == 1:
                    break  # only the protected model resident: nothing to do
                victim = next(k for k in self._models if k != protect)
            self._models.pop(victim)

    def loaded_ids(self) -> list[str]:
        return list(self._models)


class _MultiplexedMethod:
    def __init__(self, fn, max_models: int):
        self._fn = fn
        self._max = max_models
        functools.update_wrapper(self, fn)

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        cache_name = f"__model_cache_{self._fn.__name__}"
        cache = getattr(instance, cache_name, None)
        if cache is None:
            bound = self._fn.__get__(instance, owner)
            cache = _ModelCache(bound, self._max)
            setattr(instance, cache_name, cache)

        async def get_model(model_id: str | None = None):
            mid = model_id if model_id is not None else get_multiplexed_model_id()
            if not mid:
                raise ValueError(
                    "no model id: pass one, or set multiplexed_model_id on "
                    "the calling handle / serve_multiplexed_model_id header"
                )
            return await cache.get(mid)

        get_model.cache = cache  # introspection + tests
        return get_model


def multiplexed(
    _fn: Callable | None = None, *, max_num_models_per_replica: int = 3
) -> Any:
    """Decorate an async model loader `async def get_model(self, model_id)`
    (reference: python/ray/serve/multiplex.py)."""
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an async def")
        return _MultiplexedMethod(fn, max_num_models_per_replica)

    return wrap if _fn is None else wrap(_fn)
