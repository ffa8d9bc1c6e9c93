"""gRPC ingress for Serve deployments.
Port of ``ray_tpu/serve/grpc_ingress.py``.

Reference parity: python/ray/serve/_private/proxy.py:534 (gRPCProxy) —
redesigned without generated stubs: a ``GenericRpcHandler`` serves two
fixed methods with cloudpickled dict payloads, so users need NO .proto
compilation to call a deployment over gRPC (the reference requires
user-supplied protos + codegen):

    /raytpu.serve.ServeAPI/Call        unary-unary
    /raytpu.serve.ServeAPI/StreamCall  unary-stream (chunked responses)

Request payload (cloudpickled dict):
    {"deployment": str, "request": Any,
     "multiplexed_model_id": str (optional)}
Response payload: cloudpickled result value (Call) or one chunk per
message (StreamCall). Errors surface as gRPC status INTERNAL/NOT_FOUND.

Client side: :func:`call` / :func:`stream_call` wrap an insecure channel
with the same serialization, so a non-member process can speak to the
ingress with nothing but grpc + this module.
"""

from __future__ import annotations

from typing import Any, Iterator

import cloudpickle

CALL_METHOD = "/raytpu.serve.ServeAPI/Call"
STREAM_METHOD = "/raytpu.serve.ServeAPI/StreamCall"


def _handle_factory(proxy):
    """Build the generic handler bound to a proxy actor's deployment
    handles (proxy: HTTPProxyActor — it owns handle caching/routing)."""
    import grpc

    async def _resolve(request_bytes: bytes):
        req = cloudpickle.loads(request_bytes)
        deployment = req.get("deployment")
        if not deployment:
            raise KeyError("request dict needs a 'deployment' key")
        handle = proxy._handle_for(deployment)
        model_id = req.get("multiplexed_model_id", "")
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        # Admission identity: gRPC callers have no HTTP headers, so the
        # call envelope carries the tenant key / priority class directly
        # (the metadata-equivalent of the serve_tenant_header contract).
        tenant = req.get("tenant", "")
        priority = req.get("priority", "")
        if tenant or priority:
            handle = handle.options(tenant=tenant, priority=priority)
        return handle, req.get("request")

    async def call_unary(request_bytes, context):
        from ray_tpu_torch.core.errors import OverloadedError
        from ray_tpu_torch.serve.router import DeploymentNotFoundError

        try:
            handle, payload = await _resolve(request_bytes)
            result = await handle.remote_async(payload)
            return cloudpickle.dumps(result)
        except (KeyError, DeploymentNotFoundError) as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except OverloadedError as e:
            # Admission rejection -> RESOURCE_EXHAUSTED (the gRPC twin of
            # HTTP 429); the retry hint rides the status message.
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"{e} (retry after {e.retry_after_s:.1f}s)",
            )
        except Exception as e:  # noqa: BLE001 — user errors -> INTERNAL
            await context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )

    async def call_stream(request_bytes, context):
        from ray_tpu_torch.core.errors import OverloadedError
        from ray_tpu_torch.serve.router import DeploymentNotFoundError

        try:
            handle, payload = await _resolve(request_bytes)
            chunks = await handle.options(stream=True).remote_async(payload)
            async for chunk in chunks:
                yield cloudpickle.dumps(chunk)
        except (KeyError, DeploymentNotFoundError) as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except OverloadedError as e:
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"{e} (retry after {e.retry_after_s:.1f}s)",
            )
        except Exception as e:  # noqa: BLE001
            await context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )

    class _Handler(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            if handler_call_details.method == CALL_METHOD:
                return grpc.unary_unary_rpc_method_handler(
                    call_unary,
                    request_deserializer=None,  # raw bytes in/out
                    response_serializer=None,
                )
            if handler_call_details.method == STREAM_METHOD:
                return grpc.unary_stream_rpc_method_handler(
                    call_stream,
                    request_deserializer=None,
                    response_serializer=None,
                )
            return None

    return _Handler()


async def start_grpc_server(proxy, host: str, port: int):
    """Start the aio gRPC server on the proxy actor's event loop; returns
    (server, bound_port)."""
    import grpc.aio

    server = grpc.aio.server()
    server.add_generic_rpc_handlers((_handle_factory(proxy),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"could not bind gRPC ingress on {host}:{port}")
    await server.start()
    return server, bound


# -- client helpers -----------------------------------------------------------


def call(
    target: str,
    deployment: str,
    request: Any,
    *,
    multiplexed_model_id: str = "",
    tenant: str = "",
    priority: str = "",
    timeout: float = 60.0,
):
    """One unary call to the ingress at ``target`` ("host:port").
    ``tenant``/``priority`` are the admission identity (overload plane);
    an over-budget or shed request fails with RESOURCE_EXHAUSTED."""
    import grpc

    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_unary(
            CALL_METHOD,
            request_serializer=None,
            response_deserializer=None,
        )
        payload = {"deployment": deployment, "request": request}
        if multiplexed_model_id:
            payload["multiplexed_model_id"] = multiplexed_model_id
        if tenant:
            payload["tenant"] = tenant
        if priority:
            payload["priority"] = priority
        return cloudpickle.loads(
            fn(cloudpickle.dumps(payload), timeout=timeout)
        )


def stream_call(
    target: str,
    deployment: str,
    request: Any,
    *,
    multiplexed_model_id: str = "",
    timeout: float = 120.0,
) -> Iterator[Any]:
    """Streaming call: yields response chunks as they arrive."""
    import grpc

    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_stream(
            STREAM_METHOD,
            request_serializer=None,
            response_deserializer=None,
        )
        payload = {"deployment": deployment, "request": request}
        if multiplexed_model_id:
            payload["multiplexed_model_id"] = multiplexed_model_id
        for chunk in fn(cloudpickle.dumps(payload), timeout=timeout):
            yield cloudpickle.loads(chunk)
