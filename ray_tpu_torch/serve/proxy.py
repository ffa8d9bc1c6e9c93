"""HTTP ingress proxy actor. Port of ``ray_tpu/serve/proxy.py``.

Reference parity: python/ray/serve/_private/proxy.py:710 (HTTPProxy), with a
stdlib asyncio HTTP/1.1 server instead of uvicorn (zero extra dependencies;
the proxy is an actor, so ingress scales by adding proxy actors per node).

Routing: /{deployment}[/*] -> DeploymentHandle(deployment). The user callable
receives one dict: {"method", "path", "query", "headers", "body"} where body
is parsed JSON when the payload is JSON, else the raw string. The response
value is JSON-encoded.
"""

from __future__ import annotations

import asyncio
import json
import math
from urllib.parse import parse_qs, urlparse

from ray_tpu_torch.core.errors import OverloadedError
from ray_tpu_torch.serve.handle import DeploymentHandle

_ASGI = object()  # _route's "raw ASGI response" status sentinel

_REASONS = {
    200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently",
    302: "Found", 304: "Not Modified", 400: "Bad Request",
    401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 422: "Unprocessable Entity",
    429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


def _overload_response(e: OverloadedError) -> tuple:
    """(status, payload, headers) for an admission rejection: HTTP 429
    with a whole-second Retry-After (ceil — "retry in 0 s" would invite
    an immediate stampede)."""
    retry_after = max(1, int(math.ceil(e.retry_after_s)))
    return (
        429,
        {"error": str(e), "reason": e.reason,
         "retry_after_s": e.retry_after_s},
        {"Retry-After": str(retry_after)},
    )


class HTTPProxyActor:
    def __init__(self, controller):
        self._controller = controller
        self._handles: dict[str, DeploymentHandle] = {}
        self._server = None
        self._port = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._serve_conn, host=host, port=port
        )
        self._port = self._server.sockets[0].getsockname()[1]
        return self._port

    async def start_grpc(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """gRPC ingress next to HTTP, same routing/handles (reference:
        serve/_private/proxy.py:534 gRPCProxy; see grpc_ingress.py)."""
        if getattr(self, "_grpc_server", None) is not None:
            return self._grpc_port
        from ray_tpu_torch.serve.grpc_ingress import start_grpc_server

        self._grpc_server, self._grpc_port = await start_grpc_server(
            self, host, port
        )
        return self._grpc_port

    async def ping(self) -> bool:
        return True

    def _handle_for(self, deployment: str) -> DeploymentHandle:
        h = self._handles.get(deployment)
        if h is None:
            h = self._handles[deployment] = DeploymentHandle(deployment)
        return h

    async def _serve_conn(self, reader, writer):
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, target, _version = (
                        line.decode("latin1").strip().split(" ", 2)
                    )
                except ValueError:
                    await self._respond(writer, 400, {"error": "bad request"})
                    return
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = h.decode("latin1").partition(":")
                    headers[name.strip().lower()] = value.strip()
                body = b""
                if "content-length" in headers:
                    body = await reader.readexactly(
                        int(headers["content-length"])
                    )
                parsed = self._parse_body(body)
                if self._wants_stream(headers, parsed):
                    await self._route_stream(
                        writer, method, target, headers, parsed, body
                    )
                    return  # streamed responses close the connection
                status, payload, extra = await self._route(
                    method, target, headers, parsed, body
                )
                if status is _ASGI:
                    await self._respond_asgi(writer, payload)
                    return  # raw responses close the connection
                keep = (
                    headers.get("connection", "keep-alive").lower() != "close"
                )
                await self._respond(writer, status, payload, keep, extra)
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # raylint: disable=RL006 -- HTTP connection close; client already went away
                pass

    @staticmethod
    def _parse(method: str, target: str, headers: dict, parsed, raw=b""):
        """(request_dict, deployment, error): the user-callable request shape
        shared by the buffered and streaming paths. ``raw_body`` carries
        the unparsed payload bytes — ASGI deployments must see the wire
        bytes, not the proxy's JSON view."""
        url = urlparse(target)
        parts = [p for p in url.path.split("/") if p]
        if not parts:
            return None, None, "no deployment in path"
        request = {
            "method": method,
            "path": "/" + "/".join(parts[1:]),
            "query": {k: v[-1] for k, v in parse_qs(url.query).items()},
            "headers": dict(headers),
            "body": parsed,
            "raw_body": raw,
        }
        return request, parts[0], None

    async def _route(
        self, method: str, target: str, headers: dict, parsed, raw=b""
    ):
        from ray_tpu_torch.serve.router import DeploymentNotFoundError

        request, deployment, err = self._parse(
            method, target, headers, parsed, raw
        )
        if err is not None:
            return 404, {"error": err}, None
        try:
            handle = self._handle_for(deployment)
            model_id = headers.get("serve_multiplexed_model_id", "")
            if model_id:
                handle = handle.options(multiplexed_model_id=model_id)
            result = await handle.remote_async(request)
            if (
                isinstance(result, list)
                and result
                and isinstance(result[0], dict)
                and result[0].get("__asgi__")
            ):
                # A drained ASGI generator: [head, chunk, chunk, ...] —
                # reply with the app's own status/headers/body.
                return _ASGI, result, None
            return 200, result, None
        except DeploymentNotFoundError as e:
            return 404, {"error": str(e)}, None
        except OverloadedError as e:
            # Admission rejection (shed / throttled / replica queue full):
            # predictable degradation is an HTTP contract — 429 with a
            # Retry-After the client can honor, not a 500.
            return _overload_response(e)
        except Exception as e:  # noqa: BLE001 — user errors are 500s
            return 500, {"error": f"{type(e).__name__}: {e}"}, None

    @staticmethod
    def _parse_body(body: bytes):
        """Parse the payload ONCE; JSON when it is JSON, else raw text."""
        if not body:
            return None
        try:
            return json.loads(body)
        except ValueError:
            return body.decode("utf-8", "replace")

    @staticmethod
    def _wants_stream(headers: dict, parsed) -> bool:
        """SSE streaming when the client asks for it: an event-stream Accept
        header, or the OpenAI convention of {"stream": true} in the JSON
        body (reference: serve/_private/proxy.py:710 streaming path)."""
        if "text/event-stream" in headers.get("accept", ""):
            return True
        return bool(isinstance(parsed, dict) and parsed.get("stream"))

    async def _route_stream(
        self, writer, method, target, headers, parsed, raw=b""
    ):
        """Route to the deployment's streaming path and write each chunk as
        a server-sent event the moment it arrives; terminate with
        `data: [DONE]` (the OpenAI wire convention). The first chunk is
        pulled BEFORE the status line goes out, so routing failures (unknown
        deployment, no replicas) surface as proper HTTP errors instead of a
        200 that then errors mid-stream. ASGI deployments announce
        themselves in their first chunk and stream RAW under the app's own
        headers instead of SSE-wrapped."""
        from ray_tpu_torch.serve.router import DeploymentNotFoundError

        request, deployment, err = self._parse(
            method, target, headers, parsed, raw
        )
        if err is not None:
            await self._respond(writer, 404, {"error": err})
            return
        handle = self._handle_for(deployment).options(
            stream=True,
            multiplexed_model_id=headers.get(
                "serve_multiplexed_model_id", ""
            ),
        )
        first = None
        exhausted = False
        try:
            chunks = await handle.remote_async(request)
            try:
                first = await chunks.__anext__()
            except StopAsyncIteration:
                exhausted = True
        except DeploymentNotFoundError as e:
            await self._respond(writer, 404, {"error": str(e)})
            return
        except OverloadedError as e:
            status, payload, extra = _overload_response(e)
            await self._respond(writer, status, payload, extra_headers=extra)
            return
        except Exception as e:  # noqa: BLE001 — pre-stream errors are 500s
            await self._respond(
                writer, 500, {"error": f"{type(e).__name__}: {e}"}
            )
            return
        if (
            not exhausted
            and isinstance(first, dict)
            and first.get("__asgi__")
        ):
            await self._stream_asgi(writer, first, chunks)
            return
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n"
            b"\r\n"
        )
        await writer.drain()
        try:
            if not exhausted:
                writer.write(
                    f"data: {json.dumps(first, default=str)}\n\n".encode()
                )
                await writer.drain()
                async for chunk in chunks:
                    data = json.dumps(chunk, default=str)
                    writer.write(f"data: {data}\n\n".encode())
                    await writer.drain()
        except Exception as e:  # noqa: BLE001 — mid-stream errors as events
            payload = {"error": f"{type(e).__name__}: {e}"}
            writer.write(f"data: {json.dumps(payload)}\n\n".encode())
        # Always terminate the stream so OpenAI-style read-until-[DONE]
        # clients never hang on an errored stream.
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()

    @staticmethod
    def _asgi_head_bytes(head: dict, *, content_length=None) -> bytes:
        status = int(head.get("status", 200))
        reason = _REASONS.get(status, "OK")
        lines = [f"HTTP/1.1 {status} {reason}"]
        for k, v in head.get("headers", []):
            if k.lower() in ("connection", "content-length", "transfer-encoding"):
                continue  # the proxy owns framing
            lines.append(f"{k}: {v}")
        if content_length is not None:
            lines.append(f"Content-Length: {content_length}")
        lines.append("Connection: close")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")

    async def _respond_asgi(self, writer, result: list):
        """Buffered ASGI reply: [head, chunk, ...] with the app's own
        status/headers/body (reference: replica.py:1139's ASGI wrapper —
        the response is the app's, not the proxy's JSON envelope)."""
        head = result[0]
        body = b"".join(
            c if isinstance(c, (bytes, bytearray)) else str(c).encode()
            for c in result[1:]
        )
        writer.write(
            self._asgi_head_bytes(head, content_length=len(body)) + body
        )
        await writer.drain()

    async def _stream_asgi(self, writer, head: dict, chunks):
        """Raw streamed ASGI reply: forward body chunks as they arrive
        under the app's own headers (SSE apps stream intact)."""
        writer.write(self._asgi_head_bytes(head))
        await writer.drain()
        try:
            async for chunk in chunks:
                if not isinstance(chunk, (bytes, bytearray)):
                    chunk = str(chunk).encode()
                writer.write(bytes(chunk))
                await writer.drain()
        except Exception:  # noqa: BLE001 — mid-stream: connection close  # raylint: disable=RL006 -- mid-stream client disconnect; nothing to send the rest to
            pass

    async def _respond(
        self, writer, status: int, payload, keep=False, extra_headers=None
    ):
        reason = _REASONS.get(status, "Internal Server Error")
        try:
            data = json.dumps(payload, default=str).encode()
        except (TypeError, ValueError):
            data = json.dumps({"result": str(payload)}).encode()
        extra = "".join(
            f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items()
        )
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"{extra}"
            f"Connection: {'keep-alive' if keep else 'close'}\r\n"
            f"\r\n".encode() + data
        )
        await writer.drain()
