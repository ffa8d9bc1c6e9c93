"""ASGI app mounting: run any ASGI 3.0 app (FastAPI, Starlette, or a
bare ``async def app(scope, receive, send)``) as a deployment. Port of
``ray_tpu/serve/asgi.py``.

Reference parity: python/ray/serve/_private/replica.py:1139
(ASGIAppReplicaWrapper — the reference mounts user FastAPI apps inside
replicas). Redesign for this runtime's proxy: the wrapper is an ordinary
deployment callable whose ``__call__`` is an ASYNC GENERATOR — first
item is the response head ``{"__asgi__", "status", "headers"}``, then
raw body chunks as the app sends them. The buffered proxy path drains
the generator and replies with the app's own status/headers/body; the
streaming path forwards chunks the moment they arrive (SSE apps stream
intact, under the app's own content-type). One wrapper serves both.
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any
from urllib.parse import urlencode


def _resolve_app(app_or_factory: Any):
    """An ASGI app takes (scope, receive, send); a zero-arg callable is a
    factory (the FastAPI-app-builder pattern — app objects often hold
    unpicklable state, so ship the factory and build in the replica)."""
    if callable(app_or_factory):
        try:
            params = inspect.signature(app_or_factory).parameters
        except (TypeError, ValueError):
            params = None
        if params is not None and len(params) == 0:
            return app_or_factory()
    return app_or_factory


class ASGIAppWrapper:
    """Deployment callable wrapping an ASGI 3.0 app."""

    def __init__(self, app_or_factory: Any):
        self._app = _resolve_app(app_or_factory)
        if not callable(self._app):
            raise TypeError(
                f"not an ASGI app (or factory of one): {self._app!r}"
            )

    @staticmethod
    def _scope(request: dict) -> dict:
        headers = [
            (str(k).lower().encode("latin1"), str(v).encode("latin1"))
            for k, v in (request.get("headers") or {}).items()
        ]
        path = request.get("path") or "/"
        return {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.get("method", "GET"),
            "scheme": "http",
            "path": path,
            "raw_path": path.encode(),
            "query_string": urlencode(request.get("query") or {}).encode(),
            "root_path": "",
            "headers": headers,
            "client": ("127.0.0.1", 0),
            "server": ("127.0.0.1", 0),
        }

    async def __call__(self, request: dict):
        body = request.get("raw_body") or b""
        if isinstance(body, str):
            body = body.encode()
        messages = [
            {"type": "http.request", "body": bytes(body), "more_body": False}
        ]

        async def receive():
            if messages:
                return messages.pop(0)
            return {"type": "http.disconnect"}

        q: asyncio.Queue = asyncio.Queue()
        done = object()  # sentinel: the app task exited

        async def send(msg):
            await q.put(msg)

        task = asyncio.ensure_future(
            self._app(self._scope(request), receive, send)
        )
        # Done-callback sentinel instead of timeout polling: the queue
        # wakes exactly when a message (or app exit) arrives — the old
        # 50 ms wait_for poll added up to 50 ms latency per chunk gap and
        # busy-woke the loop in between. FIFO guarantees the sentinel
        # lands after everything the app sent.
        task.add_done_callback(lambda t: q.put_nowait(done))
        try:
            while True:
                msg = await q.get()
                if msg is done:
                    # App returned: surface its error (pre-head errors
                    # become 500s at the proxy) or end the stream.
                    exc = task.exception()
                    if exc is not None:
                        raise exc
                    return
                if msg["type"] == "http.response.start":
                    yield {
                        "__asgi__": True,
                        "status": int(msg.get("status", 200)),
                        "headers": [
                            [k.decode("latin1"), v.decode("latin1")]
                            for k, v in msg.get("headers", [])
                        ],
                    }
                elif msg["type"] == "http.response.body":
                    chunk = msg.get("body", b"")
                    if chunk:
                        yield bytes(chunk)
                    if not msg.get("more_body", False):
                        return
        finally:
            if not task.done():
                # Final-body sent (or early close) but the app is still
                # unwinding: give it a moment, then cancel AND await the
                # cancellation so cleanup is never abandoned mid-unwind.
                try:
                    await asyncio.wait_for(asyncio.shield(task), 1.0)
                except BaseException:
                    task.cancel()
                    try:
                        # Bounded: an app that swallows CancelledError (or
                        # whose cleanup wedges) must not hang the replica's
                        # close path forever.
                        await asyncio.wait_for(asyncio.shield(task), 1.0)
                    except BaseException:  # raylint: disable=RL006 -- bounded 1s grace for the app task; the sentinel below force-closes
                        pass
