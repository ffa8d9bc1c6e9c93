"""The active tracing span's context. Port of the part of
``ray_tpu/util/tracing.py`` that the flight recorder reads.

The reference propagates a ``(trace_id, span_id)`` pair through a context
variable, and :func:`ray_tpu_torch.util.flightrec.record` stamps it on each
event so spans and in-plane events join one tree. The port has the context
variable and its reader; spans, their export and sampling come with a later
slice, so until then no span is ever active here.
"""

from __future__ import annotations

import contextvars
from typing import Optional

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace", default=None
)  # (trace_id, span_id) | None


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) of the active span, or None."""
    return _ctx.get()
