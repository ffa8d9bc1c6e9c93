"""User-visible errors. Port of the part of ``ray_tpu/core/errors.py`` that
the port raises: the base class and the fast-fail peer error that a severed
KV handoff raises (:mod:`ray_tpu_torch.llm.disagg`)."""

from __future__ import annotations


class RayTpuError(Exception):
    pass


class PeerUnavailableError(RayTpuError, ConnectionError):
    """The peer is unreachable and the call fails fast. A
    ``ConnectionError`` subclass, so every peer-down handler treats it as
    the connection loss it stands in for."""
