"""User-visible runtime errors. Port of ``ray_tpu/core/errors.py``
(reference parity: python/ray/exceptions.py), plus :class:`NotPortedError`."""

from __future__ import annotations


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised an exception; carries the remote traceback.

    Re-raised at every `get` on the task's outputs, like the reference's
    RayTaskError (reference: python/ray/exceptions.py).
    """

    def __init__(self, function_name: str, traceback_str: str, cause=None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"task {function_name} failed:\n{traceback_str}"
        )

    def __reduce__(self):
        return (TaskError, (self.function_name, self.traceback_str, self.cause))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor is dead (crashed, killed, or out of restarts)."""


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """Object value was lost and could not be reconstructed."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class DeadlineExceededError(RayTpuError, TimeoutError):
    """An RPC got no reply within its per-call deadline (hung or partitioned
    peer). Transport-level: retried automatically for idempotent methods
    (protocol.IDEMPOTENT_RPCS); counts toward the peer's circuit breaker."""


class PeerUnavailableError(RayTpuError, ConnectionError):
    """The peer's circuit breaker is open: N consecutive transport failures
    tripped it, and calls fail fast until the half-open timer elapses.
    Schedulers treat such peers as suspect (no new leases) instead of
    surfacing this as an exception storm. A ConnectionError subclass so
    every existing peer-down handler (owner loss -> ObjectLostError,
    worker loss -> reap and retry) treats a fast-fail exactly like the
    connection loss it stands in for."""


class OverloadedError(RayTpuError):
    """Request rejected by the serve overload-protection plane instead of
    queuing: per-tenant token budget exhausted (``reason="throttled"``),
    priority shed while a deployment is past its watermarks
    (``reason="shed"``), or a replica's bounded queue failed fast
    (``reason="queue_full"``). Carries ``retry_after_s`` — the ingress maps
    it onto HTTP 429 + ``Retry-After`` and gRPC RESOURCE_EXHAUSTED. The
    kill switch RAY_TPU_ADMISSION=0 removes every raise site."""

    def __init__(
        self,
        message: str = "overloaded",
        retry_after_s: float = 1.0,
        reason: str = "shed",
    ):
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        super().__init__(message)

    def __reduce__(self):
        # Explicit: the error crosses the replica->router RPC boundary as a
        # TaskError cause and must unpickle with its fields intact.
        return (
            OverloadedError,
            (self.args[0] if self.args else "overloaded",
             self.retry_after_s, self.reason),
        )


class PeerDiedError(RayTpuError):
    """A collective peer died while the group was forming or mid-op.

    Raised by the coordinator's join/collective wait loops the moment a
    death is reported (``report_death``), instead of leaving every other
    rank blocked on the barrier until the full RPC deadline — group
    (re)formation fails fast and the caller can re-form at the new
    membership. Carries the dead rank and the reported reason."""

    def __init__(self, rank: int = -1, reason: str = ""):
        self.rank = int(rank)
        self.reason = reason
        super().__init__(
            f"collective peer rank {rank} died"
            + (f": {reason}" if reason else "")
        )

    def __reduce__(self):
        # Crosses the coordinator-actor RPC boundary as a TaskError cause;
        # must unpickle with fields intact.
        return (PeerDiedError, (self.rank, self.reason))


class StaleGroupEpochError(RayTpuError):
    """A rank from a retired group generation issued a collective against
    a coordinator that has advanced its epoch (elastic re-formation).
    Fencing: the stale rank fails fast here instead of contributing into
    (and hanging) the new generation's ops."""

    def __init__(self, epoch: int = -1, current: int = -1):
        self.epoch = int(epoch)
        self.current = int(current)
        super().__init__(
            f"stale collective epoch {epoch} (coordinator is at "
            f"epoch {current}); the group re-formed — re-join required"
        )

    def __reduce__(self):
        return (StaleGroupEpochError, (self.epoch, self.current))


class FaultInjectedError(RayTpuError):
    """Raised by the deterministic fault-injection plane (core/faults.py);
    never seen in production (the injector is off unless RAY_TPU_FAULTS or
    an explicit install() enables it)."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via cancel(); raised at get() on its outputs
    (reference: python/ray/exceptions.py TaskCancelledError)."""


class SchedulingError(RayTpuError):
    """No feasible node for the requested resources."""


class PlacementGroupError(RayTpuError):
    pass


class NotPortedError(RayTpuError, NotImplementedError):
    """A feature of the reference runtime that ray_tpu_torch does not have
    yet was asked for. The message names the feature; nothing falls back
    silently."""

    def __init__(self, feature: str):
        self.feature = feature
        super().__init__(f"{feature} is not ported to ray_tpu_torch yet")

    def __reduce__(self):
        return (NotPortedError, (self.feature,))
