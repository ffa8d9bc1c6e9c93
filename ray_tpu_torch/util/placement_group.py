"""Placement groups — gang reservation of resource bundles across nodes.
Port of ``ray_tpu/util/placement_group.py``.

Reference parity: python/ray/util/placement_group.py (user API) and the GCS
placement-group scheduler with its two-phase prepare/commit of bundles
(src/ray/gcs/gcs_placement_group_scheduler.h:281, CommitAllBundles :425;
node-side src/ray/raylet/placement_group_resource_manager.h). Committed
bundles surface as *formatted resources* on the hosting node —
``{res}_group_{pg_id}`` (wildcard) and ``{res}_group_{index}_{pg_id}``
(per-bundle) plus ``bundle_group*`` markers — and tasks/actors scheduled with
a PlacementGroupSchedulingStrategy have their demands rewritten onto those
names, so gang placement rides the ordinary lease scheduler.

This is the substrate a gang of GPU workers reserves its cards through: one
bundle per worker, ``{"GPU": 1}`` each, placed by ``STRICT_PACK`` or
``SPREAD``.
"""

from __future__ import annotations

import contextvars
import threading
import uuid
from typing import Any, Optional

BUNDLE_MARKER = "bundle_group"
BUNDLE_MARKER_CAPACITY = 1000.0
BUNDLE_MARKER_DEMAND = 0.001

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")

# Ambient placement group of the currently executing task/actor, as a
# (pg_id, capture_child_tasks) pair. Sync user code runs on executor threads
# (no contextvar propagation through run_in_executor) → thread-local; async
# user code runs on the event loop → contextvar scoped to the handler task.
_current_pg: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "ray_tpu_current_pg", default=None
)
_tls = threading.local()


def formatted_bundle_resources(
    resources: dict, pg_id: str, index: int
) -> dict:
    """The formatted resources a node gains when it commits one bundle."""
    out = {}
    for k, v in resources.items():
        out[f"{k}_group_{pg_id}"] = v
        out[f"{k}_group_{index}_{pg_id}"] = v
    out[f"{BUNDLE_MARKER}_{pg_id}"] = BUNDLE_MARKER_CAPACITY
    out[f"{BUNDLE_MARKER}_{index}_{pg_id}"] = BUNDLE_MARKER_CAPACITY
    return out


def translate_resources_for_pg(
    resources: dict, pg_id: str, bundle_index: int = -1
) -> dict:
    """Rewrite a task/actor resource demand onto a group's formatted
    resources (reference: BundleSpecification's formatted-resource naming)."""
    out = {}
    for k, v in resources.items():
        if bundle_index is None or bundle_index < 0:
            out[f"{k}_group_{pg_id}"] = v
        else:
            out[f"{k}_group_{bundle_index}_{pg_id}"] = v
    if bundle_index is None or bundle_index < 0:
        out[f"{BUNDLE_MARKER}_{pg_id}"] = BUNDLE_MARKER_DEMAND
    else:
        out[f"{BUNDLE_MARKER}_{bundle_index}_{pg_id}"] = BUNDLE_MARKER_DEMAND
    return out


class PlacementGroup:
    """Handle to a placement group (reference:
    python/ray/util/placement_group.py:46)."""

    def __init__(self, pg_id: str, bundles: Optional[list[dict]] = None):
        self.id = pg_id
        self._bundles = bundles

    @property
    def bundle_specs(self) -> list[dict]:
        if self._bundles is None:
            info = _gcs_call("get_placement_group", {"pg_id": self.id})
            self._bundles = info["bundles"] if info else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self):
        """ObjectRef that resolves when every bundle is committed (matches
        the reference's ``pg.ready()`` returning an awaitable ref)."""
        import ray_tpu_torch

        pg_id = self.id

        @ray_tpu_torch.remote
        def _pg_ready(pg_id: str = pg_id):
            _gcs_call(
                "wait_pg_ready",
                {"pg_id": pg_id, "timeout": 3600.0},
                timeout=3610.0,
            )
            return True

        return _pg_ready.options(num_cpus=0).remote()

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until the group is fully committed; False on timeout."""
        try:
            _gcs_call(
                "wait_pg_ready",
                {"pg_id": self.id, "timeout": float(timeout_seconds)},
                timeout=float(timeout_seconds) + 10.0,
            )
            return True
        except Exception:  # raylint: disable=RL006 -- wait() contract: timeout/GCS error is the False verdict
            return False

    def __eq__(self, other):
        return isinstance(other, PlacementGroup) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"PlacementGroup(id={self.id[:12]}…)"

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def _gcs_call(method: str, payload: dict, timeout: float = 60.0):
    from ray_tpu_torch.core import api as _api

    worker = _api._require_worker()
    return worker.gcs.call(method, payload, timeout=timeout)


def placement_group(
    bundles: list[dict],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    bundle_label_selector: Optional[list[dict]] = None,
) -> PlacementGroup:
    """Create a placement group of resource ``bundles`` (list of resource
    dicts). Returns immediately; use ``.wait()`` / ``.ready()`` to block
    until all bundles are reserved."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"invalid strategy {strategy!r}; one of {VALID_STRATEGIES}"
        )
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    cleaned = []
    for b in bundles:
        if any(v < 0 for v in b.values()):
            raise ValueError(f"negative resource in bundle {b!r}")
        # Zero-valued entries are stripped; a bundle with no positive demand
        # would commit as an unusable no-op, so reject it outright
        # (reference requires strictly positive bundle values).
        c = {k: v for k, v in b.items() if v > 0}
        if not c:
            raise ValueError(
                f"bundle {b!r} has no positive resource demand"
            )
        cleaned.append(c)
    bundles = cleaned
    pg_id = uuid.uuid4().hex
    spec = {
        "pg_id": pg_id,
        "name": name or None,
        "bundles": [dict(b) for b in bundles],
        "strategy": strategy,
        "lifetime": lifetime,
        "label_selectors": [dict(s) for s in (bundle_label_selector or [])],
    }
    _gcs_call("create_placement_group", {"spec": spec})
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release all bundles and fail future tasks targeting the group."""
    _gcs_call("remove_placement_group", {"pg_id": pg.id})


def get_placement_group(name: str) -> PlacementGroup:
    info = _gcs_call("get_placement_group", {"name": name})
    if info is None:
        raise ValueError(f"no placement group named {name!r}")
    return PlacementGroup(info["pg_id"], info["bundles"])


def placement_group_table(pg: Optional[PlacementGroup] = None) -> dict:
    """State of one group or every group (reference:
    python/ray/util/placement_group.py placement_group_table)."""
    if pg is not None:
        info = _gcs_call("get_placement_group", {"pg_id": pg.id})
        return info or {}
    return {
        info["pg_id"]: info
        for info in _gcs_call("list_placement_groups", {})
    }


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The placement group of the currently executing task/actor (None when
    not running inside one)."""
    info = _ambient_pg()
    return PlacementGroup(info[0]) if info else None


def _ambient_pg() -> Optional[tuple]:
    """(pg_id, capture_child_tasks) of the executing task, or None."""
    info = getattr(_tls, "pg", None)
    return info if info is not None else _current_pg.get()


class _bind_ambient_pg:
    """Context manager binding the ambient pg on both carriers."""

    def __init__(self, info: Optional[tuple]):
        self.info = tuple(info) if info else None

    def __enter__(self):
        self._prev_tls = getattr(_tls, "pg", None)
        _tls.pg = self.info
        self._token = _current_pg.set(self.info)
        return self

    def __exit__(self, *exc):
        _tls.pg = self._prev_tls
        _current_pg.reset(self._token)
        return False
