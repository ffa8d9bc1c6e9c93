"""WorkerGroup — the gang of train-worker actors. Port of
``ray_tpu/train/worker_group.py``.

Reference parity: python/ray/train/v2/_internal/execution/worker_group/
worker_group.py — the stable rank assignment that sorts workers by (slice
name, host worker id, node id) so process-group ranks are deterministic
across restarts (:791-825). The port's nodes carry no TPU labels, so every
worker's ``slice_name`` is "" and its ``tpu_worker_id`` -1, as the
reference gives on a node without them, and the sort is the reference's
on such a node. The TPU slice placement (SlicePlacementGroup, :467-484) is
not ported and raises ``NotPortedError``.

The user train fn runs on a thread inside each worker actor; the controller
polls `status()` (actor calls from one caller are ordered, so a blocking
`run()` method would starve the polls).
"""

from __future__ import annotations

import socket
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.context import TrainContext, set_context
from ray_tpu_torch.train.elastic import ElasticPauseSignal
from ray_tpu_torch.train.storage import StorageContext
from ray_tpu_torch.util import metrics as _metrics

# Gang liveness gauge: 1 while this rank's train fn thread is running.
# The rank tag is bounded by world size.
_WORKER_RUNNING = _metrics.Gauge(
    "raytpu_train_worker_running",
    "1 while this rank's train loop thread is running",
    tag_keys=("rank",),
)


@ray_tpu_torch.remote
class TrainWorker:
    """One training process. Runs the user fn on a private thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._state = "idle"  # idle | running | paused | finished | failed
        self._error: Optional[str] = None
        self._ctx: Optional[TrainContext] = None
        # Boundary state staged for the NEXT start_run's context (elastic
        # resume): either this rank's own retained copy (survivor at the
        # boundary) or a peer-hydrated reassembly.
        self._pending_elastic: Optional[dict] = None

    # -- metadata / env ------------------------------------------------------

    def get_metadata(self) -> dict:
        from ray_tpu_torch.util.net import local_ip

        return {
            "node_id": ray_tpu_torch.get_runtime_context().node_id,
            # No TPU slice labels on the port's nodes: the reference's
            # values for a node without them.
            "slice_name": "",
            "tpu_worker_id": -1,
            "hostname": socket.gethostname(),
            "ip": local_ip(),
        }

    def free_port(self) -> int:
        from ray_tpu_torch.util.net import free_port

        return free_port()

    def set_env(self, env: dict) -> bool:
        import os

        os.environ.update({k: str(v) for k, v in env.items()})
        return True

    def execute(self, fn_payload: bytes, *args, **kwargs):
        """Run an arbitrary function in this worker process (backend setup
        hook: torch.distributed.init_process_group etc.)."""
        fn = cloudpickle.loads(fn_payload)
        return fn(*args, **kwargs)

    # -- train loop ----------------------------------------------------------

    def start_run(
        self,
        fn_payload: bytes,
        config: Optional[dict],
        context_spec: dict,
        latest_checkpoint_path: Optional[str],
    ) -> bool:
        if self._state == "running":
            raise RuntimeError("already running")
        # Elastic resume on the same actor: reports the controller hasn't
        # polled off yet must survive the context swap (a checkpoint round
        # at the boundary only finalizes once every rank's report lands).
        leftover = self._ctx.drain_reports() if self._ctx else []
        storage = StorageContext(
            context_spec["storage_path"],
            context_spec["experiment_name"],
            num_to_keep=context_spec.get("num_to_keep"),
        )
        self._ctx = TrainContext(
            experiment_name=context_spec["experiment_name"],
            world_size=context_spec["world_size"],
            world_rank=context_spec["world_rank"],
            local_rank=context_spec["local_rank"],
            local_world_size=context_spec["local_world_size"],
            node_rank=context_spec["node_rank"],
            slice_name=context_spec.get("slice_name", ""),
            slice_rank=context_spec.get("slice_rank", 0),
            num_slices=context_spec.get("num_slices", 1),
            storage=storage,
            latest_checkpoint=(
                Checkpoint(latest_checkpoint_path)
                if latest_checkpoint_path
                else None
            ),
            # Resume numbering after the last persisted checkpoint: a fresh
            # generation restarting at index 0 would collide with generation-1
            # directories and silently keep stale state.
            _report_index=context_spec.get("start_report_index", 0),
        )
        if leftover:
            self._ctx._reports.extend(leftover)
        if self._pending_elastic is not None:
            self._ctx._elastic = self._pending_elastic
            self._pending_elastic = None
        fn = cloudpickle.loads(fn_payload)
        takes_config = config is not None
        self._state = "running"
        self._error = None

        rank_tag = {"rank": str(context_spec["world_rank"])}

        def run():
            set_context(self._ctx)
            # The backend's card is current on the thread that picked it;
            # the current device is per thread, so make it current here.
            from ray_tpu_torch.train.torch_backend import enter_device

            enter_device()
            if _metrics.metrics_enabled():
                _WORKER_RUNNING.set(1.0, rank_tag)
            try:
                if takes_config:
                    fn(config)
                else:
                    fn()
                # Async-dispatch reports still in the ring materialize now,
                # inside the try: a readback failure is a real train
                # failure, and the controller's next status() poll must see
                # every step's metrics before "finished".
                self._ctx.flush()
                self._state = "finished"
            except ElasticPauseSignal:
                # Step-boundary pause (elastic membership change): the
                # context — with its retained boundary state and any
                # not-yet-polled reports — stays installed on the actor;
                # the controller hydrates/reforms and calls resume_run.
                self._state = "paused"
            except BaseException as e:  # noqa: BLE001
                self._error = (
                    f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                )
                # Best-effort ring flush: the steps just before a crash
                # (the loss spike that explains it) are the most
                # diagnostic reports, and the synchronous loop would have
                # kept them. Readback may itself fail on a dead device —
                # the run is already failed either way.
                try:
                    self._ctx.flush()
                except BaseException:  # noqa: BLE001  # raylint: disable=RL006 -- the train fn's error is already captured; a failing readback must not mask it
                    pass
                self._state = "failed"
            finally:
                set_context(None)
                if _metrics.metrics_enabled():
                    _WORKER_RUNNING.set(0.0, rank_tag)

        self._thread = threading.Thread(
            target=run, name="train-loop", daemon=True
        )
        self._thread.start()
        return True

    def status(self) -> dict:
        reports = self._ctx.drain_reports() if self._ctx else []
        return {
            "state": self._state,
            "error": self._error,
            "reports": reports,
        }

    def ping(self) -> bool:
        return True

    # -- elastic plane -------------------------------------------------------

    def request_pause(self) -> bool:
        """Arm the step-boundary pause; the train fn unwinds at its next
        report() call. False when there's nothing running to pause."""
        if self._ctx is None or self._state != "running":
            return False
        return self._ctx.request_pause()

    def elastic_meta(self) -> dict:
        """What a paused rank holds: the boundary report index, the
        declared layout, and each leaf's dim0 length (None for 0-d/
        unsized leaves) — everything the controller's reshard planner
        needs, without touching the data."""
        el = self._ctx._elastic if self._ctx is not None else None
        if el is None:
            return {"state": self._state, "index": None}
        from ray_tpu_torch.train import elastic as _elastic

        leaves, _ = _elastic.flatten_state(el["state"])
        return {
            "state": self._state,
            "index": el["index"],
            "layout": el.get("layout", "replicated"),
            "leaf_rows": _elastic.leaf_rows(leaves),
        }

    def elastic_snapshot(self) -> dict:
        """Arm this rank's retained boundary state on the transfer fabric
        for ONE peer pull; returns the pull descriptor."""
        from ray_tpu_torch.train import elastic as _elastic

        el = self._ctx._elastic if self._ctx is not None else None
        if el is None:
            raise RuntimeError("no elastic state retained on this rank")
        return _elastic.snapshot_state(el["state"])

    def elastic_keep_local(self, boundary_index: int) -> bool:
        """Survivor-at-the-boundary fast path: stage the locally retained
        state for the next start_run — zero bytes moved."""
        el = self._ctx._elastic if self._ctx is not None else None
        if el is None or el["index"] != boundary_index:
            return False
        self._pending_elastic = dict(el)
        return True

    def elastic_hydrate(
        self,
        snapshots: dict,
        mode: str,
        new_rank: int,
        new_world: int,
        old_world: int,
        leaf_totals: Optional[list],
        boundary_index: int,
    ) -> bool:
        """Pull + reassemble this rank's boundary state from donor
        snapshots (see elastic.hydrate_state) and stage it for resume."""
        from ray_tpu_torch.train import elastic as _elastic

        state = _elastic.hydrate_state(
            {int(r): s for r, s in snapshots.items()},
            mode,
            new_rank,
            new_world,
            old_world,
            leaf_totals,
        )
        self._pending_elastic = {
            "state": state,
            "index": boundary_index,
            "layout": mode,
        }
        return True

    def resume_run(
        self,
        fn_payload: bytes,
        config: Optional[dict],
        context_spec: dict,
        latest_checkpoint_path: Optional[str],
    ) -> bool:
        """Restart the train fn after an elastic re-formation: same
        actor, new context at the new world size, the staged boundary
        state handed to the fn via ctx.get_elastic_state()."""
        if self._state == "running":
            raise RuntimeError("cannot resume a running worker")
        self._state = "idle"
        return self.start_run(
            fn_payload, config, context_spec, latest_checkpoint_path
        )


@dataclass
class WorkerInfo:
    actor: Any
    metadata: dict
    world_rank: int
    # Placement-group bundle this worker occupies (-1 = scheduled outside
    # the gang's pg). Elastic recruit() targets the free indices: the GCS
    # re-commits a preempted node's bundle onto healthy capacity, so the
    # reservation outlives the worker that died in it.
    bundle_index: int = -1


class WorkerGroup:
    """Creates, ranks, and tears down the gang of TrainWorker actors."""

    def __init__(self, workers: list, slice_pg=None, pg=None):
        self.workers = workers  # rank-ordered WorkerInfo
        self._slice_pg = slice_pg
        self._pg = pg

    @classmethod
    def create(cls, scaling: ScalingConfig, timeout: float = 120.0):
        slice_pg = None
        pg = None
        if scaling.use_tpu and scaling.topology:
            from ray_tpu_torch.core.errors import NotPortedError

            raise NotPortedError(
                f"TPU slice placement (SlicePlacementGroup, topology={scaling.topology!r})"
            )
        else:
            n = scaling.num_workers
            resources = dict(scaling.resources_per_worker or {})
            num_cpus = resources.pop("CPU", 1)
            bundle = {**resources, "CPU": num_cpus}
            from ray_tpu_torch.util.placement_group import placement_group

            pg = placement_group(
                [dict(bundle) for _ in range(n)],
                strategy=scaling.placement_strategy,
            )
            if not pg.wait(timeout):
                from ray_tpu_torch.util.placement_group import (
                    remove_placement_group,
                )

                remove_placement_group(pg)
                raise TimeoutError(
                    f"worker placement group ({n} x {bundle}, "
                    f"{scaling.placement_strategy}) not ready in {timeout}s"
                )
            actors = [
                TrainWorker.options(
                    num_cpus=num_cpus,
                    resources=resources,
                    placement_group=pg,
                    placement_group_bundle_index=i,
                ).remote()
                for i in range(n)
            ]
        try:
            metas = ray_tpu_torch.get(
                [a.get_metadata.remote() for a in actors], timeout=timeout
            )
        except Exception:
            # Don't leak the gang: a failed/slow worker must release the
            # slice/PG resources or every controller retry times out on them.
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # raylint: disable=RL006 -- slice rollback kill; worker already dead
                    pass
            if slice_pg is not None:
                slice_pg.shutdown()
            elif pg is not None:
                from ray_tpu_torch.util.placement_group import (
                    remove_placement_group,
                )

                remove_placement_group(pg)
            raise
        # Stable global ranks: sort by (slice name, in-slice worker id,
        # node id) — reference worker_group.py:791-825.
        order = sorted(
            range(n),
            key=lambda i: (
                metas[i]["slice_name"],
                metas[i]["tpu_worker_id"],
                metas[i]["node_id"],
            ),
        )
        infos = [
            WorkerInfo(
                actor=actors[i],
                metadata=metas[i],
                world_rank=r,
                bundle_index=i,
            )
            for r, i in enumerate(order)
        ]
        return cls(infos, slice_pg=slice_pg, pg=pg)

    def __len__(self):
        return len(self.workers)

    @property
    def actors(self) -> list:
        return [w.actor for w in self.workers]

    def reform(self, keep: list, joiners: list = ()) -> "WorkerGroup":
        """Elastic re-formation: survivors (``keep``) plus any hydrating
        ``joiners`` re-rank under the SAME stable sort the original
        creation used — so process-group ranks stay deterministic at the
        new world size — and ownership of the placement handles moves to
        the returned group. This object is left empty: the controller's
        teardown path shuts down whichever group is current, and the
        retired one must not double-kill the surviving actors."""
        members = list(keep) + list(joiners)
        order = sorted(
            range(len(members)),
            key=lambda i: (
                members[i].metadata["slice_name"],
                members[i].metadata["tpu_worker_id"],
                members[i].metadata["node_id"],
            ),
        )
        infos = [
            WorkerInfo(
                actor=members[i].actor,
                metadata=members[i].metadata,
                world_rank=r,
                bundle_index=members[i].bundle_index,
            )
            for r, i in enumerate(order)
        ]
        new = WorkerGroup(infos, slice_pg=self._slice_pg, pg=self._pg)
        self.workers = []
        self._slice_pg = None
        self._pg = None
        return new

    @staticmethod
    def recruit(
        scaling: ScalingConfig,
        count: int,
        timeout: float = 10.0,
        pg=None,
        occupied: tuple = (),
    ) -> list:
        """Try to create ``count`` replacement workers. The gang's
        placement group keeps reserving a bundle for each departed rank —
        the GCS re-commits a preempted node's bundles onto healthy
        capacity — so joiners target the free bundle indices first
        (``occupied`` lists the indices survivors still sit in) and only
        spill to plain resource scheduling once the reservation is
        exhausted. Without that, the rescheduled bundle and the joiner
        would COMPETE for the same CPUs and the join could never place.
        Returns [] (after killing any partial gang) when the cluster
        can't place them yet; the controller simply retries later."""
        resources = dict(scaling.resources_per_worker or {})
        num_cpus = resources.pop("CPU", 1)
        free = []
        if pg is not None:
            taken = set(occupied)
            free = [
                i for i in range(pg.bundle_count) if i not in taken
            ][:count]
        actors = []
        indices = []
        for idx in free:
            actors.append(
                TrainWorker.options(
                    num_cpus=num_cpus,
                    resources=resources,
                    placement_group=pg,
                    placement_group_bundle_index=idx,
                ).remote()
            )
            indices.append(idx)
        for _ in range(count - len(free)):
            actors.append(
                TrainWorker.options(
                    num_cpus=num_cpus, resources=resources
                ).remote()
            )
            indices.append(-1)
        try:
            metas = ray_tpu_torch.get(
                [a.get_metadata.remote() for a in actors], timeout=timeout
            )
        except Exception:  # raylint: disable=RL006 -- no capacity yet: kill the partial gang and let the controller retry next tick
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # raylint: disable=RL006 -- rollback kill; actor may never have scheduled
                    pass
            return []
        return [
            WorkerInfo(actor=a, metadata=m, world_rank=-1, bundle_index=i)
            for a, m, i in zip(actors, metas, indices)
        ]

    def collective_topology(self):
        """Two-level (slice → host) topology of this gang, derived from the
        slice identities the ranks were sorted by (one synthetic slice on
        the port's nodes). Ranks are slice-contiguous by construction, so
        this never raises the contiguity error."""
        from ray_tpu_torch.util.collective import topology as _topology

        return _topology.derive(
            [w.metadata.get("slice_name") or None for w in self.workers]
        )

    def context_specs(self, experiment_name, storage_path, num_to_keep=None):
        """Per-worker context dicts: local/node ranks derived from node_id
        grouping in rank order."""
        node_order: list[str] = []
        local_counts: dict[str, int] = {}
        topo = self.collective_topology()
        specs = []
        for w in self.workers:
            nid = w.metadata["node_id"]
            if nid not in node_order:
                node_order.append(nid)
            local_rank = local_counts.get(nid, 0)
            local_counts[nid] = local_rank + 1
            specs.append(
                {
                    "experiment_name": experiment_name,
                    "storage_path": storage_path,
                    "num_to_keep": num_to_keep,
                    "world_size": len(self.workers),
                    "world_rank": w.world_rank,
                    "local_rank": local_rank,
                    "node_rank": node_order.index(nid),
                    # Slice identity, as the reference gives it (one
                    # synthetic slice here).
                    "slice_name": w.metadata.get("slice_name", ""),
                    "slice_rank": topo.slice_index(w.world_rank),
                    "num_slices": topo.num_slices,
                }
            )
        for i, spec in enumerate(specs):
            spec["local_world_size"] = local_counts[
                self.workers[i].metadata["node_id"]
            ]
        return specs

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w.actor)
            except Exception:  # raylint: disable=RL006 -- group shutdown kill; worker already dead
                pass
        if self._slice_pg is not None:
            try:
                self._slice_pg.shutdown()
            except Exception:  # raylint: disable=RL006 -- slice pg teardown; bundles freed with their nodes
                pass
        elif self._pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # raylint: disable=RL006 -- pg remove during shutdown; GCS may already have dropped it
                pass
        self.workers = []
