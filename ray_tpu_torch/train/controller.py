"""TrainController — drives the worker group through the run state machine.
Port of ``ray_tpu/train/controller.py`` (the state machine, the failure
policy and the elastic shrink, grow, reshard and fallback paths, copied).

Reference parity: python/ray/train/v2/_internal/execution/controller/
controller.py:103 (TrainController; async run loop :542 with
INITIALIZING→SCHEDULING→RUNNING→[RESTARTING|ERRORED|FINISHED] transitions,
ScalingPolicy/FailurePolicy). Here the loop runs in the fit() process and
polls worker status; a worker failure tears the group down and rebuilds it,
resuming from the latest persisted checkpoint, until FailureConfig.
max_failures is exhausted.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.storage import StorageContext
from ray_tpu_torch.train.worker_group import WorkerGroup

INITIALIZING = "INITIALIZING"
SCHEDULING = "SCHEDULING"
RUNNING = "RUNNING"
RESHAPING = "RESHAPING"  # elastic live re-formation (between RUNNING and
#                          the RESTARTING rebuild-from-checkpoint fallback)
RESTARTING = "RESTARTING"
ERRORED = "ERRORED"
FINISHED = "FINISHED"

POLL_INTERVAL_S = 0.2


@dataclass
class Result:
    """What fit() returns (reference: ray.train.Result)."""

    metrics: Optional[dict]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[Exception] = None
    metrics_history: list = field(default_factory=list)


class TrainingFailedError(RuntimeError):
    pass


class TrainController:
    def __init__(
        self,
        train_fn: Callable,
        train_loop_config: Optional[dict],
        scaling_config: ScalingConfig,
        run_config: RunConfig,
        backend_config: BackendConfig,
    ):
        # Keep the callable itself alive too: the closure may be the only
        # holder of ObjectRefs (e.g. materialized dataset blocks) — dropping
        # it after pickling would let this process free those objects while
        # workers still need them.
        self._train_fn = train_fn
        self._fn_payload = cloudpickle.dumps(train_fn)
        self._config = train_loop_config
        self._scaling = scaling_config
        self._run = run_config
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()()
        self._state = INITIALIZING
        self._experiment = run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        # Controller-side storage view (workers persist; we resolve latest).
        self._storage = StorageContext(run_config.storage_path, self._experiment)
        self._metrics_history: list[dict] = []
        self._latest_metrics: Optional[dict] = None
        # index -> {"ranks": set, "has_ckpt": bool} for in-flight report
        # rounds (checkpoint commit protocol, see _record_report)
        self._report_rounds: dict[int, dict] = {}
        # Elastic plane: the group currently owning the worker actors
        # (reshapes retire the old WorkerGroup object without killing the
        # surviving actors; teardown targets whichever group is current).
        self._active_group: Optional[WorkerGroup] = None
        # Recovery probe (elastic.last_recovery_ms): drain-notice
        # timestamp, stamped when the first post-recovery report lands —
        # on the elastic path AND the checkpoint-restore fallback, so the
        # --no-elastic arm measures the same interval.
        self._recover_t0: Optional[float] = None
        self._recover_resumed = False

    @property
    def state(self) -> str:
        return self._state

    def run(self) -> Result:
        max_failures = self._run.failure_config.max_failures
        failures = 0
        last_error: Optional[str] = None
        while True:
            self._state = SCHEDULING
            # Group build and backend bootstrap failures count against the
            # failure policy too (transient resource shortages / rendezvous
            # hiccups during a restart must not abort a retryable run).
            group = None
            try:
                group = WorkerGroup.create(self._scaling)
                self._active_group = group
                self._backend.on_start(group, self._backend_config)
                outcome, error = self._run_once(group)
            except Exception as e:  # noqa: BLE001
                outcome, error = "failed", f"{type(e).__name__}: {e}"
            finally:
                # A reshape may have retired the group this generation
                # started with; tear down whichever group is current.
                current = self._active_group or group
                self._active_group = None
                if current is not None:
                    try:
                        self._backend.on_shutdown(
                            current, self._backend_config
                        )
                    finally:
                        current.shutdown()
            if outcome == "finished":
                self._state = FINISHED
                return Result(
                    metrics=self._latest_metrics,
                    checkpoint=self._storage.latest_checkpoint(),
                    path=self._storage.experiment_dir,
                    metrics_history=self._metrics_history,
                )
            if outcome == "preempted":
                # A worker node is DRAINING (preemption notice): the gang
                # was torn down with its latest checkpoint round drained,
                # and rebuilds on healthy nodes (placement skips draining
                # views). Expected lifecycle on preemptible VMs — it
                # does NOT burn the max_failures budget.
                self._state = RESTARTING
                continue
            last_error = error
            failures += 1
            if max_failures != -1 and failures > max_failures:
                self._state = ERRORED
                return Result(
                    metrics=self._latest_metrics,
                    checkpoint=self._storage.latest_checkpoint(),
                    path=self._storage.experiment_dir,
                    error=TrainingFailedError(
                        f"training failed after {failures} failure(s); "
                        f"last error:\n{error}"
                    ),
                    metrics_history=self._metrics_history,
                )
            self._state = RESTARTING

    def _run_once(self, group: WorkerGroup) -> tuple[str, Optional[str]]:
        """One worker-group generation. Returns ("finished", None) or
        ("failed", error). An elastic reshape swaps ``group`` in place
        (same generation — no failure burn, no checkpoint restore)."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG
        from ray_tpu_torch.train import elastic as _elastic

        self._report_rounds.clear()  # rounds never span generations
        self._storage.prune_incomplete()
        latest = self._storage.latest_checkpoint()
        start_index = 0
        if latest is not None:
            # .../checkpoint_000004 → next report index is 5.
            start_index = int(latest.path.rsplit("_", 1)[-1]) + 1
        specs = group.context_specs(
            self._experiment,
            self._run.storage_path,
            num_to_keep=self._run.checkpoint_config.num_to_keep,
        )
        for spec in specs:
            spec["start_report_index"] = start_index
        start_refs = [
            w.actor.start_run.remote(
                self._fn_payload,
                self._config,
                spec,
                latest.path if latest else None,
            )
            for w, spec in zip(group.workers, specs)
        ]
        try:
            ray_tpu_torch.get(start_refs, timeout=120)
        except Exception as e:  # noqa: BLE001  # raylint: disable=RL006 -- failure verdict returned to the caller with the error string
            return "failed", f"worker start failed: {e!r}"
        if self._recover_t0 is not None:
            # Checkpoint-restore fallback arm of the recovery probe: the
            # rebuilt gang is up; the next recorded report closes the
            # preempt-to-first-step interval.
            self._recover_resumed = True
        self._state = RUNNING
        _elastic.set_world_size(len(group))
        done = [False] * len(group)
        last_drain_check = 0.0
        last_grow_check = time.monotonic()
        while True:
            try:
                statuses = ray_tpu_torch.get(
                    [
                        w.actor.status.remote()
                        for i, w in enumerate(group.workers)
                        if not done[i]
                    ],
                    timeout=60,
                )
            except Exception as e:  # noqa: BLE001  # raylint: disable=RL006 -- failure verdict returned to the caller with the error string
                return "failed", f"lost contact with workers: {e!r}"
            live = [i for i in range(len(group)) if not done[i]]
            failure: Optional[str] = None
            for i, st in zip(live, statuses):
                for rep in st["reports"]:
                    self._record_report(rep, len(group))
                if st["state"] == "failed":
                    failure = st["error"]
                if st["state"] == "finished":
                    done[i] = True
            # Preemption-aware: a DRAINING worker node means this gang is
            # about to lose a rank. Drain the buffered reports (so the
            # just-persisted checkpoint round finalizes) and rebuild NOW,
            # while the checkpoint storage is intact — instead of letting
            # the node's death surface as a mid-collective failure.
            now = time.monotonic()
            if now - last_drain_check >= 1.0:
                last_drain_check = now
                draining = self._draining_worker_nodes(group)
                if draining:
                    if self._recover_t0 is None:
                        self._recover_t0 = time.monotonic()
                        self._recover_resumed = False
                    if GLOBAL_CONFIG.elastic_train:
                        # Elastic path: survivors pause at their next step
                        # boundary, reshard state peer-to-peer, and resume
                        # at the smaller world size — same generation, no
                        # checkpoint-storage read, no max_failures burn.
                        self._state = RESHAPING
                        new_group = self._attempt_shrink(group, done, draining)
                        if new_group is not None:
                            group = new_group
                            self._active_group = group
                            _elastic.set_world_size(len(group))
                            done = [False] * len(group)
                            self._state = RUNNING
                            last_grow_check = time.monotonic()
                            continue
                        _elastic.count_reshape("fallback")
                    self._drain_reports(group, done)
                    return "preempted", (
                        f"worker node {draining[0][:8]} is draining "
                        f"(preemption notice); rebuilding on healthy nodes "
                        f"from the latest checkpoint"
                    )
                elif (
                    GLOBAL_CONFIG.elastic_train
                    and GLOBAL_CONFIG.elastic_grow_check_s > 0
                    # TPU configs leave num_workers None (the slice
                    # topology is the membership); grow never applies.
                    and self._scaling.num_workers is not None
                    and len(group) < self._scaling.num_workers
                    and now - last_grow_check
                    >= GLOBAL_CONFIG.elastic_grow_check_s
                    and not any(done)
                ):
                    last_grow_check = now
                    self._state = RESHAPING
                    grown = self._attempt_grow(group, done)
                    self._state = RUNNING
                    if isinstance(grown, WorkerGroup):
                        group = grown
                        self._active_group = group
                        _elastic.set_world_size(len(group))
                        done = [False] * len(group)
                        continue
                    if grown == "wedged":
                        # The gang paused for the join but could not be
                        # resumed in place: rebuild from the latest
                        # checkpoint. Not the workers' fault — no burn.
                        self._drain_reports(group, done)
                        return "preempted", (
                            "elastic grow left the gang paused; rebuilding "
                            "from the latest checkpoint"
                        )
            if failure is not None:
                # Drain the surviving ranks' buffered reports before the
                # teardown: a checkpoint round only finalizes once EVERY
                # rank's report arrived, and under load a surviving rank
                # may not have reported the round rank 0 just persisted —
                # without the drain, restore would fall back a full
                # generation (or to scratch) and burn max_failures.
                self._drain_reports(group, done)
                return "failed", failure
            if all(done):
                return "finished", None
            time.sleep(POLL_INTERVAL_S)

    @staticmethod
    def _draining_worker_nodes(group: WorkerGroup) -> list:
        """Node ids of gang members whose host node is DRAINING (graceful
        drain / preemption notice). Rides the CoreWorker's 1s-cached
        cluster view — no dedicated RPC per poll tick. Best-effort: a GCS
        hiccup reports nothing and the next check retries."""
        try:
            from ray_tpu_torch.core import api as core_api

            worker = core_api._require_worker()
            view = worker.endpoint.submit(worker._cluster_view()).result(
                timeout=10
            )
        except Exception:  # raylint: disable=RL006 -- cluster-view probe; no view means no drain verdicts this tick
            return []
        draining = {nid for nid, v in view.items() if v.get("draining")}
        if not draining:
            return []
        return sorted(
            {
                w.metadata["node_id"]
                for w in group.workers
                if w.metadata["node_id"] in draining
            }
        )

    def _drain_reports(
        self, group: WorkerGroup, done: list, timeout_s: float = 3.0
    ) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            pending = [
                i
                for i, d in enumerate(done)
                if not d and i < len(group)
            ]
            if not pending:
                return
            try:
                statuses = ray_tpu_torch.get(
                    [group.workers[i].actor.status.remote() for i in pending],
                    timeout=timeout_s,
                )
            except Exception:  # raylint: disable=RL006 -- status poll failed: controller restart path takes over
                return
            progressed = False
            for i, st in zip(pending, statuses):
                for rep in st["reports"]:
                    self._record_report(rep, len(group))
                    progressed = True
                if st["state"] in ("finished", "failed"):
                    done[i] = True
            if not progressed and all(
                st["state"] != "running" for st in statuses
            ):
                return
            time.sleep(0.1)

    # -- elastic re-formation ------------------------------------------------

    @staticmethod
    def _rank_key(w):
        return (
            w.metadata["slice_name"],
            w.metadata["tpu_worker_id"],
            w.metadata["node_id"],
        )

    def _pause_group(self, group: WorkerGroup, done: list) -> bool:
        """Arm the step-boundary pause on every rank and wait until the
        whole gang is parked. Reports drained while waiting still feed the
        checkpoint-commit protocol (a round at the boundary must finalize
        before anyone reshards). False on timeout, a failed rank, or a
        rank that finished (a finished rank's boundary state is gone —
        the caller falls back)."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        try:
            ray_tpu_torch.get(
                [w.actor.request_pause.remote() for w in group.workers],
                timeout=10,
            )
        except Exception:  # raylint: disable=RL006 -- pause arm failed: caller falls back to checkpoint restore
            return False
        deadline = time.monotonic() + GLOBAL_CONFIG.elastic_pause_timeout_s
        while time.monotonic() < deadline:
            try:
                statuses = ray_tpu_torch.get(
                    [w.actor.status.remote() for w in group.workers],
                    timeout=30,
                )
            except Exception:  # raylint: disable=RL006 -- status poll failed mid-pause: caller falls back
                return False
            for st in statuses:
                for rep in st["reports"]:
                    self._record_report(rep, len(group))
            states = [st["state"] for st in statuses]
            if any(s in ("failed", "finished") for s in states):
                return False
            if all(s == "paused" for s in states):
                return True
            time.sleep(0.05)
        return False

    def _attempt_shrink(
        self, group: WorkerGroup, done: list, draining: list
    ) -> Optional[WorkerGroup]:
        """Live shrink: pause the gang at its step boundary, reshard the
        boundary state peer-to-peer onto the survivors, re-form the process
        group at the smaller world size, and resume. Returns the new
        group, or None to fall back to the checkpoint-restore path (the
        caller then tears the generation down as \"preempted\" — still no
        failure burn). Draining nodes keep serving pulls as donors until
        hydration lands; their actors are killed only afterwards."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG
        from ray_tpu_torch.train import elastic as _elastic

        try:
            gone = set(draining)
            survivors = [
                w
                for w in group.workers
                if w.metadata["node_id"] not in gone
            ]
            victims = [
                w for w in group.workers if w.metadata["node_id"] in gone
            ]
            if not victims or any(done):
                return None
            if len(survivors) < max(1, GLOBAL_CONFIG.elastic_min_world_size):
                return None
            # Capability probe BEFORE pausing: a train fn that never
            # reported elastic_state can't reshard — don't disturb it.
            metas = ray_tpu_torch.get(
                [w.actor.elastic_meta.remote() for w in group.workers],
                timeout=10,
            )
            if any(m["index"] is None for m in metas):
                return None
            layouts = {m.get("layout", _elastic.REPLICATED) for m in metas}
            if len(layouts) != 1:
                return None
            layout = layouts.pop()
            if not self._pause_group(group, done):
                return None
            # Re-read at the pause point: indices advanced since the probe.
            metas = ray_tpu_torch.get(
                [w.actor.elastic_meta.remote() for w in group.workers],
                timeout=10,
            )
            indices = [m["index"] for m in metas]
            if any(i is None for i in indices):
                return None
            boundary = max(indices)
            if layout == _elastic.SHARDED and any(
                i != boundary for i in indices
            ):
                # Each rank holds a distinct shard: resharding from mixed
                # step boundaries would stitch state from different steps.
                return None
            return self._reshard_and_resume(
                group, survivors, victims, metas, layout, boundary, "shrink"
            )
        except Exception:  # raylint: disable=RL006 -- any reshape failure falls back to the checkpoint-restore path
            return None

    def _reshard_and_resume(
        self,
        group: WorkerGroup,
        survivors: list,
        victims: list,
        metas: list,
        layout: str,
        boundary: int,
        kind: str,
        joiners: list = (),
    ) -> Optional[WorkerGroup]:
        """Move the boundary state to where the new ranks need it and
        restart the train fns at the new world size. ``metas`` aligns
        with ``group.workers`` (the OLD gang — every old rank, survivor
        or victim, can serve donor pulls)."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG
        from ray_tpu_torch.train import elastic as _elastic

        old_world = len(group)
        donor_by_old_rank = {w.world_rank: w for w in group.workers}
        meta_by_old_rank = {
            w.world_rank: m for w, m in zip(group.workers, metas)
        }
        members = sorted(
            list(survivors) + list(joiners), key=self._rank_key
        )
        new_world = len(members)
        # Global per-leaf dim0 lengths for the sharded planner: sum of the
        # boundary ranks' local lengths; None marks a replicated/0-d leaf.
        leaf_totals = None
        if layout == _elastic.SHARDED:
            rows = [meta_by_old_rank[r]["leaf_rows"] for r in range(old_world)]
            leaf_totals = [
                (None if rows[0][li] is None else sum(rk[li] for rk in rows))
                for li in range(len(rows[0]))
            ]
        boundary_donors = [
            r for r in range(old_world)
            if meta_by_old_rank[r]["index"] == boundary
        ]
        survivor_old_ranks = {id(w): w.world_rank for w in survivors}
        hydr_refs = []
        reshard_timeout = GLOBAL_CONFIG.elastic_reshard_timeout_s
        for new_rank, w in enumerate(members):
            old_rank = survivor_old_ranks.get(id(w))  # None for joiners
            if layout == _elastic.REPLICATED:
                if (
                    old_rank is not None
                    and meta_by_old_rank[old_rank]["index"] == boundary
                ):
                    # Survivor already at the boundary: zero bytes moved.
                    hydr_refs.append(
                        w.actor.elastic_keep_local.remote(boundary)
                    )
                    continue
                donor_rank = boundary_donors[new_rank % len(boundary_donors)]
                snap = ray_tpu_torch.get(
                    donor_by_old_rank[donor_rank]
                    .actor.elastic_snapshot.remote(),
                    timeout=reshard_timeout,
                )
                snaps = {donor_rank: snap}
            else:
                need = set()
                for li, total in enumerate(leaf_totals):
                    if total is None:
                        continue
                    for r, _s, _e in _elastic.plan_reshard(
                        int(total), old_world, new_world
                    )[new_rank]:
                        need.add(r)
                if not need:  # every leaf replicated under a sharded label
                    need = {boundary_donors[0]}
                snaps = {
                    r: ray_tpu_torch.get(
                        donor_by_old_rank[r].actor.elastic_snapshot.remote(),
                        timeout=reshard_timeout,
                    )
                    for r in sorted(need)
                }
            hydr_refs.append(
                w.actor.elastic_hydrate.remote(
                    snaps,
                    layout,
                    new_rank,
                    new_world,
                    old_world,
                    leaf_totals,
                    boundary,
                )
            )
        if not all(ray_tpu_torch.get(hydr_refs, timeout=reshard_timeout)):
            return None
        new_group = group.reform(survivors, joiners)
        # From here the surviving actors belong to new_group: point the
        # teardown path at it so a late failure can't strand them.
        self._active_group = new_group
        self._backend.on_reshape(new_group, self._backend_config)
        for v in victims:
            try:
                ray_tpu_torch.kill(v.actor)
            except Exception:  # raylint: disable=RL006 -- victim is on a draining node; it dies with the node anyway
                pass
        latest = self._storage.latest_checkpoint()
        specs = new_group.context_specs(
            self._experiment,
            self._run.storage_path,
            num_to_keep=self._run.checkpoint_config.num_to_keep,
        )
        for spec in specs:
            spec["start_report_index"] = boundary + 1
        ray_tpu_torch.get(
            [
                w.actor.resume_run.remote(
                    self._fn_payload,
                    self._config,
                    spec,
                    latest.path if latest else None,
                )
                for w, spec in zip(new_group.workers, specs)
            ],
            timeout=120,
        )
        # Rounds at or before the boundary can never complete now (no rank
        # will report those indices again) — drop them so the dict doesn't
        # accrete across reshapes.
        for idx in [i for i in self._report_rounds if i <= boundary]:
            del self._report_rounds[idx]
        _elastic.count_reshape(kind)
        self._recover_resumed = True
        return new_group

    def _resume_in_place(self, group: WorkerGroup) -> bool:
        """Abandon a reshape after the gang already paused: resume every
        rank at its OWN boundary with its own retained state — the step
        stream continues exactly as if the pause never happened."""
        if not group.workers:
            return False
        try:
            metas = ray_tpu_torch.get(
                [w.actor.elastic_meta.remote() for w in group.workers],
                timeout=10,
            )
            if any(m["index"] is None for m in metas):
                return False
            keeps = ray_tpu_torch.get(
                [
                    w.actor.elastic_keep_local.remote(m["index"])
                    for w, m in zip(group.workers, metas)
                ],
                timeout=10,
            )
            if not all(keeps):
                return False
            latest = self._storage.latest_checkpoint()
            specs = group.context_specs(
                self._experiment,
                self._run.storage_path,
                num_to_keep=self._run.checkpoint_config.num_to_keep,
            )
            for spec, m in zip(specs, metas):
                spec["start_report_index"] = m["index"] + 1
            ray_tpu_torch.get(
                [
                    w.actor.resume_run.remote(
                        self._fn_payload,
                        self._config,
                        spec,
                        latest.path if latest else None,
                    )
                    for w, spec in zip(group.workers, specs)
                ],
                timeout=120,
            )
            return True
        except Exception:  # raylint: disable=RL006 -- in-place resume failed: caller tears the generation down
            return False

    def _attempt_grow(self, group: WorkerGroup, done: list):
        """Scale-up at a step boundary: recruit replacement workers on
        whatever healthy capacity exists, pause the gang, hydrate the
        joiners from peers, and resume at the larger world size. Returns
        the new WorkerGroup, None (nothing to do / clean bail before the
        pause), or \"wedged\" (the gang paused but could not be resumed —
        the caller rebuilds from checkpoint, without failure burn)."""
        from ray_tpu_torch.train import elastic as _elastic

        if group._slice_pg is not None:
            # TPU slice gangs are fixed-shape: the slice placement group's
            # bundles are the membership. Grow applies to CPU/GPU gangs.
            return None
        joiners = []
        try:
            metas = ray_tpu_torch.get(
                [w.actor.elastic_meta.remote() for w in group.workers],
                timeout=10,
            )
            if any(m["index"] is None for m in metas):
                return None
            layouts = {m.get("layout", _elastic.REPLICATED) for m in metas}
            if len(layouts) != 1:
                return None
            layout = layouts.pop()
            want = self._scaling.num_workers - len(group)
            joiners = WorkerGroup.recruit(
                self._scaling,
                want,
                pg=group._pg,
                occupied=tuple(
                    w.bundle_index for w in group.workers
                ),
            )
            if not joiners:
                return None
            if not self._pause_group(group, done):
                self._kill_joiners(joiners)
                return "wedged"
            metas = ray_tpu_torch.get(
                [w.actor.elastic_meta.remote() for w in group.workers],
                timeout=10,
            )
            indices = [m["index"] for m in metas]
            if any(i is None for i in indices):
                self._kill_joiners(joiners)
                return (
                    None if self._resume_in_place(group) else "wedged"
                )
            boundary = max(indices)
            if layout == _elastic.SHARDED and any(
                i != boundary for i in indices
            ):
                self._kill_joiners(joiners)
                return (
                    None if self._resume_in_place(group) else "wedged"
                )
            new_group = self._reshard_and_resume(
                group,
                list(group.workers),
                [],
                metas,
                layout,
                boundary,
                "grow",
                joiners=joiners,
            )
            if new_group is None:
                self._kill_joiners(joiners)
                return (
                    None if self._resume_in_place(group) else "wedged"
                )
            return new_group
        except Exception:  # raylint: disable=RL006 -- grow is opportunistic; a failed attempt resumes in place or falls back
            self._kill_joiners(joiners)
            try:
                if self._resume_in_place(group):
                    return None
            except Exception:  # raylint: disable=RL006 -- double fault: fall through to the wedged teardown
                pass
            return "wedged"

    @staticmethod
    def _kill_joiners(joiners: list) -> None:
        for j in joiners:
            try:
                ray_tpu_torch.kill(j.actor)
            except Exception:  # raylint: disable=RL006 -- rollback kill; joiner may already be gone
                pass

    def _record_report(self, rep: dict, world_size: int) -> None:
        if self._recover_t0 is not None and self._recover_resumed:
            # First report after a membership-change recovery — elastic
            # resume or checkpoint-restore fallback alike — closes the
            # elastic.last_recovery_ms interval.
            from ray_tpu_torch.train import elastic as _elastic

            _elastic.record_recovery_ms(
                (time.monotonic() - self._recover_t0) * 1000.0
            )
            self._recover_t0 = None
            self._recover_resumed = False
        if rep["world_rank"] == 0:
            self._latest_metrics = rep["metrics"]
            self._metrics_history.append(rep["metrics"])
        # Controller-side checkpoint commit: once every rank's report for
        # this index arrived (so no rank is still merging shard files into
        # the dir) and at least one rank persisted, stamp `.complete` —
        # only then does latest_checkpoint() surface it for restore.
        idx = rep["index"]
        round_ = self._report_rounds.setdefault(
            idx, {"ranks": set(), "has_ckpt": False}
        )
        round_["ranks"].add(rep["world_rank"])
        if rep.get("checkpoint_path"):
            round_["has_ckpt"] = True
        if len(round_["ranks"]) >= world_size and round_["has_ckpt"]:
            self._storage.finalize_checkpoint(idx)
            del self._report_rounds[idx]
