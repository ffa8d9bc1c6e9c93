"""Runtime configuration, overridable via RAY_TPU_<NAME> env vars. Port of
``ray_tpu/core/config.py``.

Equivalent of the reference's RAY_CONFIG flag table
(reference: src/ray/common/ray_config_def.h:22) — a single typed table,
env-overridable per process, with head-chosen values shipped to every node
through the GCS internal config KV so the cluster is consistent.

The port's table holds the fields its modules read, with the reference's
names, defaults and ``RAY_TPU_<NAME>`` parsing: the core runtime's knobs,
the telemetry switches (``metrics_enabled``, ``flightrec*``,
``tracing_enabled``), ``spec_decode``, the serve tier's ``prefix_routing*``,
``admission``, ``disagg`` and ``serve_*`` knobs, ``faults`` (parsed at import by
:mod:`ray_tpu_torch.core.faults`), ``xfer_armed_cap`` (the transfer
fabric's armed-entry cap, which device objects' arms ride), the data
tier's ``data_*`` knobs and the train tier's ``storage_path``, ``train_*``
and ``elastic_*`` knobs. As in the reference, device objects' fabric
switch ``RAY_TPU_RDT_FABRIC`` (``0``: every fetch takes the host path) is
read from the environment at each fetch, not from this table. Tests flip
a field on ``GLOBAL_CONFIG`` and restore it.
"""

from __future__ import annotations

import dataclasses
import json
import os


def _env(name: str, default):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    return t(raw)


@dataclasses.dataclass
class Config:
    # Objects smaller than this are stored inline in the owner's memory store
    # and travel inside RPC replies; larger ones go to shared memory.
    max_inline_object_bytes: int = 1024 * 1024
    # Per-node shared-memory object store capacity.
    object_store_bytes: int = 2 * 1024 * 1024 * 1024
    # Chunk size for node-to-node object transfer.
    object_transfer_chunk_bytes: int = 8 * 1024 * 1024
    # Verify node-to-node transfers with a native FNV-1a fingerprint
    # (opt-in: trades ~1 GB/s of hashing per side for corruption detection).
    verify_transfers: bool = False
    # Transfer admission control (reference: push_manager.h chunk in-flight
    # caps + pull_manager.h admission): max object-chunk requests a node
    # SERVES concurrently (a 50-node broadcast must queue here, not
    # stampede), and max distinct objects a node PULLS concurrently.
    object_serve_concurrency: int = 8
    object_pull_concurrency: int = 4
    # Per-chunk transfer deadline: generous for an 8 MiB chunk on a loaded
    # source (admission-queued serves included), but bounded so a wedged
    # source can't pin a pull slot forever.
    object_chunk_timeout_s: float = 120.0
    # Opt-in cgroup isolation for spawned workers (reference:
    # cgroup_manager.h behind a feature flag): each worker gets its own
    # cgroup under raytpu_<session>/. Not ported yet: on, a node raises.
    enable_worker_cgroups: bool = False
    # Worker pool (reference: worker_pool.h maximum_startup_concurrency +
    # idle worker killing). max_worker_processes caps TASK workers per node
    # (0 = auto: max(4, 2 * host cores)); actors bypass the cap (they hold
    # workers for their lifetime). Idle workers above the min_idle_workers
    # warm floor are reaped after idle_worker_ttl_s.
    min_idle_workers: int = 1
    worker_start_timeout_s: float = 60.0
    max_worker_processes: int = 0
    idle_worker_ttl_s: float = 120.0
    # Scheduling
    lease_request_timeout_s: float = 60.0
    resource_report_interval_s: float = 0.2
    # Health
    worker_poll_interval_s: float = 0.5
    node_heartbeat_interval_s: float = 1.0
    node_death_timeout_s: float = 10.0
    # Task defaults
    default_max_retries: int = 3
    # Lineage reconstruction: resubmissions of a producing task whose output
    # was lost (reference: task resubmit in task_manager.h:229)
    max_lineage_attempts: int = 3
    # RPC
    rpc_connect_timeout_s: float = 30.0
    # RPC survival semantics (robustness round). Every acall/call carries a
    # per-call deadline: a hung or partitioned peer fails the call with
    # DeadlineExceededError instead of wedging the caller forever.
    # rpc_deadline_s is the control-plane default; heartbeat / data-plane /
    # slow (lease + actor-start, bounded by their own server-side timeouts)
    # classes override it per method (protocol.method_deadline_s), and RPCs
    # whose reply is the completion of arbitrarily long user work (task
    # pushes, owner get/wait, wait_actor_alive, whole-object pulls) are
    # exempt — their lifetime belongs to the task layer, and worker death
    # still surfaces as ConnectionLost. <= 0 disables all deadlines.
    rpc_deadline_s: float = 30.0
    rpc_heartbeat_deadline_s: float = 5.0
    rpc_data_deadline_s: float = 120.0
    rpc_slow_deadline_s: float = 90.0
    # Endpoint.start() boot wait (was a hard-coded 30 in protocol.py).
    endpoint_start_timeout_s: float = 30.0
    # Automatic retry with jittered exponential backoff, ONLY for methods
    # on the explicit idempotency allowlist (protocol.IDEMPOTENT_RPCS:
    # lease requests, heartbeats, location lookups, chunk fetches — never
    # task pushes), and ONLY on transport errors (connection loss,
    # deadline), never on application exceptions.
    rpc_max_retries: int = 3
    rpc_retry_backoff_s: float = 0.05
    rpc_retry_backoff_max_s: float = 2.0
    # Per-peer circuit breaker: after N consecutive transport failures,
    # calls to the peer fail fast (PeerUnavailableError) instead of each
    # burning a full deadline; after rpc_breaker_reset_s the breaker
    # half-opens and one probe call is let through. Schedulers treat a
    # tripped peer as SUSPECT — no new leases or spills are directed at it
    # until the breaker closes — rather than surfacing an error storm.
    rpc_breaker_threshold: int = 5
    rpc_breaker_reset_s: float = 5.0
    # Transport-level frame coalescing (PERF.md round-5 ceiling probe: the
    # driver core is consumed by one write()+event-loop-wakeup pair per RPC
    # frame). Outgoing frames queue per connection and one loop callback
    # concatenates them into a single write(); the caps bound frames and
    # bytes per write. The kill switch restores one-write-per-frame (and
    # disables the message-level lease/completion batches riding on it).
    rpc_coalesce_enabled: bool = True
    rpc_coalesce_max_frames: int = 64
    rpc_coalesce_max_bytes: int = 1024 * 1024
    # Scatter-gather data plane (PERF.md round-8): RPC frames carrying
    # large buffers (FramedPayload values, numpy args/results) are encoded
    # as a small pickled envelope plus out-of-band segments that go to the
    # socket as separate writes — the payload bytes are never flattened
    # into an intermediate ``bytes`` on the send side. The kill switch
    # restores in-band pickling and the join-based flush.
    rpc_scatter_gather_enabled: bool = True
    # Contiguous buffers at least this large stay out-of-band in
    # serialization.dumps_oob AND in the frame encoder; smaller ones are
    # pickled in-band (framing overhead beats the copy win).
    oob_min_buffer_bytes: int = 4096
    # Prefix-affinity serve routing. prefix_routing is the kill switch
    # (RAY_TPU_PREFIX_ROUTING=0): off, routers never consult replica
    # prefix-pool digests or fetch replica state — pow-2 plus the
    # router-local prompt-prefix affinity table runs untouched.
    # prefix_route_staleness_s bounds how old a router's replica-digest
    # table may get before a background refresh fires — routing NEVER
    # blocks on the control plane; within the window it uses whatever it
    # has (a stale digest costs at most one avoidable re-prefill).
    prefix_routing: bool = True
    prefix_route_staleness_s: float = 2.0
    # Serve overload protection. ``admission`` is the kill switch
    # (RAY_TPU_ADMISSION=0): off, routing tables carry no admission/shed
    # state, routers never consult tenant buckets or shed levels, and
    # replicas accept work exactly as without this tier. The plane itself
    # is per-deployment OPT-IN (DeploymentConfig.admission_config); these
    # knobs are the cluster defaults an admission_config inherits where it
    # leaves fields unset.
    admission: bool = True
    # Disaggregated LLM serving. ``disagg`` is the kill switch
    # (RAY_TPU_DISAGG=0): off, the serve controller advertises no replica
    # roles and routers never run the prefill->decode two-hop — unified
    # serving, byte-identical. The plane itself is per-deployment OPT-IN
    # (build_openai_app prefill_replicas > 0) and requires the paged KV
    # cache (handoffs ship pool blocks over the transfer fabric).
    disagg: bool = True
    # Speculative-decoding kill switch (RAY_TPU_SPEC_DECODE=0): off, an
    # engine builds no draft model and every step is the vanilla one.
    spec_decode: bool = True
    # Default per-replica concurrency budget: the router's saturation-spill
    # margin and the replica actor's max_concurrency derive from it.
    serve_max_concurrent: int = 8
    # Bounded replica queue: an admission-enabled replica fails a request
    # fast (OverloadedError, reason="queue_full") once its in-flight count
    # reaches max_concurrent_queries * this factor, instead of queuing
    # without limit. The router retries exactly once against a different
    # replica, then sheds. <= 0 disables the bound even for
    # admission-enabled deployments.
    serve_queue_cap_factor: float = 2.0
    # Load-shed watermarks (admission_config defaults): shed level RISES
    # when the deployment's mean per-replica queue depth crosses
    # queue_high (or rolling TTFT crosses ttft_high_ms, where replicas
    # advertise one), and FALLS one level only after the signals sit
    # below the low watermarks for a hold period — hysteresis, so the
    # shed state cannot flap at the boundary. ttft 0 = that signal off.
    serve_shed_queue_high: float = 8.0
    serve_shed_queue_low: float = 3.0
    serve_shed_ttft_high_ms: float = 0.0
    serve_shed_ttft_low_ms: float = 0.0
    # Tenant-key contract: the request header (HTTP, lower-cased) the
    # ingress/router derives the admission tenant from; absent header =
    # the "default" tenant bucket. gRPC callers pass "tenant" in the call
    # envelope instead.
    serve_tenant_header: str = "x-raytpu-tenant"
    # Graceful node drain (reference: gcs_service.proto DrainNode + the
    # raylet's graceful-drain deadline). A draining node stops taking new
    # leases, migrates its sole-copy (primary) objects to healthy peers,
    # asks the GCS to restart its restartable actors elsewhere, and lets
    # running tasks finish — all inside this grace window. On expiry the
    # GCS falls back to the immediate mark-dead path (post-mortem lineage
    # reconstruction). 0 disables graceful drain: drain_node() and SIGTERM
    # kill immediately, exactly the pre-drain behavior.
    drain_grace_s: float = 30.0
    # Memory monitor (reference: memory_monitor.h:52 +
    # worker_killing_policy.h:33): when the node's memory usage fraction
    # exceeds the threshold, the newest leased task worker is killed (its
    # task retries elsewhere). <= 0 disables.
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_s: float = 1.0
    # GCS fault tolerance: non-empty -> sqlite-backed durable GCS tables at
    # this path (reference: RAY_external_storage_namespace + redis FT).
    gcs_storage_path: str = ""
    # Observability (reference: task_event_buffer.h flush loop +
    # gcs_task_manager.h bounded store; log_monitor.py tail interval)
    task_event_flush_interval_s: float = 1.0
    task_events_max: int = 10000
    # False disables task-event recording entirely (the ~0.1 ms/call
    # observability tax on the submit path; timeline/state API lose task
    # rows). RAY_TPU_TASK_EVENTS_ENABLED=0 to turn off.
    task_events_enabled: bool = True
    # Runtime telemetry kill switch (RAY_TPU_METRICS_ENABLED=0): disables
    # every hot-layer instrumentation site (RPC method histograms, loop-lag
    # probe, scheduler/serve/llm/data/train series) so the telemetry tax
    # can be A/B-measured (tools/ray_perf.py --no-metrics). The metrics
    # *pipeline* (registry, push, scrape) stays up either way.
    metrics_enabled: bool = True
    # Event-loop-lag probe: each Endpoint self-times an asyncio.sleep of
    # this period and records the overshoot (the classic saturated-loop
    # symptom). <= 0 disables the probe task. Deliberately SLOW: the A/B
    # for this tier measured 0.5 s probes across a 16-worker cluster at
    # ~40% off the sync-RPC rows on a 2-core box (timer wakeups in every
    # process steal the benchmark's cores); at 2.5 s the probe disappears
    # into the existing periodic work while still catching loop stalls.
    loop_lag_probe_interval_s: float = 2.5
    metrics_report_interval_s: float = 2.0
    # Dashboard metric time-series (reference: dashboard/modules/metrics —
    # the Grafana-backed panels): the GCS samples the merged cluster
    # snapshot into a bounded per-series history ring that
    # /api/metrics/history serves. window = samples retained per series.
    metrics_history_interval_s: float = 5.0
    metrics_history_window: int = 360
    # Task-push pipelining (reference: the submitter keeps the leased
    # worker's queue non-empty instead of one in-flight task per lease):
    # how many pushes may be in flight per lease. 1 = the old behavior.
    push_pipeline_depth: int = 2
    # Batched push RPCs: when a scheduling class's queue is at least
    # push_batch_min_queue deep, up to push_batch_size tasks ride ONE
    # worker.push_batch RPC (amortizing per-message pickling/framing).
    push_batch_size: int = 4
    push_batch_min_queue: int = 8
    log_monitor_interval_s: float = 0.3
    log_to_driver: bool = True
    # Deterministic fault injection (RAY_TPU_FAULTS="<seed>:<rule>[;...]"):
    # parsed by core/faults.py at import into the process-global injector.
    # Empty = chaos off (production). Spawned workers inherit the env var,
    # so a head-exported spec reaches every member process.
    faults: str = ""
    # Distributed tracing (RAY_TPU_TRACING_ENABLED=1): spans ride the
    # task-event pipeline; tracing.enable()/disable() override at runtime.
    tracing_enabled: bool = False
    # GCS event-log JSON-lines export sink (RAY_TPU_EVENT_EXPORT_PATH):
    # empty = no export. Written by a background thread, drop-on-overflow.
    event_export_path: str = ""
    # Transfer-fabric armed-array cap (RAY_TPU_XFER_ARMED_CAP): staged
    # device arrays kept alive awaiting a pull before LRU eviction.
    xfer_armed_cap: int = 16
    # Default train results root (RAY_TPU_STORAGE_PATH): used when
    # RunConfig.storage_path is not given. Empty = ~/ray_tpu_results.
    storage_path: str = ""
    # Host-free train steps. With async dispatch on, TrainContext.report()
    # of a DEVICE-RESIDENT metrics tree (CUDA tensors) enqueues it into a
    # bounded ring, its device->host copy started on a side stream,
    # instead of waiting for the readback: up to
    # train_async_dispatch_depth steps of launches stay in flight ahead
    # of the card, and the host only blocks when a ring slot is evicted
    # or at checkpoint/flush boundaries. RAY_TPU_TRAIN_ASYNC_DISPATCH=0 is
    # the kill switch back to the synchronous loop (readback inside every
    # report()). Metrics surface at most `depth` steps late; checkpoints
    # flush the ring first.
    train_async_dispatch: bool = True
    train_async_dispatch_depth: int = 4
    # Double-buffered train input: batches are staged on the card (pinned,
    # copied on a side stream) this many batches ahead of the consuming
    # step, off the timed path. 0 = hand host batches straight through.
    train_prefetch_depth: int = 2
    # Memory-governed streaming data plane. ``data_governor`` is the kill
    # switch (RAY_TPU_DATA_GOVERNOR=0): off, the streaming executor runs
    # the pre-governor submission loop byte-identically: per-stage
    # in-flight windows only, no occupancy polling, no watermark
    # arbitration, the static round-robin actor pool. On, a per-execution
    # MemoryGovernor (data/governor.py) tracks per-operator in-flight
    # bytes and global object-store occupancy (the heartbeat's store
    # gauges; a DRAINING node's store does not count as headroom) and
    # grants/revokes task-submission budgets: throttle when occupancy
    # crosses data_store_high_frac (or any node spills), release once it
    # falls back under data_store_low_frac (hysteresis: budgets hold
    # inside the band), AIMD on the per-operator task budget (halve on a
    # high crossing, +1 per poll below the low watermark).
    data_governor: bool = True
    data_store_high_frac: float = 0.75
    data_store_low_frac: float = 0.5
    # Per-operator in-flight block-task cap. 0 = auto: max(4, 2 * host
    # cores).
    data_max_inflight_per_op: int = 0
    # How often the governor refreshes cluster store occupancy (one
    # bounded get_cluster_view RPC per interval, shared across every
    # acquire/release in the window).
    data_governor_poll_interval_s: float = 0.1
    # Actor-pool map operator defaults (map_batches compute=
    # ActorPoolStrategy()/"actors"): the pool starts at min_size actors,
    # scales up to max_size on queue depth under the governor's budget,
    # and scales back down when actors sit idle; each actor serves at
    # most max_tasks_per_actor blocks concurrently.
    data_actor_pool_min_size: int = 1
    data_actor_pool_max_size: int = 2
    data_actor_pool_max_tasks_per_actor: int = 2
    # Elastic training. ``elastic_train`` is the kill switch
    # (RAY_TPU_ELASTIC_TRAIN=0): off, a membership change tears the gang
    # down on a drain notice and rebuilds it from the latest persisted
    # checkpoint ("preempted", no max_failures burn). On, every rank
    # pauses at its next step boundary, the state moves peer-to-peer over
    # the transfer fabric onto the surviving (or joining) ranks, and the
    # run resumes at the boundary; any failure of that falls back to the
    # checkpoint-restore path.
    elastic_train: bool = True
    # Floor on the post-shrink world size (below it: checkpoint restore).
    elastic_min_world_size: int = 1
    # How long the controller waits for every rank to pause.
    elastic_pause_timeout_s: float = 15.0
    # Budget for the fabric state transfer (snapshot arm + peer pulls).
    elastic_reshard_timeout_s: float = 60.0
    # Scale-up: while below ScalingConfig.num_workers after a shrink, the
    # controller tries to recruit replacements this often. 0 disables.
    elastic_grow_check_s: float = 2.0
    # Fleet-scale control plane (round 19). ``sched_index`` is the kill
    # switch (RAY_TPU_SCHED_INDEX=0): off, every placement decision takes
    # the original full-scan pick_node path byte-identically (the A/B
    # baseline of tools/ab_fleet.py / ray_perf --no-sched-index). On, the
    # GCS and node-side schedulers consult a FeasibilityIndex
    # (core/sched_index.py): candidates bucketed by resource-key shape +
    # exact label set, hybrid placement probes a bounded
    # power-of-two-choices sample (``sched_index_probes`` fitting
    # candidates, rotating per-bucket cursors) and picks max headroom
    # among the sample instead of scanning every NodeView. The index
    # returns None exactly when the scan would (probing keeps extending
    # until it either finds ``sched_index_probes`` fits or exhausts every
    # shape/label-feasible bucket), so feasibility semantics are
    # unchanged; only WHICH fitting node wins may differ from the scan.
    sched_index: bool = True
    sched_index_probes: int = 8
    # Cross-plane flight recorder (util/flightrec.py). ``flightrec`` is
    # the kill switch (RAY_TPU_FLIGHTREC=0): off, every record site
    # collapses to one predicate check and the planes behave
    # byte-identically to the pre-recorder tree (no ring writes, no extra
    # RPC fields, no dump files — the A/B baseline of
    # tools/ab_tracing.py / ray_perf --no-flightrec). On, each plane
    # (serve, llm, train, data, gcs, fleet_emu, faults) keeps a bounded
    # in-process ring of phase events (monotonic ts + wall anchor,
    # request/task/node ids, live tracing span ids) that
    # tools/trace_export.py turns into a Chrome-trace timeline and a
    # per-request critical-path breakdown. ``flightrec_ring_size`` is the
    # per-plane event capacity (older events are overwritten and counted
    # in raytpu_obs_ring_drops_total). ``flightrec_dump_dir`` is where
    # postmortem snapshots land on a chaos fault firing, an actor death,
    # or an OverloadedError shed (empty = ray_tpu_flightrec under the
    # system's temporary directory).
    flightrec: bool = True
    flightrec_ring_size: int = 4096
    flightrec_dump_dir: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Config":
        return Config(**json.loads(s))

    def apply_json(self, s: str) -> None:
        """Overwrite this config in place with the cluster-authoritative
        values (the head's config, shipped via the GCS) — in place because
        every module holds a reference to GLOBAL_CONFIG."""
        for k, v in json.loads(s).items():
            setattr(self, k, v)

    def reapply_env(self) -> None:
        """Re-apply this process's RAY_TPU_<FIELD> env overrides on top of
        shipped cluster config. Per-process env wins (the contract in this
        module's docstring): a worker spawned with
        RAY_TPU_TRACING_ENABLED=1 in its environment must keep that
        override after apply_json() lands the head's values.
        Callers: worker_main, immediately after applying
        RAY_TPU_INTERNAL_CONFIG."""
        for f in dataclasses.fields(Config):
            if os.environ.get(f"RAY_TPU_{f.name.upper()}") is not None:
                setattr(self, f.name, _env(f.name, getattr(self, f.name)))


# Per-process bootstrap interface: RAY_TPU_* env vars that are read
# directly from the environment OUTSIDE this module, on purpose. These
# cannot ride the Config knob table because they are per-process identity
# or bootstrap values (set by the parent for a child it spawns, or
# consulted before/independently of config load), not cluster-synced
# configuration.
BOOTSTRAP_ENV_VARS = frozenset(
    {
        # Cluster address for auto-connecting drivers/jobs (set by the job
        # manager for driver subprocesses; read at ray_tpu_torch.init()).
        "RAY_TPU_ADDRESS",
        # Endpoint bind/advertise interface selection: consulted at
        # Endpoint.start() time, including before any cluster config
        # exists, and mutated at runtime by `raytpu start`/api.init.
        "RAY_TPU_BIND_HOST",
        "RAY_TPU_ADVERTISE_HOST",
        "RAY_TPU_HOST_IP",
        # Spawned-worker identity/bootstrap (set by the node per child).
        "RAY_TPU_WORKER_ID",
        "RAY_TPU_INTERNAL_CONFIG",
        # Worker stdio routing kill switches (consulted at spawn time).
        "RAY_TPU_WORKER_LOG_INHERIT",
        "RAY_TPU_SILENCE_WORKERS",
    }
)


def load_config() -> Config:
    cfg = Config()
    for f in dataclasses.fields(Config):
        setattr(cfg, f.name, _env(f.name, getattr(cfg, f.name)))
    return cfg


GLOBAL_CONFIG = load_config()
