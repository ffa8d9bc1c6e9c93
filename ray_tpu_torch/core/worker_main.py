"""Worker process entrypoint. Port of ``ray_tpu/core/worker_main.py``
(reference parity: python/ray/_private/workers/default_worker.py).
Spawned by NodeManager as ``python -m ray_tpu_torch.core.worker_main``;
registers with the node, then serves task pushes until told to exit or the
node dies."""

from __future__ import annotations

import argparse
import signal
import sys
import time


def main() -> None:
    # SIGUSR1 dumps all thread stacks to stderr — the debugging hook for
    # hung workers (reference analog: py-spy via the dashboard reporter).
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)

    parser = argparse.ArgumentParser()
    parser.add_argument("--node-addr", required=True)
    parser.add_argument("--gcs-addr", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--shm-root", required=True)
    parser.add_argument("--session-id", required=True)
    args = parser.parse_args()

    import os

    from ray_tpu_torch.core.config import GLOBAL_CONFIG
    from ray_tpu_torch.core.core_worker import CoreWorker

    if os.environ.get("RAY_TPU_INTERNAL_CONFIG"):
        GLOBAL_CONFIG.apply_json(os.environ["RAY_TPU_INTERNAL_CONFIG"])
        # Per-process env overrides (operator exports) beat the head's
        # shipped values. NB modules that read a knob at import time
        # (core/faults.py) already saw the env-loaded value: the CoreWorker import above precedes apply_json, and this
        # re-apply keeps the config consistent with what they captured
        # even if that import order ever changes.
        GLOBAL_CONFIG.reapply_env()

    def parse(a: str) -> tuple:
        host, _, port = a.rpartition(":")
        return (host, int(port))

    worker = CoreWorker(
        gcs_addr=parse(args.gcs_addr),
        node_addr=parse(args.node_addr),
        kind="worker",
        worker_id=os.environ.get("RAY_TPU_WORKER_ID"),
    )

    import ray_tpu_torch.core.api as api

    # Attach BEFORE start(): registration makes this worker leasable, and a
    # task can arrive (on the endpoint thread) before the main thread runs
    # the next statement. User code calling get_runtime_context()/remote()
    # in that window would find no attached worker and AUTO-INIT a nested
    # in-process cluster — tasks then report node ids of a cluster that
    # exists only inside one worker process (observed as "ran on a node
    # that is not in the cluster" flakes).
    api._attach_existing_worker(worker)
    worker.start()

    stop = []

    def on_term(signum, frame):
        stop.append(1)

    signal.signal(signal.SIGTERM, on_term)

    # Fast exit when the connection to OUR node dies (node crash/shutdown) —
    # other peers' connections come and go normally.
    node_conn = worker.endpoint.submit(
        worker.endpoint.connect(worker.node_addr)
    ).result(timeout=30)
    node_conn_lost = []

    def on_lost(conn):
        if conn is node_conn:
            node_conn_lost.append(1)

    worker.endpoint.on_connection_lost = on_lost
    last_probe = time.monotonic()
    while not stop and not node_conn_lost:
        time.sleep(0.2)
        # Belt-and-braces: probe the node periodically too.
        if time.monotonic() - last_probe >= 2.0:
            last_probe = time.monotonic()
            try:
                worker.endpoint.call(
                    worker.node_addr, "node.get_info", {}, timeout=10
                )
            except Exception:  # raylint: disable=RL006 -- orphan watchdog: any error reaching the node means it is gone; exit
                break
    worker.stop()
    sys.exit(0)


if __name__ == "__main__":
    main()
