"""Queue worker: claim jobs from the file queue and run the pipeline.

The port of audiotabs_tpu/runtime/worker.py. Runs the pipeline on the card
unless ``--device cpu`` is given:

    python -m audiotabs_tpu_torch.runtime.worker [--data-dir DIR] [--once] [--device cpu]

Scale-out = more worker processes sharing the data volume. Workers poll the
queue directory; each claim is an atomic rename so concurrent workers never
double-process.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

from .jobs import JobManager

_LOG = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="audiotabs_tpu_torch queue worker")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--poll-interval", type=float, default=0.5)
    ap.add_argument("--once", action="store_true", help="drain the queue then exit")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    manager = JobManager(args.data_dir, device=args.device)
    worker_id = f"{os.uname().nodename}-{os.getpid()}"
    n = manager.requeue_stale_claims()
    if n:
        _LOG.info("requeued %d stale claims", n)
    _LOG.info("worker %s watching %s on %s", worker_id, manager.queue_dir, manager.device)

    stop = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *_: stop.update(flag=True))
    signal.signal(signal.SIGINT, lambda *_: stop.update(flag=True))

    requeue_every_s = 300.0
    last_requeue = time.monotonic()
    while not stop["flag"]:
        # periodic stale-claim scan: a job claimed by a crashed worker must
        # not wait for a worker RESTART to be recovered (steady-state
        # deployments never restart)
        if time.monotonic() - last_requeue >= requeue_every_s:
            last_requeue = time.monotonic()
            n = manager.requeue_stale_claims()
            if n:
                _LOG.info("requeued %d stale claims", n)
        job_id = manager.claim_next(worker_id)
        if job_id is None:
            if args.once:
                break
            time.sleep(args.poll_interval)
            continue
        _LOG.info("processing %s", job_id)
        t0 = time.perf_counter()
        # heartbeat thread: keep the claim fresh while the pipeline runs
        done_evt = threading.Event()

        def _heartbeat():
            while not done_evt.wait(300.0):
                manager.touch_claim(job_id, worker_id)

        hb = threading.Thread(target=_heartbeat, daemon=True)
        hb.start()
        try:
            result = manager.process_job(job_id)
        finally:
            done_evt.set()
        # released only on normal return: if process_job raised, the claim
        # file must survive so requeue_stale_claims can recover the job
        manager.release_claim(job_id, worker_id)
        _LOG.info("job %s → %s in %.1fs", job_id, result.get("status"), time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
