"""Job management: create, enqueue, execute.

The port of audiotabs_tpu/runtime/jobs.py, its logic unchanged. The queue
is a directory of claim files on the shared data volume: the API enqueues
by writing data/queue/<job_id>, workers claim by atomic rename into
data/queue/claimed/, with no broker dependency. When Celery IS installed
and CELERY_ENABLED=1, jobs are dispatched through it instead.

Status transitions (queued → running → done|error) and the artifact layout
are the JAX package's, with atomic writes. A ``JobManager`` resolves its
device when it is made (the card unless ``device="cpu"``), so a process
without a GPU fails at start, not in the middle of a job.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from pathlib import Path

import torch

from ..config import Settings
from ..device import resolve_device
from .storage import LocalStorage

_LOG = logging.getLogger(__name__)


class JobManager:
    def __init__(
        self,
        data_dir: str | os.PathLike | None = None,
        device: str | torch.device | None = None,
        settings: Settings | None = None,
    ):
        self.device = resolve_device(device)
        self.settings = settings or Settings.from_env()
        self.storage = LocalStorage(data_dir or self.settings.DATA_DIR)
        self.queue_dir = self.storage.data_dir / "queue"
        (self.queue_dir / "claimed").mkdir(parents=True, exist_ok=True)

    # ---- creation ----

    def create_job(self, upload_bytes: bytes, filename: str) -> str:
        max_bytes = self.settings.MAX_UPLOAD_MB * 1024 * 1024
        if len(upload_bytes) > max_bytes:
            raise ValueError(f"upload exceeds {self.settings.MAX_UPLOAD_MB} MB cap")
        job_id = uuid.uuid4().hex
        job_dir = self.storage.job_dir(job_id)
        suffix = Path(filename).suffix or ".bin"
        (job_dir / "input" / f"upload{suffix}").write_bytes(upload_bytes)
        self.storage.write_json(job_dir / "input" / "meta.json", {"filename": filename})
        self.storage.set_status(job_id, "queued")
        return job_id

    def input_path(self, job_id: str) -> Path | None:
        input_dir = self.storage.data_dir / "jobs" / job_id / "input"
        for p in sorted(input_dir.glob("upload.*")):
            return p
        return None

    # ---- queue ----

    def enqueue(self, job_id: str) -> None:
        if self.settings.CELERY_ENABLED:
            try:
                from .celery_integration import process_job_task

                process_job_task.delay(job_id)
                return
            except Exception as exc:  # fall through to the file queue
                _LOG.warning("celery dispatch failed (%s); using file queue", exc)
        (self.queue_dir / job_id).write_text(str(time.time()))

    def requeue_stale_claims(self, max_age_s: float = 1800.0) -> int:
        """Return claims older than max_age_s to the queue.

        A killed worker leaves its claim file behind; re-queuing stale
        claims gives at-least-once processing.
        """
        requeued = 0
        now = time.time()
        for claim in (self.queue_dir / "claimed").iterdir():
            try:
                if not claim.is_file() or now - claim.stat().st_mtime < max_age_s:
                    continue
            except OSError:
                continue  # another worker removed it between iterdir and stat
            # job ids are uuid4().hex (dot-free); worker ids may contain dots
            # (FQDN hostnames), so split from the LEFT
            job_id = claim.name.split(".", 1)[0]
            status = self.storage.get_status(job_id).get("status")
            if status in ("done", "error"):
                claim.unlink(missing_ok=True)
                continue
            try:
                os.rename(claim, self.queue_dir / job_id)
                requeued += 1
            except OSError:
                pass
        return requeued

    def claim_next(self, worker_id: str) -> str | None:
        """Atomically claim the oldest queued job (None when queue empty)."""
        def _mtime(p):
            try:
                return p.stat().st_mtime
            except OSError:
                return float("inf")  # raced away; rename below will skip it

        entries = sorted(
            (p for p in self.queue_dir.iterdir() if p.is_file()), key=_mtime
        )
        for entry in entries:
            claimed = self.queue_dir / "claimed" / f"{entry.name}.{worker_id}"
            try:
                os.rename(entry, claimed)
                os.utime(claimed)  # claim age starts NOW (rename keeps mtime)
                return entry.name
            except OSError:
                continue  # another worker won the rename race
        return None

    def queue_depth(self) -> int:
        return sum(1 for p in self.queue_dir.iterdir() if p.is_file())

    # ---- execution ----

    def touch_claim(self, job_id: str, worker_id: str) -> None:
        """Heartbeat: refresh the claim mtime so long-running jobs aren't
        stolen by requeue_stale_claims."""
        claim = self.queue_dir / "claimed" / f"{job_id}.{worker_id}"
        try:
            os.utime(claim)
        except OSError:
            pass

    def release_claim(self, job_id: str, worker_id: str) -> None:
        """Remove a finished claim so claimed/ doesn't grow unboundedly and
        stale-claim scans stay O(in-flight jobs)."""
        claim = self.queue_dir / "claimed" / f"{job_id}.{worker_id}"
        try:
            claim.unlink()
        except OSError:
            pass

    def process_job(self, job_id: str) -> dict:
        job_dir = self.storage.data_dir / "jobs" / job_id
        input_path = self.input_path(job_id)
        if input_path is None:
            self.storage.set_status(job_id, "error", "missing input")
            return {"status": "error"}
        self.storage.set_status(job_id, "running")
        try:
            from .pipeline import run_pipeline

            result = run_pipeline(job_dir, input_path, self.device, self.settings)
            self.storage.write_json(job_dir / "out" / "result.json", result.to_dict())
            self.storage.set_status(job_id, "done")
            return {"status": "done"}
        except Exception as exc:
            _LOG.exception("job %s failed", job_id)
            self.storage.set_status(job_id, "error", str(exc))
            return {"status": "error", "error": str(exc)}

    def run_inline(self, job_id: str) -> dict:
        """Synchronous execution (the CELERY_ENABLED=0 inline path)."""
        return self.process_job(job_id)
