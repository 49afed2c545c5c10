"""Optional Celery integration (used only when celery+redis are installed
and CELERY_ENABLED=1): Redis broker/backend, JSON serialization, queue
"gpu". The port of audiotabs_tpu/runtime/celery_integration.py. The native
file queue (jobs.py) is the default transport; without ``celery``,
``process_job_task.delay`` raises and ``JobManager.enqueue`` falls back to it.
"""

from __future__ import annotations

from ..config import Settings

try:
    from celery import Celery

    _settings = Settings.from_env()
    celery = Celery(
        "audiotabs_tpu_torch",
        broker=_settings.REDIS_URL,
        backend=_settings.REDIS_URL,
    )
    celery.conf.update(
        task_serializer="json",
        result_serializer="json",
        accept_content=["json"],
        task_routes={"audiotabs_tpu_torch.process_job": {"queue": "gpu"}},
    )

    @celery.task(name="audiotabs_tpu_torch.process_job")
    def process_job_task(job_id: str) -> dict:
        from .jobs import JobManager

        return JobManager().process_job(job_id)

except ImportError:  # celery not installed: attribute access raises cleanly
    celery = None

    class _Unavailable:
        def delay(self, *a, **k):
            raise RuntimeError("celery is not installed")

    process_job_task = _Unavailable()
