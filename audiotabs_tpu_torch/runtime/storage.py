"""Job directory layout + JSON artifact store.

Contract identical to the reference (backend/app/services/storage/local.py:4-19):
data/jobs/<id>/{input,work,out}, status.json state machine, JSON artifacts.
Writes are atomic (tmp+rename) — fixing the reference's benign status.json race.

The port's copy of ``audiotabs_tpu/runtime/storage.py``: host code, arithmetic unchanged.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path


class LocalStorage:
    def __init__(self, data_dir: str | os.PathLike):
        self.data_dir = Path(data_dir)

    def job_dir(self, job_id: str) -> Path:
        d = self.data_dir / "jobs" / job_id
        for sub in ("input", "work", "out"):
            (d / sub).mkdir(parents=True, exist_ok=True)
        return d

    def read_json(self, path: str | os.PathLike):
        with open(path, "r") as f:
            return json.load(f)

    def write_json(self, path: str | os.PathLike, obj) -> None:
        path = Path(path)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(obj, f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def set_status(self, job_id: str, status: str, error: str | None = None) -> None:
        payload = {"status": status}
        if error is not None:
            payload["error"] = error
        self.write_json(self.job_dir(job_id) / "status.json", payload)

    def get_status(self, job_id: str) -> dict:
        p = self.data_dir / "jobs" / job_id / "status.json"
        if not p.exists():
            return {"status": "unknown"}
        return self.read_json(p)
