"""HTTP job API on the stdlib HTTP server: the JAX package's REST contract.

The port of audiotabs_tpu/runtime/server.py, with the same endpoints:

    GET  /health
    POST /v1/jobs                          multipart or raw audio upload (?inline=1 runs it now)
    GET  /v1/jobs/{id}                     status JSON
    GET  /v1/jobs/{id}/result.json
    GET  /v1/jobs/{id}/musicxml
    GET  /v1/jobs/{id}/score.pdf
    GET  /v1/jobs/{id}/transcription.mid
    GET  /v1/jobs/{id}/note_events.csv
    GET  /v1/jobs/{id}/tab_positions.json
    GET  /  and  /score_renderer.js        the offline viewer in frontend/

Jobs are enqueued to the file queue for workers (runtime/worker.py), or run
in the request with ``?inline=1``. Inline jobs run on the card unless the
server was started with ``--device cpu``:

    python -m audiotabs_tpu_torch.runtime.server [--port 8000] [--data-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import threading
from email.parser import BytesParser
from email.policy import default as email_default
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import torch

from ..config import Settings
from ..schemas import JobCreateResponse, JobInfo
from .jobs import JobManager

_ARTIFACTS = {
    "result.json": ("out/result.json", "application/json"),
    "musicxml": ("out/result.musicxml", "application/vnd.recordare.musicxml+xml"),
    "score.pdf": ("out/score.pdf", "application/pdf"),
    "transcription.mid": ("out/transcription.mid", "audio/midi"),
    "note_events.csv": ("out/note_events.csv", "text/csv"),
    "tab_positions.json": ("out/tab_positions.json", "application/json"),
}
_STATIC = {
    "/": ("index.html", "text/html; charset=utf-8"),
    "/index.html": ("index.html", "text/html; charset=utf-8"),
    "/score_renderer.js": ("score_renderer.js", "text/javascript; charset=utf-8"),
}
_FRONTEND = Path(__file__).resolve().parent.parent.parent / "frontend"

_JOB_RE = re.compile(r"^/v1/jobs/([0-9a-f]{32})(?:/(.+))?$")


def _parse_multipart(headers, body: bytes) -> tuple[bytes, str] | None:
    ctype = headers.get("Content-Type", "")
    if "multipart/form-data" not in ctype:
        return None
    msg = BytesParser(policy=email_default).parsebytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
    )
    for part in msg.iter_parts():
        if part.get_content_disposition() == "form-data":
            filename = part.get_filename() or "upload.wav"
            return part.get_payload(decode=True), filename
    return None


class _Handler(BaseHTTPRequestHandler):
    manager: JobManager = None  # set per server by serve()

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, body: bytes, mime: str, cors: bool = True) -> None:
        self.send_response(code)
        self.send_header("Content-Type", mime)
        self.send_header("Content-Length", str(len(body)))
        origin = self.manager.settings.FRONTEND_ORIGIN
        if cors and origin:
            self.send_header("Access-Control-Allow-Origin", origin)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json")

    def do_GET(self):
        if self.path == "/health":
            return self._json(200, {"status": "ok"})
        if self.path in _STATIC:
            name, mime = _STATIC[self.path]
            page = _FRONTEND / name
            if page.exists():
                return self._send(200, page.read_bytes(), mime, cors=False)
            return self._json(404, {"detail": "frontend not bundled"})
        m = _JOB_RE.match(self.path.split("?")[0])
        if not m:
            return self._json(404, {"detail": "not found"})
        job_id, artifact = m.group(1), m.group(2)
        job_dir = self.manager.storage.data_dir / "jobs" / job_id
        if not job_dir.exists():
            return self._json(404, {"detail": "job not found"})
        if artifact is None:
            status = self.manager.storage.get_status(job_id)
            return self._json(200, JobInfo(job_id, status.get("status", "unknown"), status.get("error")).to_dict())
        if artifact not in _ARTIFACTS:
            return self._json(404, {"detail": "unknown artifact"})
        rel, mime = _ARTIFACTS[artifact]
        path = job_dir / rel
        if not path.exists():
            return self._json(404, {"detail": f"{artifact} not ready"})
        self._send(200, path.read_bytes(), mime)

    def do_POST(self):
        if self.path.split("?")[0] != "/v1/jobs":
            return self._json(404, {"detail": "not found"})
        length = int(self.headers.get("Content-Length", 0))
        if length > self.manager.settings.MAX_UPLOAD_MB * 1024 * 1024:
            return self._json(413, {"detail": "upload too large"})
        body = self.rfile.read(length)
        parsed = _parse_multipart(self.headers, body)
        if parsed is None:
            filename = self.headers.get("X-Filename", "upload.wav")
            payload = body
        else:
            payload, filename = parsed
        if not payload:
            return self._json(400, {"detail": "empty upload"})
        try:
            job_id = self.manager.create_job(payload, filename)
        except ValueError as exc:
            return self._json(413, {"detail": str(exc)})

        query = parse_qs(urlparse(self.path).query)
        if query.get("inline", ["0"])[0] == "1":
            outcome = self.manager.run_inline(job_id)
            return self._json(200, JobCreateResponse(job_id, outcome.get("status", "error")).to_dict())
        self.manager.enqueue(job_id)
        return self._json(200, JobCreateResponse(job_id, "queued").to_dict())


def serve(
    port: int = 8000,
    data_dir: str | None = None,
    *,
    background: bool = False,
    device: str | torch.device | None = None,
    settings: Settings | None = None,
) -> ThreadingHTTPServer:
    """Serve the job API on ``port``; with ``background`` in a daemon thread,
    returning the server (``shutdown()`` stops it). The server's
    ``JobManager`` is ``httpd.RequestHandlerClass.manager``."""
    manager = JobManager(data_dir, device=device, settings=settings)
    handler = type("Handler", (_Handler,), {"manager": manager})
    httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    httpd.serve_forever()
    return httpd


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="audiotabs_tpu_torch job API server")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(f"serving on :{args.port}")
    serve(args.port, args.data_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
