"""The port's job plane on the CPU: the counterpart of each test of
tests/test_runtime_api.py and tests/test_jobs_requeue.py, against the port's
server, worker and ``JobManager`` with ``device="cpu"``; the JAX server and
the port's on the same upload (``result.json`` equal, ``job_id`` aside, the
chord confidences and key score within rtol 1e-5); and the card as the
default device."""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from audiotabs_tpu_torch.config import Settings
from test_torch_batch_runner import assert_same_result
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

# the mix analysed at a 2 s bucket: the serving tests exercise the job plane,
# separation is held against the JAX package elsewhere
SERVE = Settings(ENABLE_DEMUCS=False, PAD_SECONDS_BUCKET=2.0)
SERVE_ENV = {"ENABLE_DEMUCS": "False", "PAD_SECONDS_BUCKET": "2"}


def _wav_bytes(tmp_path_factory, dur=2.0, sr=22050) -> bytes:
    from audiotabs_tpu_torch.io.wav import write_wav

    t = np.arange(int(sr * dur)) / sr
    y = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    y[:300] += 0.2 * np.random.default_rng(0).standard_normal(300).astype(np.float32)
    path = tmp_path_factory.mktemp("wav") / "song.wav"
    write_wav(path, y, sr)
    return path.read_bytes()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from audiotabs_tpu_torch.runtime.server import serve

    data_dir = tmp_path_factory.mktemp("srv_data")
    port = _free_port()
    httpd = serve(port, str(data_dir), background=True, device="cpu", settings=SERVE)
    yield port, data_dir, httpd.RequestHandlerClass.manager
    httpd.shutdown()
    httpd.server_close()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def test_health(server):
    port, _, _ = server
    status, ctype, data = _request(port, "GET", "/health")
    assert status == 200 and ctype == "application/json"
    assert json.loads(data) == {"status": "ok"}


def test_job_lifecycle_inline(server, tmp_path_factory):
    port, _, manager = server
    assert manager.device == torch.device("cpu")
    status, _, data = _request(port, "POST", "/v1/jobs?inline=1", body=_wav_bytes(tmp_path_factory), headers={"X-Filename": "song.wav"})
    assert status == 200
    job = json.loads(data)
    job_id = job["job_id"]
    assert job["status"] == "done", job

    status, _, data = _request(port, "GET", f"/v1/jobs/{job_id}")
    assert json.loads(data) == {"job_id": job_id, "status": "done", "error": None}

    status, ctype, data = _request(port, "GET", f"/v1/jobs/{job_id}/result.json")
    assert status == 200 and ctype == "application/json"
    result = json.loads(data)
    assert result["job_id"] == job_id and "tempo_bpm" in result

    status, ctype, data = _request(port, "GET", f"/v1/jobs/{job_id}/musicxml")
    assert status == 200 and b"score-partwise" in data and ctype == "application/vnd.recordare.musicxml+xml"
    status, _, data = _request(port, "GET", f"/v1/jobs/{job_id}/transcription.mid")
    assert status == 200 and data[:4] == b"MThd"
    status, _, data = _request(port, "GET", f"/v1/jobs/{job_id}/note_events.csv")
    assert status == 200 and data.startswith(b"start_time_s")
    status, _, data = _request(port, "GET", f"/v1/jobs/{job_id}/score.pdf")
    assert status == 200 and data.startswith(b"%PDF")
    status, _, data = _request(port, "GET", f"/v1/jobs/{job_id}/tab_positions.json")
    assert status == 200 and "measures" in json.loads(data)


def test_queue_and_worker(server, tmp_path_factory, monkeypatch):
    from audiotabs_tpu_torch.runtime.worker import main as worker_main

    port, data_dir, _ = server
    status, _, data = _request(port, "POST", "/v1/jobs", body=_wav_bytes(tmp_path_factory, dur=1.0), headers={"X-Filename": "q.wav"})
    job_id = json.loads(data)["job_id"]
    status, _, data = _request(port, "GET", f"/v1/jobs/{job_id}")
    assert json.loads(data)["status"] == "queued"

    # the worker reads its settings from the environment
    for k, v in SERVE_ENV.items():
        monkeypatch.setenv(k, v)
    assert worker_main(["--data-dir", str(data_dir), "--once", "--device", "cpu"]) == 0

    status, _, data = _request(port, "GET", f"/v1/jobs/{job_id}")
    assert json.loads(data)["status"] == "done"
    assert not any((data_dir / "queue" / "claimed").iterdir())
    status, _, _ = _request(port, "GET", f"/v1/jobs/{job_id}/result.json")
    assert status == 200


def test_unknown_job_and_artifact(server):
    port, _, _ = server
    status, _, _ = _request(port, "GET", "/v1/jobs/" + "0" * 32)
    assert status == 404
    status, _, _ = _request(port, "GET", "/v1/jobs/not-a-job")
    assert status == 404


def test_upload_cap(server):
    port, _, manager = server
    manager.settings = dataclasses.replace(SERVE, MAX_UPLOAD_MB=0)
    try:
        status, _, _ = _request(port, "POST", "/v1/jobs", body=b"x" * 2048)
    finally:
        manager.settings = SERVE
    assert status == 413


def test_multipart_upload(server, tmp_path_factory):
    port, data_dir, _ = server
    wav = _wav_bytes(tmp_path_factory, dur=0.5)
    boundary = "testboundary42"
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; filename="m.wav"\r\n'
        f"Content-Type: audio/wav\r\n\r\n"
    ).encode() + wav + f"\r\n--{boundary}--\r\n".encode()
    status, _, data = _request(port, "POST", "/v1/jobs", body=body, headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    assert status == 200
    job_id = json.loads(data)["job_id"]
    assert (data_dir / "jobs" / job_id / "input" / "upload.wav").read_bytes() == wav
    assert json.loads((data_dir / "jobs" / job_id / "input" / "meta.json").read_text()) == {"filename": "m.wav"}


def test_frontend_served_offline(server):
    port, _, _ = server
    code, _ct, page = _request(port, "GET", "/")
    assert code == 200
    html = page.decode()
    assert "score_renderer.js" in html
    code, _ct, js = _request(port, "GET", "/score_renderer.js")
    assert code == 200
    src = js.decode()
    for sym in ("renderScore", "renderLeadSheet", "renderTab", "AudiotabsScore"):
        assert sym in src
    assert 'data-view="tab"' in html
    assert "tab_positions.json" in html


def test_stale_claim_requeued(tmp_path):
    from audiotabs_tpu_torch.runtime.jobs import JobManager

    m = JobManager(tmp_path, device="cpu")
    job_id = m.create_job(b"RIFFxxxxWAVE", "x.wav")
    m.enqueue(job_id)
    assert m.queue_depth() == 1

    worker = "w1"
    assert m.claim_next(worker) == job_id
    assert m.queue_depth() == 0

    # simulate a dead worker: age the claim file
    claim = m.queue_dir / "claimed" / f"{job_id}.{worker}"
    old = time.time() - 3600
    os.utime(claim, (old, old))

    assert m.requeue_stale_claims(max_age_s=1800) == 1
    assert m.queue_depth() == 1
    # fresh claims are not requeued
    m.claim_next("w2")
    assert m.requeue_stale_claims(max_age_s=1800) == 0


def test_done_job_claim_dropped(tmp_path):
    from audiotabs_tpu_torch.runtime.jobs import JobManager

    m = JobManager(tmp_path, device="cpu")
    job_id = m.create_job(b"RIFFxxxxWAVE", "x.wav")
    m.enqueue(job_id)
    m.claim_next("w1")
    m.storage.set_status(job_id, "done")
    claim = m.queue_dir / "claimed" / f"{job_id}.w1"
    old = time.time() - 3600
    os.utime(claim, (old, old))
    assert m.requeue_stale_claims(max_age_s=1800) == 0
    assert not claim.exists()
    assert m.queue_depth() == 0


def test_celery_enabled_without_celery_falls_back_to_the_file_queue(tmp_path):
    from audiotabs_tpu_torch.runtime import celery_integration
    from audiotabs_tpu_torch.runtime.jobs import JobManager

    if celery_integration.celery is not None:
        pytest.skip("celery is installed here")
    with pytest.raises(RuntimeError, match="celery is not installed"):
        celery_integration.process_job_task.delay("0" * 32)
    m = JobManager(tmp_path, device="cpu", settings=dataclasses.replace(SERVE, CELERY_ENABLED=True))
    job_id = m.create_job(b"RIFFxxxxWAVE", "x.wav")
    m.enqueue(job_id)
    assert m.queue_depth() == 1 and m.claim_next("w1") == job_id


def test_missing_input_and_failed_job_record_an_error(tmp_path):
    from audiotabs_tpu_torch.runtime.jobs import JobManager

    m = JobManager(tmp_path, device="cpu", settings=SERVE)
    job_id = m.create_job(b"RIFFxxxxWAVE", "x.wav")
    assert m.process_job(job_id)["status"] == "error"
    assert m.storage.get_status(job_id)["status"] == "error"
    for p in (tmp_path / "jobs" / job_id / "input").glob("upload.*"):
        p.unlink()
    assert m.process_job(job_id) == {"status": "error"}
    assert m.storage.get_status(job_id) == {"status": "error", "error": "missing input"}


def test_result_json_matches_the_jax_server(server, tmp_path_factory, monkeypatch):
    from audiotabs_tpu.config import reload_settings
    from audiotabs_tpu.runtime.server import serve as jax_serve

    port, _, _ = server
    wav = _wav_bytes(tmp_path_factory)
    for k, v in SERVE_ENV.items():
        monkeypatch.setenv(k, v)
    reload_settings()
    jax_port = _free_port()
    jax_httpd = jax_serve(jax_port, str(tmp_path_factory.mktemp("jax_srv")), background=True)
    try:
        results = []
        for p in (port, jax_port):
            status, _, data = _request(p, "POST", "/v1/jobs?inline=1", body=wav, headers={"X-Filename": "song.wav"})
            assert status == 200 and json.loads(data)["status"] == "done"
            status, _, data = _request(p, "GET", f"/v1/jobs/{json.loads(data)['job_id']}/result.json")
            assert status == 200
            results.append(json.loads(data))
    finally:
        jax_httpd.shutdown()
        jax_httpd.server_close()
        monkeypatch.undo()
        reload_settings()
    got, ref = results
    assert got["transcription_error"] is None and got["score"]["measures"]
    assert_same_result(got, ref, ignore=("job_id",))


def test_job_manager_and_server_without_a_device_raise_when_no_gpu(monkeypatch, tmp_path):
    from audiotabs_tpu_torch.runtime.jobs import JobManager
    from audiotabs_tpu_torch.runtime.server import serve
    from audiotabs_tpu_torch.runtime.worker import main as worker_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JobManager(tmp_path / "jm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(_free_port(), str(tmp_path / "srv"), background=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_main(["--data-dir", str(tmp_path / "wk"), "--once"])
    assert not (tmp_path / "jm").exists() and not (tmp_path / "srv").exists()
