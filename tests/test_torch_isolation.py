"""The port stands alone: no JAX, no pydantic and nothing of audiotabs_tpu, and no silent CPU fallback."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "audiotabs_tpu_torch"


def _modules() -> list[str]:
    mods = []
    for p in sorted(PACKAGE.rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert {
        "audiotabs_tpu_torch.runtime.pipeline", "audiotabs_tpu_torch.ops.median", "audiotabs_tpu_torch.models.htdemucs",
        "audiotabs_tpu_torch.runtime.cli", "audiotabs_tpu_torch.runtime.modes", "audiotabs_tpu_torch.schemas",
        "audiotabs_tpu_torch.score.musicxml", "audiotabs_tpu_torch.runtime.batch_runner", "audiotabs_tpu_torch.runtime.jobs",
        "audiotabs_tpu_torch.runtime.worker", "audiotabs_tpu_torch.runtime.server", "audiotabs_tpu_torch.runtime.celery_integration",
        "audiotabs_tpu_torch.io.native", "audiotabs_tpu_torch.io.mp3", "audiotabs_tpu_torch.io.avdecode",
        "audiotabs_tpu_torch.theory.postprocess", "audiotabs_tpu_torch.decode.melody", "audiotabs_tpu_torch.ops.chroma",
        "audiotabs_tpu_torch.analysis.metrics", "audiotabs_tpu_torch.train.synth", "audiotabs_tpu_torch.train.golden",
        "audiotabs_tpu_torch.train.optim", "audiotabs_tpu_torch.train.shifts_eval", "audiotabs_tpu_torch.train.make_heldout",
        "audiotabs_tpu_torch.parallel", "audiotabs_tpu_torch.parallel.mesh", "audiotabs_tpu_torch.parallel.model_axis",
        "audiotabs_tpu_torch.score.lead_sheet",
        *(f"audiotabs_tpu_torch.train.{m}_train" for m in ("htdemucs", "beat_rnn", "key_cnn", "deepchroma", "crf_chords", "basicpitch")),
    } <= set(mods)
    # the GPU machine has no pydantic and no celery: the port must not need them
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pydantic'] = None\n"
        "sys.modules['celery'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None and (m == 'audiotabs_tpu' or m.startswith(('audiotabs_tpu.', 'jax', 'pydantic'))))\n"
        "assert not bad, bad\n"
        "assert sys.modules['audiotabs_tpu_torch.runtime.celery_integration'].celery is None\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_run_analysis_without_a_device_raises_when_no_gpu(monkeypatch):
    from audiotabs_tpu_torch.runtime.pipeline import run_analysis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_analysis(REPO / "tests" / "data" / "heldout" / "heldout_strum_band.wav")


def test_run_pipeline_and_cli_without_a_device_raise_when_no_gpu(monkeypatch, tmp_path):
    from audiotabs_tpu_torch.runtime.cli import main
    from audiotabs_tpu_torch.runtime.pipeline import run_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = REPO / "tests" / "data" / "heldout" / "heldout_strum_band.wav"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(tmp_path / "job", clip)
    assert not (tmp_path / "job").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(clip), "--job-dir", str(tmp_path / "cli")])
    assert not (tmp_path / "cli" / "out").exists() or not any((tmp_path / "cli" / "out").iterdir())


def test_batch_runner_and_mesh_without_a_device_raise_when_no_gpu(monkeypatch):
    import numpy as np

    from audiotabs_tpu_torch.parallel import make_mesh
    from audiotabs_tpu_torch.runtime.batch_runner import batched_fused_analysis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched_fused_analysis(np.zeros((1, 22050), np.float32), 22050)


@pytest.mark.parametrize("device,ok", [(None, False), ("cuda", False), ("cuda:0", False), ("cpu", True), ("mps", False)])
def test_resolve_device_takes_the_cpu_only_when_asked(monkeypatch, device, ok):
    from audiotabs_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if ok:
        assert resolve_device(device) == torch.device("cpu")
    else:
        with pytest.raises((RuntimeError, ValueError)):
            resolve_device(device)

