"""Each port trainer's command line, end to end on the CPU at tiny sizes.

``main`` builds its data (the generators' held-out sets capped at two clips
here), trains a few steps, runs its gates (the committed held-out corpus cut
to its shortest solo clip) and, with the save gate forced open (``accept``),
writes a checkpoint into the test's directory that both packages' loaders
read. Separation is off (``HTDEMUCS_WEIGHTS=off``), so
the held-out gates take the mix instead of the guitar stem. Nothing is
written under audiotabs_tpu/weights/.
"""

import inspect
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import audiotabs_tpu.models.basicpitch as jbp
import audiotabs_tpu.models.beat_rnn as jbr
import audiotabs_tpu.models.crf_chords as jcc
import audiotabs_tpu.models.deepchroma as jdc
import audiotabs_tpu.models.htdemucs as jhd
import audiotabs_tpu.models.key_cnn as jkc
import audiotabs_tpu_torch.train as port_train
from audiotabs_tpu_torch.models import basicpitch, beat_rnn, crf_chords, deepchroma, htdemucs, key_cnn
from audiotabs_tpu_torch.train import basicpitch_train, beat_rnn_train, crf_chords_train, deepchroma_train
from audiotabs_tpu_torch.train import htdemucs_train, key_cnn_train
from test_torch_fused import torch_threads  # noqa: F401 (an autouse fixture)

SHIPPED = Path(__file__).resolve().parents[1] / "audiotabs_tpu" / "weights"
TRAINERS = (htdemucs_train, beat_rnn_train, key_cnn_train, deepchroma_train, crf_chords_train, basicpitch_train)


@pytest.fixture(scope="module", autouse=True)
def shipped_weights_untouched():
    before = {p.name: (p.stat().st_mtime_ns, p.stat().st_size) for p in SHIPPED.glob("*.npz")}
    yield
    assert {p.name: (p.stat().st_mtime_ns, p.stat().st_size) for p in SHIPPED.glob("*.npz")} == before


@pytest.fixture(autouse=True)
def small_run(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("HTDEMUCS_WEIGHTS", "off")
    held = tmp_path / "heldout"
    held.mkdir()
    for suffix in (".wav", ".json"):
        shutil.copyfile(port_train.HELDOUT_DIR / f"heldout_fingerpick{suffix}", held / f"heldout_fingerpick{suffix}")
    monkeypatch.setattr(port_train, "HELDOUT_DIR", held)
    for mod in TRAINERS:
        monkeypatch.setattr(mod, "accept", lambda report: True)


def _cap(monkeypatch, module, name: str, most: int = 2):
    """Cap the clip count of ``module.<name>`` (its first argument) at ``most``."""
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda n, *a, **k: fn(min(n, most), *a, **k))


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_default_outputs_are_under_build():
    for mod in TRAINERS:
        out = inspect.signature(mod.train).parameters["out_path"].default
        assert out.startswith("build/weights/") and out.endswith(".npz"), mod.__name__


def test_trainers_refuse_to_run_without_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        key_cnn_train.main(["--clips", "1", "--steps", "1"])


def test_htdemucs_main(tmp_path, monkeypatch):
    _cap(monkeypatch, htdemucs_train, "build_clips")
    out = tmp_path / "htdemucs.npz"
    assert htdemucs_train.main(["--clips", "2", "--steps", "2", "--batch", "2", "--channels", "8", "--bottom", "64",
                                "--t-layers", "2", "--out", str(out), "--device", "cpu"]) == 0
    ours, ref = htdemucs.load_params(str(out)), jhd.load_params(str(out))
    _same(ours, ref)
    assert int(ref["meta_segment"]) == htdemucs_train.SEG and np.asarray(ref["tdecoder"][-1]["convtr_w"]).shape[1] == 8
    # --resume continues from the checkpoint just written
    assert htdemucs_train.main(["--clips", "2", "--steps", "1", "--batch", "2", "--resume", "--out", str(out),
                                "--device", "cpu"]) == 0


def test_beat_rnn_main(tmp_path, monkeypatch):
    _cap(monkeypatch, beat_rnn_train, "build_dataset", most=1)
    out = tmp_path / "beat_rnn.npz"
    # the exit code is 0 when the ensemble's validation F is positive, as in the JAX trainer
    beat_rnn_train.main(["--clips", "1", "--epochs", "1", "--ensemble", "2", "--batch", "8", "--hidden", "8",
                         "--out", str(out), "--device", "cpu"])
    ours, ref = beat_rnn.load_params(str(out)), jbr.load_params(str(out))
    _same(ours, ref)
    assert len(ref["ensemble"]) == 1 and np.asarray(ref["layers"][0]["fwd"]["U"]).shape == (8, 32)


def test_key_cnn_main(tmp_path, monkeypatch):
    _cap(monkeypatch, key_cnn_train, "build_clips")
    out = tmp_path / "key_cnn.npz"
    assert key_cnn_train.main(["--clips", "2", "--steps", "2", "--batch", "2", "--out", str(out), "--device", "cpu"]) == 0
    _same(key_cnn.load_params(str(out)), jkc.load_params(str(out)))


def test_deepchroma_main(tmp_path, monkeypatch):
    _cap(monkeypatch, deepchroma_train, "build_dataset")
    out = tmp_path / "deepchroma.npz"
    assert deepchroma_train.main(["--clips", "1", "--steps", "2", "--batch", "16", "--out", str(out), "--device", "cpu"]) == 0
    ours, ref = deepchroma.load_params(str(out)), jdc.load_params(str(out))
    _same(ours, ref)
    assert "feat_mean" in ref and "feat_std" in ref


def test_crf_chords_main(tmp_path, monkeypatch):
    _cap(monkeypatch, crf_chords_train, "build_dataset", most=1)
    out = tmp_path / "crf_chords.npz"
    assert crf_chords_train.main(["--clips", "1", "--steps", "2", "--batch", "64", "--out", str(out), "--device", "cpu"]) == 0
    ours, ref = crf_chords.load_params(str(out)), jcc.load_params(str(out))
    _same(ours, ref)
    assert np.asarray(ref["emit_w"]).shape == (36, 25)


def test_basicpitch_main(tmp_path, monkeypatch):
    _cap(monkeypatch, basicpitch_train, "build_clips")
    out = tmp_path / "basicpitch.npz"
    # the exit code is 0 when the CNN's validation note F is positive, as in the JAX trainer
    basicpitch_train.main(["--clips", "2", "--steps", "2", "--batch", "2", "--out", str(out), "--device", "cpu"])
    _same(basicpitch.load_params(str(out)), jbp.load_params(str(out)))
