"""The port's held-out corpus generator reproduces the committed corpus byte for byte.

``audiotabs_tpu_torch.train.make_heldout`` is a numpy copy of the JAX
generator: every WAV and ground-truth JSON it renders must carry the md5 of
``tests/data/heldout/MANIFEST.md5``, and ``--check`` must say so.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import pytest

from audiotabs_tpu_torch.train import make_heldout

HELDOUT_DIR = Path(__file__).parent / "data" / "heldout"


def test_generate_gives_every_committed_md5(tmp_path):
    committed = make_heldout.committed_manifest(HELDOUT_DIR)
    digests = make_heldout.generate(tmp_path)
    assert digests == committed
    assert len(committed) == 12
    for name, md5 in committed.items():
        assert hashlib.md5((tmp_path / name).read_bytes()).hexdigest() == md5
    assert (tmp_path / make_heldout.MANIFEST).read_bytes() == (HELDOUT_DIR / make_heldout.MANIFEST).read_bytes()


def test_check_passes_and_writes_nothing_into_the_corpus(capsys):
    before = {p.name: p.stat().st_mtime_ns for p in HELDOUT_DIR.iterdir()}
    assert make_heldout.main(["--check"]) == 0
    assert "12 files byte-identical" in capsys.readouterr().out
    assert {p.name: p.stat().st_mtime_ns for p in HELDOUT_DIR.iterdir()} == before


def test_main_needs_an_outdir_or_check():
    with pytest.raises(SystemExit):
        make_heldout.main([])


def test_version_and_compositions_match_the_jax_generator():
    from audiotabs_tpu.train import make_heldout as jax_make_heldout

    assert make_heldout.HELDOUT_VERSION == jax_make_heldout.HELDOUT_VERSION
    assert list(make_heldout.CLIPS) == list(jax_make_heldout.CLIPS)
    for name in make_heldout.CLIPS:
        y, sr, gt = make_heldout.CLIPS[name]()
        jy, jsr, jgt = jax_make_heldout.CLIPS[name]()
        assert sr == jsr and gt == jgt and y.tobytes() == jy.tobytes()
