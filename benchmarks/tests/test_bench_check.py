"""The check that decides ``correct``: a run with the timed path broken
underneath must come out not correct, once for each fault the cells can
have (CPU, at a size a test holds); and the lower-precision control, the
reference in TF32, must fail the configuration's limits (on the card).

    python -m pytest benchmarks/tests -q
"""

import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from core import check, songs  # noqa: E402
from core.configured import configured  # noqa: E402
from core.runner import run_cell  # noqa: E402
from test_bench_harness import BIG_SEED, few_threads, tiny_cell  # noqa: E402,F401


def program(name: str):
    return importlib.import_module(f"audiotabs_tpu_torch.{name}")


def altered_result(monkeypatch):
    """An answer altered where it is produced: the tail's tempo."""
    pipeline = program("runtime.pipeline")
    tail = pipeline._pipeline_tail

    def wrong(**kwargs):
        result = tail(**kwargs)
        result.tempo_bpm += 1.0
        return result

    monkeypatch.setattr(pipeline, "_pipeline_tail", wrong)


def altered_decode(monkeypatch):
    """An answer altered where it is produced: one beat phase of the DBN decode."""
    fused = program("runtime.fused")
    dbn = fused._dbn_forward

    def wrong(act, *args, **kwargs):
        phases, intervals = dbn(act, *args, **kwargs)
        phases = phases.clone()
        phases[..., phases.shape[-1] // 2] += 1
        return phases, intervals

    monkeypatch.setattr(fused, "_dbn_forward", wrong)


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged: separation hands the mix back as every stem."""
    htdemucs = program("models.htdemucs")

    def wrong(model, y, sr, seg, stride, shifts, bf16=False):
        return torch.stack([y] * model.n_sources, dim=-2)

    monkeypatch.setattr(htdemucs, "separate_program", wrong)


def half_the_batch(monkeypatch):
    """Half of the batch left out: the second half's rows are the first half's songs again."""
    batch_runner = program("runtime.batch_runner")
    load = batch_runner._load_and_bucket

    def wrong(paths, bucket_s):
        batch, true_lens, sr = load(paths, bucket_s)
        half = len(paths) // 2
        batch[half:] = batch[: len(paths) - half]
        return batch, true_lens[: len(paths) - half] * 2, sr

    monkeypatch.setattr(batch_runner, "_load_and_bucket", wrong)


# the faults of mix-clip30 (an answer altered), and those of the paths the
# harness drives for later cells: separation, and transcribe_batch's loop
FAULTS = {
    "altered_result": (altered_result, "mix-clip30", "single", {}),
    "altered_decode": (altered_decode, "mix-clip30", "single", {}),
    "unchanged_separation": (unchanged_state, "mix-clip30", "single", {"ENABLE_DEMUCS": True}),
    "half_the_batch": (half_the_batch, "mix-clip30", "batch", {}),
}


@pytest.mark.parametrize("loop", ["single", "batch"])
def test_a_sound_run_is_correct(loop):
    line, err = run_cell(tiny_cell("mix-clip30", loop), BIG_SEED, 0.1, False, "cpu", 0.0)
    assert line["correct"] is True, line["compared"]
    # the program's features equal the reference's here, so its tail ran on its own
    tails = re.search(r"ran on its own features for (\d+) of (\d+) songs", "\n".join(err)).groups()
    assert tails[0] == tails[1] != "0"


def test_the_tail_runs_on_the_references_own_features_only_where_they_equal_the_programs():
    own = {"a": np.array([1.0, np.nan], np.float32), "b": np.array([3, 4], np.int32)}
    tally = [0, 0]
    assert check.tail_features(own, {k: v.copy() for k, v in own.items()}, tally) is own
    prog = {"a": np.array([1.0 + 1e-7, np.nan], np.float32), "b": own["b"]}
    assert check.tail_features(own, prog, tally) is prog
    assert check.tail_features(own, None, tally) is own
    assert tally == [2, 3]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    breaks, workload, loop, settings = FAULTS[fault]
    breaks(monkeypatch)
    line, _ = run_cell(tiny_cell(workload, loop, **settings), BIG_SEED, 0.1, False, "cpu", 0.0)
    assert line["correct"] is False, line["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mix-clip30", "shipped-song180"])
def test_the_tf32_control_fails_the_limits(workload, tmp_path):
    """The reference in TF32 in the program's place, against the reference in
    float32, on a 4 s song, with the configuration's own weights and reference
    modules: the numbers of the configuration it must fail."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card: TF32 is a CUDA precision")
    cell = tiny_cell(workload, n=1)
    dev = torch.device("cuda")
    with configured(cell.config, cell.root, tmp_path, dev):
        (song,) = songs.make_songs(cell.traffic, BIG_SEED, tmp_path, "cuda")
        ref = check.Reference(cell.config["settings"], dev, tmp=tmp_path)
        low = check.Reference(cell.config["settings"], dev, tf32=True, tmp=tmp_path)
        r, _ = ref.single(song.path, "song00", None)
        c, _ = low.single(song.path, "song00", None)
    numbers = check.compare(c, r, None)
    limits = cell.config["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
