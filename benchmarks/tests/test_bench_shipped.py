"""CPU tests of the ``shipped`` configuration: htdemucs_6s at its published
widths and layer order (``configs/shipped.json``), its plain reference
(``own_reference/htdemucs_published.py``), the FLOPs ``core/flops.py`` counts
for it, the readers of ``separation_mfu`` and ``separation_windows``, and the
cell run end to end at a size a CPU test holds.

    python -m pytest benchmarks/tests -q
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from core import cells, flops, program  # noqa: E402
from core.configured import reference_modules  # noqa: E402
from core.drive import Done  # noqa: E402
from core.runner import run_cell  # noqa: E402
from core.songs import Song  # noqa: E402
from test_bench_harness import BIG_SEED, counted, few_threads, own_reference_modules, tiny_cell  # noqa: E402,F401

SHIPPED = json.loads((BENCH / "configs" / "shipped.json").read_text())
# the shipped net at a size the CPU holds: its order and LayerScale, narrower and with a shorter feed-forward
SMALL = {"n_sources": 6, "audio_channels": 2, "channels": 8, "bottom": 32, "t_layers": 5, "t_ff": 128, "layer_scale": 0.1}


def published():
    """``reference.models.htdemucs`` as the ``shipped`` configuration has it (call inside ``reference_modules``)."""
    from reference.models import htdemucs

    return htdemucs


def test_the_shipped_nets_are_the_net_its_weights_build():
    h, widths = SHIPPED["nets"]["htdemucs"], SHIPPED["weights"]["htdemucs"]["widths"]
    with reference_modules(SHIPPED["reference_modules"], ROOT):
        hd = published()
        p = hd.init_params(torch.Generator().manual_seed(SHIPPED["weights"]["htdemucs"]["seed"]), **widths)
        net = hd.HTDemucs.from_params(p)
        cfg = hd.program_config(p, SHIPPED["settings"]["DEMUCS_MODEL"], ["guitar"])
    assert h["channels"] == [e.conv.out_channels for e in net.encoder] == [48, 96, 192, 384]
    assert h["dconv_hidden"] == [[e.dconv.layers[0].conv1.out_channels, t.dconv.layers[0].conv1.out_channels]
                                 for e, t in zip(net.encoder, net.tencoder)]
    assert (h["audio_channels"], h["sources"]) == (net.audio_channels, net.n_sources) == (2, 6)
    assert (h["bottom_channels"], h["transformer_ff"], h["transformer_layers"]) == (
        net.up_s.out_features, net.tlayers[0].lin1.out_features, len(net.tlayers)) == (512, 2048, 5)
    assert h["cross_layers"] == [i for i, layer in enumerate(net.tlayers) if layer.cross] == [1, 3]
    assert [layer.cross for layer in net.tlayers_t] == [layer.cross for layer in net.tlayers]
    assert (h["segment"], h["stride"], h["sources"]) == (cfg["seg"], cfg["stride"], cfg["n_sources"])
    assert h["shifts"] == SHIPPED["settings"]["DEMUCS_SHIFTS"]
    assert cfg["names"][cfg["stem_idx"]] == "guitar"
    assert float(p["tlayers"][1]["gamma1"][0]) == pytest.approx(widths["layer_scale"])
    assert sum(x.numel() for x in net.parameters()) == pytest.approx(41.5e6, rel=0.01)
    # a window at the published widths: 0.3303 TFLOP in this order, 0.3266 with the even layers cross-attending
    assert flops.htdemucs_window(h, h["segment"]) / 1e12 == pytest.approx(0.3303, abs=5e-5)
    assert flops.htdemucs_window({**h, "cross_layers": [0, 2, 4]}, h["segment"]) / 1e12 == pytest.approx(0.3266, abs=5e-5)


def test_htdemucs_flops_match_the_counter_at_the_shipped_order():
    """The published reference's own net, in the order ``init_params`` makes
    and ``from_params`` reads, against ``htdemucs_window`` at ``shipped``'s
    ``cross_layers``."""
    with reference_modules(SHIPPED["reference_modules"], ROOT):
        net = published().HTDemucs.from_params(published().init_params(torch.Generator().manual_seed(3), **SMALL))
    h = {"channels": [8, 16, 32, 64], "dconv_hidden": [[4, 4], [4, 4], [4, 4], [8, 8]], "audio_channels": 2,
         "sources": 6, "bottom_channels": 32, "transformer_ff": 128, "transformer_layers": 5,
         "cross_layers": SHIPPED["nets"]["htdemucs"]["cross_layers"]}
    assert [i for i, layer in enumerate(net.tlayers) if layer.cross] == h["cross_layers"]
    for length in (8192, 16384):
        assert counted(lambda: net(torch.randn(1, 2, length))) == flops.htdemucs_window(h, length)


class Run:
    def __init__(self, seconds: list[float], sep_ms: float, songs: int, config: dict = SHIPPED):
        self.done = [Done(Song(i, s, 120.0, Path("x")), 3.0, None) for i, s in enumerate(seconds)]
        self.layer_ms = {"separation": (sep_ms, songs)}
        self.config = config
        self.separation = flops.separation_net(config)


def test_separation_mfu_reads_the_windows_work_over_the_separations_device_seconds():
    reader = cells.reader("separation_mfu")
    h = SHIPPED["nets"]["htdemucs"]
    # a window starts at each multiple o of 258,048 with o + 344,064 - 258,048 < the song's samples at 44.1 kHz:
    # 31 windows in a 180 s song (7,938,000 samples), 10 in a 60 s one (2,646,000)
    assert flops.htdemucs_song(h, flops.samples(180.0)) == 31 * flops.htdemucs_window(h, 344064)
    assert flops.htdemucs_song(h, flops.samples(60.0)) == 10 * flops.htdemucs_window(h, 344064)
    assert flops.htdemucs_window(h, 344064) == 330_301_440_000
    by_hand = 100.0 * (31 + 31 + 10) * 330_301_440_000 / 1.6875 / 67e12  # 21.0 %
    value = reader(Run([180.0, 180.0, 60.0], 1687.5, 3))
    assert value == pytest.approx(by_hand, rel=1e-12)
    assert 0 < value < 100
    assert reader(Run([180.0], 0.0, 0)) is None  # no separation timed
    assert cells.reader("separation_ms")(Run([180.0, 180.0, 60.0], 1687.5, 3)) == pytest.approx(562.5)


def test_separation_mfu_reads_its_own_cells_widths():
    """Two separated configurations of other widths, on the same window, each
    read their own work: ``shipped`` (cross-attention at 1 and 3) and one that
    cross-attends at 0, 2 and 4."""
    reader = cells.reader("separation_mfu")
    other = json.loads(json.dumps(SHIPPED)) | {"name": "shipped_other"}
    other["nets"]["htdemucs"]["cross_layers"] = [0, 2, 4]
    # a window's branches: ns = 8 frequency rows x 336 frames = 2,688 tokens, nt = 344,064 / 4**4 = 1,344; a layer
    # that cross-attends in place of self-attending changes both branches' key projections and attention products
    # by 4 D (2 ns nt - ns**2 - nt**2) = -4 x 512 x 1,344**2, and the other order has one more such layer
    other_window = 330_301_440_000 - 4 * 512 * 1344**2
    assert other_window == 326_602_063_872 == flops.htdemucs_window(other["nets"]["htdemucs"], 344064)
    for config, window in ((SHIPPED, 330_301_440_000), (other, other_window)):
        by_hand = 100.0 * 31 * window / 0.5625 / 67e12  # one 180 s song, 31 windows, in 562.5 ms
        assert reader(Run([180.0], 562.5, 1, config)) == pytest.approx(by_hand, rel=1e-12)
    assert reader(Run([180.0], 562.5, 1, json.loads((BENCH / "configs" / "mix.json").read_text()))) is None


def test_separation_windows_reads_the_programs_counter(monkeypatch):
    reader = cells.reader("separation_windows")
    run = Run([180.0, 180.0], 0.0, 0)
    monkeypatch.setattr(program, "recorded", lambda: ([], {"separation_windows": 62, "separation_chunks": 4}))
    assert reader(run) == 31
    monkeypatch.setattr(program, "recorded", lambda: None)  # a program without the tracer
    assert reader(run) is None
    monkeypatch.setattr(program, "recorded", lambda: ([], {}))  # a program without the counter
    assert reader(run) is None


def test_the_import_rule_covers_the_shipped_reference():
    assert own_reference_modules()["models.htdemucs"] == "own_reference/htdemucs_published.py"


def old_order(p: dict) -> dict:
    def flip(i: int, layer: dict) -> dict:
        layer = {k: v for k, v in layer.items() if k not in ("norm3_g", "norm3_b")}
        if i % 2 == 0:
            layer["norm3_g"], layer["norm3_b"] = np.ones_like(layer["norm1_g"]), np.zeros_like(layer["norm1_b"])
        return layer

    return {**p, **{b: [flip(i, layer) for i, layer in enumerate(p[b])] for b in ("tlayers", "tlayers_t")}}


def no_attention(p: dict) -> dict:
    return {**p, **{b: [{**layer, "gamma1": np.zeros_like(layer["gamma1"])} for layer in p[b]]
                    for b in ("tlayers", "tlayers_t")}}


@pytest.mark.parametrize("fault", [None, old_order, no_attention], ids=["sound", "old-order", "no-attention"])
def test_the_shipped_cell_runs_and_its_check_sees_the_transformer(monkeypatch, fault):
    """``shipped-song180`` at the small widths, two 3.5–4 s songs: correct as
    it is; not correct where the program runs the seeded weights in the old
    layer order or without attention (``stem_err`` over its limit)."""
    cell = tiny_cell("shipped-song180")
    cell.config["weights"]["htdemucs"]["widths"] = SMALL
    if fault is not None:
        htdemucs = __import__("audiotabs_tpu_torch.models.htdemucs", fromlist=["HTDemucs"])
        build = htdemucs.HTDemucs.from_params.__func__
        monkeypatch.setattr(htdemucs.HTDemucs, "from_params", classmethod(lambda cls, p: build(cls, fault(p))))
        htdemucs._model.cache_clear()
    monkeypatch.delenv("HTDEMUCS_WEIGHTS", raising=False)
    try:
        line, _ = run_cell(cell, BIG_SEED, 0.1, False, "cpu", 0.0)
    finally:
        __import__("audiotabs_tpu_torch.models.htdemucs", fromlist=["_model"])._model.cache_clear()
    stem_err = line["compared"]["stem_err"]
    if fault is None:
        assert line["correct"] is True, line["compared"]
        assert stem_err["value"] == 0
    else:
        assert line["correct"] is False
        assert stem_err["value"] > 10 * stem_err["limit"], line["compared"]


@pytest.mark.parametrize("fault", ["unchanged_separation", "altered_result"])
def test_a_broken_shipped_song_is_not_correct(monkeypatch, fault):
    """``shipped-song180`` at the small widths with its timed path broken:
    separation hands the mix back as every stem, or the tail's tempo is
    altered where it is produced."""
    from test_bench_check import FAULTS

    FAULTS[fault][0](monkeypatch)
    cell = tiny_cell("shipped-song180")
    cell.config["weights"]["htdemucs"]["widths"] = SMALL
    monkeypatch.delenv("HTDEMUCS_WEIGHTS", raising=False)
    line, _ = run_cell(cell, BIG_SEED, 0.1, False, "cpu", 0.0)
    assert line["correct"] is False, line["compared"]


def test_launched_ms_places_device_time_in_the_spans_that_launched_it():
    import launched_ms

    def x(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **({"args": {"correlation": corr}} if corr else {})}

    events = [
        x("user_annotation", "audiotabs/separation/net", 0, 100), x("user_annotation", "audiotabs/separation/transformer", 10, 50),
        x("user_annotation", "audiotabs/separation/net", 200, 100), x("user_annotation", "window", 0, 1000),
        x("cuda_runtime", "cudaLaunchKernel", 5, 1, 1), x("kernel", "conv", 400, 30, 1),  # the device runs late
        x("cuda_runtime", "cudaLaunchKernel", 20, 1, 2), x("kernel", "gemm", 440, 70, 2),
        x("cuda_driver", "cuLaunchKernel", 250, 1, 3), x("kernel", "gemm", 520, 20, 3),
        x("cuda_runtime", "cudaMemcpyAsync", 600, 1, 4), x("gpu_memcpy", "Memcpy DtoH", 610, 5, 4),
    ]
    assert launched_ms.launched(events) == {"separation/net": (120.0, 3), "separation/transformer": (70.0, 1),
                                            "(none)": (5.0, 1)}
