"""CPU tests of the benchmark's harness: the seeded songs, discovery by
name, the end-to-end arithmetic, the frozen counts, the result line, the
refusal without a card and the import rules.

    python -m pytest benchmarks/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from core import cells, flops, songs, work  # noqa: E402
from core.drive import Done  # noqa: E402
from core.runner import end_to_end, run_cell  # noqa: E402

BIG_SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(workload: str, loop: str = "single", n: int = 2, root: Path = ROOT, **settings) -> cells.Cell:
    """A cell of the benchmark at a size a CPU test holds: ``n`` songs of 3.5 to 4.5 s in a 6 s bucket.
    ``settings`` override the configuration's; with separation on, its stems are compared too, and a
    configuration that names no separation net separates with the checked-in htdemucs, as the program does."""
    cell = cells.load_cell(workload, root)
    cell.config["settings"] = dict(cell.config.get("settings", {}), PAD_SECONDS_BUCKET=6.0, BATCH_SONGS_PER_DEVICE=2,
                                   **settings)
    if cell.config["settings"].get("ENABLE_DEMUCS", True) and set(cell.config["nets"]) <= set(flops.ANALYSIS_NETS):
        cell.config["nets"] = cell.config["nets"] | {"htdemucs": CHECKED_IN_HTDEMUCS}
    cell.traffic = {"loop": loop, "songs": n, "seconds": [3.5 + 0.5 * (i % 3) for i in range(n)],
                    "tempi_bpm": [96 + 8 * i for i in range(n)], "sample_rate": 44100, "checked": n, "content_seed": 17,
                    **({"batch": n} if loop == "batch" else {})}
    if cell.config["settings"].get("ENABLE_DEMUCS", True):
        cell.config["limits"].setdefault("stem_err", 1e-4)
    else:
        cell.config["limits"].pop("stem_err", None)  # no separation, no stems to compare
    return cell


def test_same_seed_gives_the_same_bytes(tmp_path):
    traffic = tiny_cell("mix-clip30", n=3).traffic
    for d in "abc":
        (tmp_path / d).mkdir()
    a = songs.make_songs(traffic, BIG_SEED, tmp_path / "a")
    b = songs.make_songs(traffic, BIG_SEED, tmp_path / "b")
    assert [x.path.read_bytes() for x in a] == [x.path.read_bytes() for x in b]
    c = songs.make_songs(traffic, BIG_SEED + 1, tmp_path / "c")
    assert all(x.path.read_bytes() != y.path.read_bytes() for x, y in zip(a, c))


def test_a_seed_only_orders_the_traffics_songs():
    traffic = cells.load_cell("mix-clip30").traffic
    plans = [songs.song_plan(traffic, s) for s in (1, 2, BIG_SEED)]
    assert len({tuple(p) for p in plans}) == 3
    songs_of_the_set = sorted(zip(traffic["seconds"], traffic["tempi_bpm"], range(traffic["songs"])))
    for p in plans:
        assert sorted((float(a), float(b), k) for a, b, k in p) == songs_of_the_set


def test_a_song_is_a_stereo_wav_of_its_length(tmp_path):
    from reference.io.wav import read_wav

    traffic = tiny_cell("mix-clip30", n=1).traffic
    (song,) = songs.make_songs(traffic, 7, tmp_path)
    x, sr = read_wav(song.path)
    assert sr == 44100 and x.shape == (int(song.seconds * 44100), 2)
    assert 0.85 < np.abs(x).max() <= 0.91


def checkout(tmp_path: Path) -> tuple[Path, dict]:
    """A checkout of the benchmark's files (the shared reference is imported from this one) and its BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmarks", ignore=shutil.ignore_patterns("__pycache__", "reference"))
    return root, json.loads((ROOT / "BENCHMARK.json").read_text())


def test_configs_traffic_and_metrics_are_found_by_name(tmp_path):
    root, bench = checkout(tmp_path)
    conf = json.loads((BENCH / "configs" / "mix.json").read_text()) | {"name": "mix_small"}
    (root / "benchmarks" / "configs" / "mix_small.json").write_text(json.dumps(conf))
    (root / "benchmarks" / "traffic" / "clip10.json").write_text(json.dumps(tiny_cell("mix-clip30").traffic))
    (root / "benchmarks" / "metrics" / "window_s.py").write_text("def read(run):\n    return run.window_s\n")
    bench["configs"].append({"name": "mix_small", "source": "https://example.org", "file": "benchmarks/configs/mix_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mix_small-clip10", "config": "mix_small", "traffic": "clip10", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "window_s", "unit": "s", "better": "lower", "source": "host_clock", "layer": "device",
                               "moves": "audio_s_per_s", "workloads": ["mix_small-clip10"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell("mix_small-clip10", root)
    assert cell.config["name"] == "mix_small" and cell.traffic["songs"] == 2
    assert "window_s" in [m["name"] for m in cell.per_layer]
    assert cells.reader("window_s", root)(type("Run", (), {"window_s": 3.5})()) == 3.5
    assert "song_p90_s" not in [m["name"] for m in cell.end_to_end]


TINY_HTDEMUCS = {"seed": 5, "widths": {"n_sources": 6, "audio_channels": 2, "channels": 8, "bottom": 32, "t_layers": 2}}
# the widths core/flops.py takes for TINY_HTDEMUCS's net (the shared reference's order; a 7.8 s window)
TINY_HTDEMUCS_NET = {"channels": [8, 16, 32, 64], "dconv_hidden": [[4, 4], [4, 4], [4, 4], [8, 8]], "audio_channels": 2,
                     "sources": 6, "bottom_channels": 32, "transformer_ff": 128, "transformer_layers": 2, "segment": 344064,
                     "stride": 258048, "shifts": 1}

# a module standing in for reference.models.htdemucs: the shared one, noting which of its functions ran, and the
# bottom width of the net that separate_program was given
MARKED_HTDEMUCS = """
import pathlib as _pathlib


def _marked(fn):
    def wrapped(*args, **kwargs):
        with open(_pathlib.Path(__file__).with_suffix(".ran"), "a") as f:
            f.write(f"{fn.__name__}:{getattr(getattr(args[0], 'up_s', None), 'out_features', '')}\\n")
        return fn(*args, **kwargs)
    return wrapped


init_params = _marked(init_params)
separate_program = _marked(separate_program)
"""


def test_a_configuration_with_its_own_weights_and_reference_module_runs(tmp_path, monkeypatch):
    root, bench = checkout(tmp_path)
    own = root / "benchmarks" / "references" / "htdemucs_marked.py"
    own.parent.mkdir(exist_ok=True)
    own.write_text((BENCH / "reference" / "models" / "htdemucs.py").read_text() + MARKED_HTDEMUCS)
    conf = {k: v for k, v in json.loads((BENCH / "configs" / "mix.json").read_text()).items() if k != "settings"}
    conf |= {"name": "separated", "settings": {}, "weights": {"htdemucs": TINY_HTDEMUCS},
             "nets": conf["nets"] | {"htdemucs": TINY_HTDEMUCS_NET},
             "reference_modules": {"models.htdemucs": "references/htdemucs_marked.py"}}
    (root / "benchmarks" / "configs" / "separated.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "separated", "source": "https://example.org", "file": "benchmarks/configs/separated.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "separated-clip30", "config": "separated", "traffic": "clip30", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.delenv("HTDEMUCS_WEIGHTS", raising=False)
    imported = sys.modules.get("reference.models.htdemucs")

    line, err = run_cell(tiny_cell("separated-clip30", root=root), BIG_SEED, 0.1, False, "cpu", 0.0)
    assert line["correct"] is True, line["compared"]
    assert line["compared"]["stem_err"]["value"] == 0
    ran = own.with_suffix(".ran").read_text().split()
    assert ran[0] == "init_params:" and "separate_program:32" in ran  # the weight maker's, then the check's, seeded
    made = [e for e in err if e.startswith("run: weights htdemucs from seed 5: ")]
    assert len(made) == 1 and int(made[0].split(": ")[2].split()[0]) > 0
    assert "HTDEMUCS_WEIGHTS" not in os.environ
    assert sys.modules.get("reference.models.htdemucs") is imported  # the shared reference is back


def test_a_seed_makes_the_same_weights(tmp_path, monkeypatch):
    from core.configured import seeded_weights
    from reference.models.params_io import load_pytree_npz

    monkeypatch.setenv("HTDEMUCS_WEIGHTS", "off")
    made = {}
    for d, seed in (("a", 5), ("b", 5), ("c", 6)):
        (tmp_path / d).mkdir()
        with seeded_weights({"htdemucs": TINY_HTDEMUCS | {"seed": seed}}, tmp_path / d, torch.device("cpu")):
            data = np.load(os.environ["HTDEMUCS_WEIGHTS"])
            made[d] = {k: data[k].tobytes() for k in data.files}
        assert os.environ["HTDEMUCS_WEIGHTS"] == "off"
    assert made["a"] == made["b"] and made["a"].keys() == made["c"].keys()
    assert made["a"]["tlayers/#0/q_w"] != made["c"]["tlayers/#0/q_w"]
    p = load_pytree_npz(tmp_path / "a" / "weights" / "htdemucs.npz")
    assert [np.asarray(e["conv_w"]).shape[0] for e in p["encoder"]] == [8, 16, 32, 64]
    assert np.asarray(p["up_s_w"]).shape == (32, 64) and len(p["tlayers"]) == 2
    assert np.asarray(p["tdecoder"][-1]["convtr_w"]).shape[1] == 6 * 2


def test_every_metric_of_every_cell_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
        assert {"audio_s_per_s", "setup_s"} <= {m["name"] for m in cell.end_to_end}
        flops.separation_net(cell.config)  # every separating configuration's net has its count file


def test_end_to_end_metrics_take_every_song_of_the_window():
    cell = cells.load_cell("mix-clip30")
    walls = [0.3] * 8 + [0.9, 1.0, 1.2, 3.0]
    lengths = [20.0 + i for i in range(12)]
    done = [Done(songs.Song(i, s, 100.0, Path("x")), w, None) for i, (s, w) in enumerate(zip(lengths, walls))]
    m = end_to_end(cell, done, 20.0, 7.5)
    assert m["audio_s_per_s"]["value"] == pytest.approx(sum(lengths) / 20.0)
    # the 90th percentile of all twelve songs, not of per-chunk medians
    assert m["song_p90_s"]["value"] == pytest.approx(np.percentile(walls, 90))
    assert m["setup_s"]["value"] == 7.5


def test_dbn_work_at_the_30_s_bucket():
    adds, compares, _ = work.dbn_work(1, 3007)
    assert (adds, compares) == (38_506_860, 21_216_090)
    assert work.bound_s(adds, compares) == pytest.approx(0.00127e-3, rel=0.01)


def test_median_bytes():
    assert work.median_bytes(1025 * 7752) == 8 * 1025 * 7752


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


def nets_of(config: str) -> dict:
    return json.loads((BENCH / "configs" / f"{config}.json").read_text())["nets"]


# the checked-in htdemucs_6s, which no cell runs yet (it is narrower than the
# published model): the widths core/flops.py takes for it
CHECKED_IN_HTDEMUCS = {"channels": [24, 48, 96, 192], "dconv_hidden": [[4, 4], [6, 6], [12, 12], [24, 24]],
                       "audio_channels": 2, "sources": 6, "bottom_channels": 192, "transformer_ff": 768,
                       "transformer_layers": 3, "segment": 131072, "stride": 98304, "shifts": 1}


# a small seeded htdemucs in the published layer order (arXiv:2211.08553; demucs' CrossTransformerEncoder with
# cross_first=False: self-attention at the even layers, cross-attention at the odd ones)
SMALL_PUBLISHED_ORDER = {"channels": [8, 16, 32, 64], "dconv_hidden": [[4, 4], [4, 4], [4, 4], [8, 8]], "audio_channels": 2,
                         "sources": 6, "bottom_channels": 32, "transformer_ff": 128, "transformer_layers": 5,
                         "cross_layers": [1, 3]}


def htdemucs_net(order: str):
    """The reference's htdemucs and the widths core/flops.py takes for it: the
    checked-in checkpoint in its order (even layers cross-attend), or a small
    seeded net whose TransformerLayers are set to the published order."""
    from reference.models import htdemucs

    if order == "checked_in":
        return htdemucs.HTDemucs.from_params(htdemucs.load_params()), CHECKED_IN_HTDEMUCS
    h = SMALL_PUBLISHED_ORDER
    net = htdemucs.HTDemucs.from_params(htdemucs.init_params(
        torch.Generator().manual_seed(3), n_sources=h["sources"], channels=h["channels"][0], bottom=h["bottom_channels"],
        t_layers=h["transformer_layers"]))
    for layers in (net.tlayers, net.tlayers_t):
        for i in range(len(layers)):
            layers[i] = htdemucs.TransformerLayer(h["bottom_channels"], h["transformer_ff"], cross=i in h["cross_layers"])
    return net, h


@pytest.mark.parametrize("order", ["checked_in", "published"])
def test_htdemucs_flops_match_the_counter(order):
    net, widths = htdemucs_net(order)
    assert [layer.cross for layer in net.tlayers] == [i in widths.get("cross_layers", (0, 2, 4)) for i in
                                                      range(widths["transformer_layers"])]
    for length in (8192, 16384):
        assert counted(lambda: net(torch.randn(1, 2, length))) == flops.htdemucs_window(widths, length)


def test_a_song_counts_at_its_true_length():
    config = json.loads((BENCH / "configs" / "mix.json").read_text())
    # 20 s and 30 s share the 30 s bucket: padding counted, they would read alike
    count = [flops.song_flops(config, s, flops.separation_net(config)) for s in (20.0, 25.0, 30.0)]
    assert 0 < count[0] < count[1] < count[2]


# song_flops as the harness counted it before a separation net was found by its count file
PINNED_SONG_FLOPS = {
    ("mix", 20.0): 60_311_453_200, ("mix", 25.0): 75_323_968_992, ("mix", 30.0): 90_399_799_552,
    ("mix", 180.0): 542_187_070_592, ("shipped", 20.0): 1_381_517_213_200, ("shipped", 25.0): 1_396_529_728_992,
    ("shipped", 30.0): 1_741_906_999_552, ("shipped", 180.0): 10_781_531_710_592,
}


@pytest.mark.parametrize("config,seconds", sorted(PINNED_SONG_FLOPS))
def test_song_flops_are_as_pinned(config, seconds):
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    assert flops.song_flops(conf, seconds, flops.separation_net(conf)) == float(PINNED_SONG_FLOPS[config, seconds])


# the count file of a stand-in separation net: its widths give its FLOPs per sample at the analysis rate
TOY_SEP = "def song(widths, n):\n    return widths['flops_per_sample'] * n\n"


def with_toy_sep(tmp_path: Path) -> tuple[Path, dict]:
    """A checkout whose only addition is the count file ``benchmarks/nets/toy_sep.py``, and ``mix`` separating with it."""
    root, bench = checkout(tmp_path)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmarks" / "nets" / "toy_sep.py").write_text(TOY_SEP)
    mix = json.loads((BENCH / "configs" / "mix.json").read_text())
    return root, mix | {"name": "toy", "settings": {"ENABLE_DEMUCS": True}, "nets": mix["nets"] | {"toy_sep": {"flops_per_sample": 3}}}


def test_song_flops_count_a_separation_net_by_its_file(tmp_path):
    root, toy = with_toy_sep(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmarks" / "configs" / "toy.json").write_text(json.dumps(toy))
    bench["configs"].append({"name": "toy", "source": "https://example.org", "file": "benchmarks/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-clip30", "config": "toy", "traffic": "clip30", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    config = cells.load_cell("toy-clip30", root).config
    separation = flops.separation_net(config, root)
    assert separation[0] == "toy_sep"
    mix = json.loads((BENCH / "configs" / "mix.json").read_text())
    for seconds in (20.0, 25.0):
        assert flops.song_flops(config, seconds, separation) == flops.song_flops(mix, seconds, None) + 3 * flops.samples(seconds)
    assert sorted(p.name for p in (root / "benchmarks" / "core").glob("*.py")) == sorted(
        p.name for p in (BENCH / "core").glob("*.py"))  # the harness itself is the checkout's, unedited


@pytest.mark.parametrize("nets,names", [({}, "none"), ({"toy_sep": {"flops_per_sample": 3}, "htdemucs": {}}, "htdemucs, toy_sep"),
                                        ({"bs_roformer": {}}, "'bs_roformer', which has no count file")],
                         ids=["no-net", "two-nets", "no-count-file"])
def test_a_separation_net_that_cannot_be_counted_fails_before_any_song(tmp_path, monkeypatch, nets, names):
    root, toy = with_toy_sep(tmp_path)
    cell = tiny_cell("mix-clip30", root=root, ENABLE_DEMUCS=True)
    cell.config["nets"] = {k: v for k, v in toy["nets"].items() if k != "toy_sep"} | nets

    def no_songs(*args, **kwargs):
        raise AssertionError("a song was made")

    monkeypatch.setattr(songs, "make_songs", no_songs)
    with pytest.raises(ValueError, match=re.escape(names)):
        run_cell(cell, BIG_SEED, 0.1, False, "cpu", 0.0)


def test_fused_nets_flops_match_the_counter():
    from reference.models import basicpitch, deepchroma, key_cnn

    y = torch.randn(22050 * 2)
    assert counted(lambda: basicpitch.hcqt(y, 22050)) == flops.hcqt(len(y))[0]
    hc = basicpitch.hcqt(y, 22050)
    cnn = basicpitch.BasicPitchCNN.from_params(basicpitch.load_params())
    assert counted(lambda: cnn(hc)) == flops.basicpitch_cnn(hc.shape[-1])
    nets = nets_of("mix")
    dc = deepchroma.DeepChromaDNN.from_params(deepchroma.load_params())
    assert counted(lambda: dc(torch.randn(21, 1800))) == flops.deepchroma(nets["deepchroma"], 21)
    kc = key_cnn.KeyCNN.from_params(key_cnn.load_params())
    assert counted(lambda: kc(torch.randn(11, 120, 1))) == flops.key_cnn(nets["key_cnn"], 11)


def lstm_as_products(lstm: torch.nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """nn.LSTM's forward written as its gate products, which the FLOP counter sees."""
    H = lstm.hidden_size
    for layer in range(lstm.num_layers):
        outs = []
        for sfx in ("", "_reverse"):
            w_ih, w_hh = getattr(lstm, f"weight_ih_l{layer}{sfx}"), getattr(lstm, f"weight_hh_l{layer}{sfx}")
            b = getattr(lstm, f"bias_ih_l{layer}{sfx}") + getattr(lstm, f"bias_hh_l{layer}{sfx}")
            xs = x.flip(1) if sfx else x
            h = c = x.new_zeros(x.shape[0], H)
            hs = []
            for t in range(x.shape[1]):
                i, f, g, o = (xs[:, t] @ w_ih.T + h @ w_hh.T + b).split(H, dim=1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            out = torch.stack(hs, 1)
            outs.append(out.flip(1) if sfx else out)
        x = torch.cat(outs, dim=-1)
    return x


def test_blstm_flops_match_the_counter():
    from reference.models import beat_rnn

    ens = beat_rnn.ensemble_from_params(beat_rnn.load_params())
    conf = nets_of("mix")["beat_rnn"]
    for frames in (150, 400):
        feats = torch.randn(frames, conf["input_dim"])
        total = 0
        for m in ens:
            win = 256
            if frames <= win:
                wins = feats[None]
            else:
                hop = win - 64
                nwin = -(-(frames - 64) // hop)
                f = torch.cat([feats, feats[-1:].expand(nwin * hop + 64 - frames, -1)])
                wins = f.unfold(0, win, hop).transpose(1, 2).contiguous()
            with torch.no_grad():
                torch.testing.assert_close(lstm_as_products(m.lstm, wins), m.lstm(wins)[0], rtol=1e-4, atol=1e-5)
            total += counted(lambda: m.out(lstm_as_products(m.lstm, wins)))
        assert total == flops.blstm(conf, frames)


def test_configs_state_the_checkpoints_widths():
    from reference.models import basicpitch, beat_rnn, deepchroma, htdemucs, key_cnn

    p = htdemucs.load_params()
    h = CHECKED_IN_HTDEMUCS
    cfg = htdemucs.program_config(p, "htdemucs_6s", ["guitar"])
    assert h["channels"] == [np.asarray(e["conv_w"]).shape[0] for e in p["encoder"]]
    assert h["bottom_channels"] == np.asarray(p["up_s_w"]).shape[1] and h["transformer_layers"] == len(p["tlayers"])
    assert h["transformer_ff"] == np.asarray(p["tlayers"][0]["lin1_w"]).shape[1]
    assert (h["segment"], h["stride"], h["sources"]) == (cfg["seg"], cfg["stride"], cfg["n_sources"])
    for name in ("mix",):
        nets = nets_of(name)
        assert "htdemucs" not in nets  # the configuration runs no separation
        members = beat_rnn.ensemble_from_params(beat_rnn.load_params())
        b = nets["beat_rnn"]
        assert (b["members"], b["input_dim"], b["hidden"], b["layers"]) == (
            len(members), members[0].lstm.input_size, members[0].lstm.hidden_size, members[0].lstm.num_layers)
        assert not any(m.full_context for m in members)
        d = deepchroma.load_params()
        assert (nets["deepchroma"]["input_dim"], nets["deepchroma"]["hidden"], nets["deepchroma"]["layers"]) == (
            *np.asarray(d["layers"][0]["w"]).shape, len(d["layers"]))
        assert nets["key_cnn"]["bands"] == np.asarray(key_cnn.load_params()["out_w"]).shape[0] // 32 * 4
        assert nets["basicpitch"]["harmonics"] == np.asarray(basicpitch.load_params()["c1_w"]).shape[2]


def test_a_run_prints_the_result_lines_keys(tmp_path):
    line, err = run_cell(tiny_cell("mix-clip30"), BIG_SEED, 3.0, False, "cpu", 0.0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"audio_s_per_s", "song_p90_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all({"value", "limit"} == set(v) for v in line["compared"].values())
    assert err[-1].startswith("compared ")
    json.dumps(line, allow_nan=False)


def test_no_result_without_a_card(monkeypatch, capsys):
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mix-clip30", "--seed", str(BIG_SEED), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "audiotabs_tpu"}


def test_the_harness_and_reference_import_no_jax():
    code = (
        "import sys, importlib, pathlib\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import run\n"
        "from core import cells, check, drive, flops, runner, songs, trace, work\n"
        f"[cells.reader(p.stem) for p in pathlib.Path({str(BENCH / 'metrics')!r}).glob('*.py')]\n"
        f"[cells.net_count(p.stem) for p in pathlib.Path({str(BENCH / 'nets')!r}).glob('*.py')]\n"
        "import reference.runtime.pipeline, reference.runtime.batch_runner, reference.models.htdemucs\n"
        "import audiotabs_tpu_torch.runtime.pipeline, audiotabs_tpu_torch.runtime.batch_runner\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert not FORBIDDEN & set(json.loads(out.strip().replace("'", '"')))


def own_reference_modules() -> dict[str, str]:
    """Every module that a configuration's ``reference_modules`` names, with its file."""
    return {m: f for c in (BENCH / "configs").glob("*.json") for m, f in json.loads(c.read_text()).get("reference_modules", {}).items()}


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}]\n"
        "import reference.runtime.pipeline, reference.runtime.batch_runner, reference.models.htdemucs\n"
        "from core.configured import reference_modules\n"
        "from pathlib import Path\n"
        f"for module, file in {own_reference_modules()!r}.items():\n"
        f"    with reference_modules({{module: file}}, Path({str(ROOT)!r})):\n"
        "        import reference.runtime.pipeline, reference.runtime.batch_runner\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert not (FORBIDDEN | {"audiotabs_tpu_torch"}) & set(json.loads(out.strip().replace("'", '"')))
    for path in [*(BENCH / "reference").rglob("*.py"), *(BENCH / f for f in own_reference_modules().values())]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            assert not {n.split(".")[0] for n in names} & (FORBIDDEN | {"audiotabs_tpu_torch"}), path


def test_no_result_when_the_run_loaded_jax(monkeypatch, capsys):
    import types

    import run
    from core import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(runner, "run_cell", lambda *a: ({"correct": True}, []))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "mix-clip30", "--seed", str(BIG_SEED), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
