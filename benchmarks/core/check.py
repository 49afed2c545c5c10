"""The check that decides ``correct``: the plain reference (``reference/``,
which imports nothing of the program) run again on the songs the window
produced, and compared with what the timed path produced for them.

Four numbers, each the worst over the songs compared:

- ``stem_err``: separation's stems, the largest relative L1 gap
  (sum |program - reference| / sum |reference|) over the stems;
- ``feature_err``: the fused analysis' float outputs, the largest relative
  L1 gap over them;
- ``decoded_err``: its discrete outputs (the DBN's phases and intervals,
  the chord paths, the content windows' starts, the beat-source gate), the
  largest share of elements that differ;
- ``result_err``: the host tail, the count of the ``JobResult``'s fields
  and beat times that differ from those of the reference's tail. Where the
  reference's host features equal the program's bit for bit, its tail runs
  on its own features, so the whole song is held against an independent
  path; where they differ within their limits, its tail runs on the
  program's features, so that rounding cannot flip a discrete choice of the
  tail (a note over its threshold) in a sound run.

With ``tf32`` the reference computes in TF32 (matmul and cuDNN), the
precision below the configuration's float32: the lower-precision control."""

from __future__ import annotations

import contextlib
import json
import math
import tempfile
from pathlib import Path

import numpy as np
import torch

NUMBERS = ("stem_err", "feature_err", "decoded_err", "result_err")


def rel_l1(prog, ref) -> float:
    p = torch.as_tensor(np.asarray(prog) if not isinstance(prog, torch.Tensor) else prog).to(torch.float64)
    r = torch.as_tensor(np.asarray(ref) if not isinstance(ref, torch.Tensor) else ref).to(device=p.device, dtype=torch.float64)
    if p.shape != r.shape:
        return math.inf
    gap, norm = float((p - r).abs().sum()), float(r.abs().sum())
    if gap != gap:  # a NaN on either side
        return math.inf
    return gap / norm if norm > 0 else (0.0 if gap == 0 else math.inf)


def tree_diff(a, b) -> int:
    """The count of leaves of two JSON values that differ (a missing leaf differs)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return sum(tree_diff(a.get(k), b.get(k)) for k in set(a) | set(b))
    if isinstance(a, list) and isinstance(b, list):
        return abs(len(a) - len(b)) + sum(tree_diff(x, y) for x, y in zip(a, b))
    return int(a != b)


def compare(prog: dict, ref: dict, tail: dict | None) -> dict[str, float]:
    """The numbers for one song. ``prog`` and ``ref``: {"stems": [S, L] or
    None, "feats": host features}, and ``prog`` also {"result", "beats"};
    ``tail``: {"result", "beats"} of the reference's tail on the program's
    features (None for the control, whose tail is the reference's own)."""
    out = {"feature_err": 0.0, "decoded_err": 0.0}
    if prog.get("stems") is not None or ref.get("stems") is not None:
        ps, rs = prog.get("stems"), ref.get("stems")
        out["stem_err"] = math.inf if ps is None or rs is None or len(ps) != len(rs) else max(
            rel_l1(p, r) for p, r in zip(ps, rs))
    pf, rf = prog["feats"], ref["feats"]
    for k in set(pf) | set(rf):
        if k not in pf or k not in rf or np.shape(pf[k]) != np.shape(rf[k]):
            out["feature_err"] = math.inf
            continue
        p, r = np.asarray(pf[k]), np.asarray(rf[k])
        if np.issubdtype(r.dtype, np.floating):
            out["feature_err"] = max(out["feature_err"], rel_l1(p, r))
        else:
            out["decoded_err"] = max(out["decoded_err"], float(np.mean(p != r)) if r.size else 0.0)
    if tail is not None:
        out["result_err"] = float(tree_diff(prog["result"], tail["result"]) + tree_diff(prog["beats"], tail["beats"]))
    return out


def same_features(a: dict, b: dict) -> bool:
    """Whether two host feature dicts are equal bit for bit (a NaN equals a NaN)."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if not np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"):
            return False
    return True


def tail_features(own: dict, prog: dict | None, tally: list[int]) -> dict:
    """The features the reference's tail runs on: its own, unless the
    program's differ from them (see ``result_err``). ``tally`` counts
    [tails on the reference's own features, tails]."""
    use_own = prog is None or same_features(own, prog)
    tally[0] += use_own
    tally[1] += 1
    return own if use_own else prog


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    return {k: max(r[k] for r in readings) for k in NUMBERS if readings and all(k in r for r in readings)}


class Reference:
    """The plain reference on ``device`` under a configuration's settings."""

    def __init__(self, overrides: dict, device: torch.device, tf32: bool = False, tmp: Path | None = None):
        from reference.config import Settings

        self.s = Settings(**overrides)
        self.dev, self.tf32, self.tmp = device, tf32, tmp
        self.tally = [0, 0]  # tails on the reference's own features, tails

    @contextlib.contextmanager
    def _precision(self):
        from reference.runtime import pipeline as rp

        saved = torch.backends.cuda.matmul.allow_tf32, rp.TF32
        torch.backends.cuda.matmul.allow_tf32, rp.TF32 = self.tf32, self.tf32
        try:
            with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=self.tf32):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, rp.TF32 = saved

    @contextlib.contextmanager
    def _stems(self):
        from reference.models import htdemucs

        kept, fn = [], htdemucs.separate_program

        def keep(*args, **kwargs):
            kept.append(fn(*args, **kwargs))
            return kept[-1]

        htdemucs.separate_program = keep
        try:
            yield kept
        finally:
            htdemucs.separate_program = fn

    def _job(self):
        return tempfile.TemporaryDirectory(dir=self.tmp)

    def single(self, path: Path, job_id: str, prog_feats: dict | None) -> tuple[dict, dict]:
        """One song through ``run_pipeline``'s steps → ({"stems", "feats"},
        the tail's {"result", "beats"} on ``tail_features``)."""
        from reference.runtime import pipeline as rp

        errors: list[str] = []
        with self._precision(), self._stems() as kept:
            a = rp._analyse(Path(path), self.dev, self.s, rp.StageTimer(), errors, strict=True)
        feats = tail_features(a.feats, prog_feats, self.tally)
        with self._job() as d, self._precision():
            out = Path(d) / job_id / "out"
            out.mkdir(parents=True)
            (out.parent / "work").mkdir()
            result = rp._pipeline_tail(
                feats=feats, y_harm=np.asarray(feats["y_harm"], dtype=np.float32)[: a.true_len], y=a.y,
                true_len=a.true_len, sr=rp.ANALYSIS_SR, work=out.parent / "work", out=out, job_id=job_id,
                timer=rp.StageTimer(), errors=list(errors), stem_source=a.stem_source,
                beat_act_from_feats=a.beat_act_from_feats, beat_source=a.beat_source, y_native=a.native,
                settings=self.s, device=self.dev,
            )
            tail = {"result": result.to_dict(), "beats": _beats(out)}
        return {"stems": kept[0] if kept else None, "feats": a.feats}, tail

    def batch(self, paths: list[Path], rows: list[int], prog_feats: dict[int, dict]) -> dict[int, tuple[dict, dict]]:
        """``transcribe_batch``'s steps on ``paths`` for the rows ``rows``:
        each chunk that holds one of them through separation and the fused
        analysis, and the tail of each on ``tail_features``."""
        from reference.runtime import batch_runner as rb
        from reference.runtime import pipeline as rp

        batch, true_lens, sr = rb._load_and_bucket(paths, self.s.PAD_SECONDS_BUCKET)
        true_lens = np.asarray(true_lens, dtype=np.int32)
        sep_cfg, model, stem_name = rb._resolve_separation(self.s, sr, self.dev)
        chunk = max(1, int(self.s.BATCH_SONGS_PER_DEVICE))
        out = {}
        for lo in range(0, len(paths), chunk):
            hi = min(lo + chunk, len(paths))
            if not any(lo <= r < hi for r in rows):
                continue
            with self._precision(), self._stems() as kept:
                y = torch.from_numpy(np.ascontiguousarray(batch[lo:hi], dtype=np.float32)).to(self.dev)
                host = rp.features_to_host(rb._analyse_chunk(y, true_lens[lo:hi], sr, self.s, sep_cfg, model))
            for r in range(lo, hi):
                if r not in rows:
                    continue
                feats = {k: v[r - lo] for k, v in host.items()}
                tail_feats = tail_features(feats, prog_feats.get(r), self.tally)
                with self._job() as d, self._precision():
                    job = Path(d) / paths[r].stem
                    result = rp.run_pipeline_from_features(tail_feats, int(true_lens[r]), sr, job, paths[r].stem,
                                                           stem_source=stem_name, settings=self.s, device=self.dev)
                    tail = {"result": result.to_dict(), "beats": _beats(job / "out")}
                out[r] = ({"stems": kept[0][r - lo] if kept else None, "feats": feats}, tail)
        return out


def _beats(out: Path):
    path = out / "beat_times.json"
    return json.loads(path.read_text()) if path.exists() else None
