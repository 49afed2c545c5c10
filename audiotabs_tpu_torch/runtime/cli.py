"""Debug/e2e CLI: run the pipeline on a local audio file.

The port of audiotabs_tpu/runtime/cli.py. Runs on the card unless
``--device cpu`` is given:

    python -m audiotabs_tpu_torch.runtime.cli song.wav [--job-dir DIR] [--mode guitar|notes|accompaniment] [--device cpu]

Writes ``<job dir>/out/result.json`` beside the pipeline's artifacts, and
removes ``work/`` unless ``--keep`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import time
import uuid
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="audiotabs_tpu_torch debug transcribe")
    ap.add_argument("audio", type=Path)
    ap.add_argument("--job-dir", type=Path, default=None)
    ap.add_argument("--mode", choices=("guitar", "notes", "accompaniment"), default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--keep", action="store_true", help="keep work/ intermediates")
    args = ap.parse_args(argv)

    from ..config import Settings
    from .pipeline import run_pipeline
    from .storage import LocalStorage

    settings = Settings.from_env()
    if args.mode:
        settings = dataclasses.replace(settings, TRANSCRIPTION_MODE=args.mode)

    job_id = uuid.uuid4().hex
    storage = LocalStorage(args.job_dir.parent if args.job_dir else settings.DATA_DIR)
    job_dir = args.job_dir or storage.data_dir / "jobs" / job_id
    for sub in ("input", "work", "out"):
        (job_dir / sub).mkdir(parents=True, exist_ok=True)

    input_path = job_dir / "input" / f"upload{args.audio.suffix}"
    shutil.copy(args.audio, input_path)
    (job_dir / "input" / "meta.json").write_text(json.dumps({"filename": args.audio.name}))

    t0 = time.perf_counter()
    result = run_pipeline(job_dir, input_path, device=args.device, settings=settings)
    wall = time.perf_counter() - t0

    (job_dir / "out" / "result.json").write_text(result.to_json())
    print(f"job dir: {job_dir}")
    print(f"wall:    {wall:.2f}s")
    print(f"tempo:   {result.tempo_bpm:.1f} bpm")
    print(f"key:     {result.key_signature.name if result.key_signature else 'n/a'}")
    print(f"chords:  {len(result.chords)} segments")
    print(f"backend: {result.transcription_backend}")
    if result.score:
        print(f"score:   {len(result.score.measures)} measures")
    if result.transcription_error:
        print(f"errors:  {result.transcription_error}")
    if not args.keep:
        shutil.rmtree(job_dir / "work", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
