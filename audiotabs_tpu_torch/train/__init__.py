"""Trainers for the port's nets, on the card (``--device cpu`` when asked).

Counterparts of audiotabs_tpu/train/: the same synthetic data
(``synth.py``), the same losses, optimizers, schedules and acceptance gates.
Checkpoints are written in the JAX package's npz layout, so both packages
load them; the default output directory is ``build/weights/``, never the
shipped checkpoints.
"""

from pathlib import Path

# the committed held-out corpus of the trainers' gates: clips no trainer draws
HELDOUT_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "heldout"


def heldout_wavs() -> list[Path]:
    """The held-out corpus' WAVs, sorted (each beside its ground-truth JSON)."""
    return sorted(HELDOUT_DIR.glob("heldout_*.wav"))
