"""The golden corpus of the trainers' acceptance gates.

Counterpart of audiotabs_tpu/train/golden.py, whose gates read a reference
job (its input WAV and ``out/`` artifacts) from a fixed directory outside
this repository. The repository does not hold that corpus, so
``golden_available()`` is False, as in the JAX package without it, and the
port's trainers leave the golden gates out: their reports hold what the JAX
trainers report when the corpus is absent.
"""

from __future__ import annotations


def golden_available(*artifacts: str) -> bool:
    """True when the golden input WAV and every named ``out/`` artifact
    exist; the repository holds no golden corpus, so never."""
    return False
