"""audiotabs_tpu_torch: the PyTorch + CUDA port of audiotabs_tpu for NVIDIA Hopper.

The JAX package ``audiotabs_tpu`` stays the reference; this package imports
nothing of it, no JAX and no pydantic. The ported slice is the main path:
audio file → htdemucs separation (``models/htdemucs.py``) → fused device
features (``runtime/fused.py``) → one transfer → the numpy host tail (beats,
calibration, notes, chords, key, guitar or accompaniment mode, quantisation,
tab) → the artifact set (``runtime.pipeline.run_pipeline``, and the CLI
``python -m audiotabs_tpu_torch.runtime.cli song.wav --job-dir DIR``), with
the HPSS sliding median on a hand-written CUDA kernel (``ops/median.py``,
``csrc/median_filter.cu``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
