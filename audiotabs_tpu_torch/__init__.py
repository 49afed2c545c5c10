"""audiotabs_tpu_torch: the PyTorch + CUDA port of audiotabs_tpu for NVIDIA Hopper.

The JAX package ``audiotabs_tpu`` stays the reference; this package imports
nothing of it and no JAX. The ported slice so far is the song analysis:
audio file → htdemucs separation (``models/htdemucs.py``) → fused device
features and beat times (``runtime.pipeline.run_analysis``), with the HPSS
sliding median on a hand-written CUDA kernel (``ops/median.py``,
``csrc/median_filter.cu``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
