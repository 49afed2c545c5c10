"""Audio decode, write and resampling (counterpart of audiotabs_tpu/io/).

The JAX package's ``resample_kernel_jax`` is ``resample_kernel`` here."""

from .resample import resample_kernel, resample_poly_host
from .wav import decode_to_mono_44k, load_wav, peak_normalize, read_wav, write_wav

__all__ = [
    "load_wav",
    "read_wav",
    "write_wav",
    "peak_normalize",
    "decode_to_mono_44k",
    "resample_poly_host",
    "resample_kernel",
]
