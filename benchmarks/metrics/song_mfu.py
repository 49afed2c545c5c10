"""The whole song on the device: the model FLOPs of the window's songs
(``core/flops.py``, from the configuration's widths and the songs' true
lengths, the padding to the bucket not counted) over the traced window's
seconds on the host clock and the float32 peak of 67 TFLOP/s, %. The
configuration computes in float32 with TF32 off, so that is its peak."""

from core.work import F32_PEAK_FLOPS


def read(run):
    return 100.0 * run.song_flops / run.window_s / F32_PEAK_FLOPS if run.song_flops > 0 and run.window_s > 0 else None
