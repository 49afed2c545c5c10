"""The fused analysis (``runtime/fused.py``): device ms a song between CUDA
events recorded around each ``fused_analysis`` (or ``fused_analysis_batch``)
call and around its device-to-host transfer, summed over the window."""


def read(run):
    ms, songs = run.layer_ms.get("fused", (0.0, 0))
    return ms / songs if songs else None
