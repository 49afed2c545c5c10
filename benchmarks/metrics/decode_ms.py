"""Host decode (``io/wav.py``, ``io/native.py``, ``io/resample.py``): the
mean of the window's songs' ``profile.json`` ``decode`` stage, ms a song."""


def read(run):
    values = [d.profile["decode"] for d in run.done if d.profile and "decode" in d.profile]
    return 1e3 * sum(values) / len(values) if values else None
