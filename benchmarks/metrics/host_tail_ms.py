"""The host tail (``_pipeline_tail``: beats to export): the mean over the
window's songs of the sum of their ``profile.json`` stages after the fused
analysis, ms a song."""

NOT_TAIL = ("decode", "separation", "analysis")


def read(run):
    values = [sum(v for k, v in d.profile.items() if k not in NOT_TAIL) for d in run.done if d.profile]
    return 1e3 * sum(values) / len(values) if values else None
