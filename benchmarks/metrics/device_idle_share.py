"""The device: the share of the traced window in which no kernel, copy or
set ran on the card (the union of the profiler's device intervals), %."""


def read(run):
    return 100.0 * (1.0 - run.busy_s / run.window_s) if run.window_s > 0 else None
