"""The median kernel (``csrc/median_filter.cu`` via ``ops/median.py``): its
byte bound over its time, %. The bound sums, over the launches of the
window, each input byte read once and each output byte written once at
3.35 TB/s; the time sums the trace's kernels whose name holds ``median_``."""

from core.work import HBM_BYTES_PER_S, median_bytes


def read(run):
    busy = sum(e - s for name, s, e in run.device if "median_" in name) / 1e6
    bound = sum(median_bytes(n) for n in run.launches.get("median", [])) / HBM_BYTES_PER_S
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None
