"""The DBN kernel (``csrc/dbn_viterbi.cu`` via ``decode/dbn_beats.py``): its
bound over its time, %. The bound of each launch of the window is the
largest of its adds at 128 and its compares at 64 a clock on 132 SMs at
1,980 MHz, and its bytes at 3.35 TB/s (``core/work.py::dbn_work``); the time
sums the trace's kernels whose name holds ``dbn_viterbi``."""

from core.work import bound_s, dbn_work


def read(run):
    busy = sum(e - s for name, s, e in run.device if "dbn_viterbi" in name) / 1e6
    bound = sum(bound_s(*dbn_work(shape[0], shape[1], **grid)) for shape, grid in run.launches.get("dbn", []))
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None
