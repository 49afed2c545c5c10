// The refractory "wait" rule of onset peak picking over a batch of envelopes:
// a candidate frame fires only when more than `wait` frames have passed since
// the last frame that fired.
//
// Replaces the lax.scan of audiotabs_tpu/ops/onset.py::onset_detect_frames
// (:70), which carries the last onset frame through the envelope inside the
// JAX package's device program. The candidates (local maximum and mean plus
// delta) stay torch operations; only the carried rule is here.
//
// Bound. Each frame reads one byte and writes one: 2 bytes per frame, about
// 10 KB for the four calibration envelopes of a chunk (2,585 frames): a few
// nanoseconds at 3.35 TB/s, and a compare and a select per frame. What bounds
// this kernel on the card is the chain of T dependent frames of each row: a
// row is serial in time. What the design does about that: one thread per
// row walks its row in one launch, where the plain loop issues a group of
// launches per frame; the rows (a chunk's envelopes, or 20 content windows
// per song) run side by side.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
onset_wait_kernel(const uint8_t* __restrict__ cand, uint8_t* __restrict__ fired, int R, int T, int wait) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const uint8_t* c = cand + static_cast<size_t>(r) * T;
  uint8_t* f = fired + static_cast<size_t>(r) * T;
  long long last = -static_cast<long long>(wait) - 1;
  for (int t = 0; t < T; ++t) {
    const bool fire = c[t] != 0 && t - last > wait;
    if (fire) last = t;
    f[t] = fire ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// cand, fired: contiguous bool (one byte each) [R, T] on the device.
int onset_wait_u8(const void* cand, void* fired, int R, int T, int wait, void* stream) {
  if (R < 1 || T < 1) return -1;
  const int blocks = (R + kThreads - 1) / kThreads;
  onset_wait_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cand), static_cast<uint8_t*>(fired), R, T, wait);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
