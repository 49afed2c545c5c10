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
// this kernel on the card is the chain of the row's onsets: each one decides
// where the next may be. What the design does about that: one warp per row
// (kWarps rows per block), and a walk whose steps are the onsets, not the
// frames. A round of the row is 1,024 frames: at each of 32 steps the lanes
// read 32 adjacent candidate bytes and a ballot packs them into one 32-bit
// word, which lane k keeps (bit i: frame base + 32 k + i). The walk starts
// from next = last + wait + 1: each lane masks its word to the frames at or
// after next and takes its first bit (__ffs), and one integer warp minimum
// (redux.sync) gives the first candidate of all; that frame fires, next
// moves past it by wait + 1, and the walk repeats until no lane has one. A
// word without candidates costs nothing. Then the lanes write the round's
// fired bytes 32 adjacent at a time. Rows longer than 1,024 frames go in
// rounds that carry next. A wait of 0 or less fires every candidate, so the
// word is the fired word.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// clock stamps for scripts/decoder_clock_split.py, which defines them; nothing otherwise
#ifndef SPLIT
#define SPLIT_START
#define SPLIT(part)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;         // rows per block, one warp each
constexpr int kRoundFrames = 1024;  // 32 words of 32 frames

__global__ void __launch_bounds__(kWarps * 32)
onset_wait_kernel(const uint8_t* __restrict__ cand, uint8_t* __restrict__ fired, int R, int T, int wait) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp: no ballot below misses a lane
  const uint8_t* c = cand + static_cast<size_t>(r) * T;
  uint8_t* f = fired + static_cast<size_t>(r) * T;
  long long next = 0;  // the first frame that may fire; frame 0 may, whatever wait is
  SPLIT_START;
  for (int base = 0; base < T; base += kRoundFrames) {
    uint8_t bytes[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int t = base + 32 * k + lane;
      bytes[k] = t < T ? c[t] : 0;
    }
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const unsigned w = __ballot_sync(kFull, bytes[k] != 0);
      if (lane == k) word = w;
    }
    SPLIT(0);  // the round's loads and words

    unsigned out = word;  // a wait of 0 or less: every candidate fires
    if (wait > 0) {
      // the walk in frames of the round: at = next - base, within 0 .. 1,024 + wait
      const int step = min(wait, kRoundFrames) + 1;
      int at = static_cast<int>(min(max(next - base, 0LL), static_cast<long long>(kRoundFrames)));
      int last = -1;  // the round's last onset
      out = 0;
      while (true) {
        const int rel = at - 32 * lane;  // past this lane's word from 32 on
        const unsigned left = rel <= 0 ? word : rel >= 32 ? 0u : word & (kFull << rel);
        const int mine = left ? 32 * lane + __ffs(left) - 1 : INT_MAX;
        const int first = __reduce_min_sync(kFull, mine);  // the first candidate at or after next
        if (first == INT_MAX) break;
        if (first >> 5 == lane) out |= 1u << (first & 31);
        last = first;
        at = first + step;
      }
      if (last >= 0) next = base + last + static_cast<long long>(wait) + 1;
    }
    SPLIT(1);  // the walk

#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const unsigned o = __shfl_sync(kFull, out, k);
      const int t = base + 32 * k + lane;
      if (t < T) f[t] = (o >> lane) & 1u;
    }
    SPLIT(2);  // the stores
  }
}

}  // namespace

extern "C" {

// cand, fired: contiguous bool (one byte each) [R, T] on the device; wait
// from -1 to T (a wait below 0 acts as 0, one above T as T).
int onset_wait_u8(const void* cand, void* fired, int R, int T, int wait, void* stream) {
  if (R < 1 || T < 1) return -1;
  const int blocks = (R + kWarps - 1) / kWarps;
  onset_wait_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cand), static_cast<uint8_t*>(fired), R, T, wait);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
