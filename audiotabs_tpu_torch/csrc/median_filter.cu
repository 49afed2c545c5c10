// Exact sliding-window median along one axis of a float32 tensor, for HPSS.
//
// Replaces the TPU kernel audiotabs_tpu/ops/pallas_median.py::_median_kernel.
// Semantics are the same: odd window below 128, edges replicated, output has
// the input's shape, and the result is an element of the input (no averaging).
//
// The tensor is seen as [batch, n_slow, n_fast] with n_fast contiguous. The
// median runs along the fast axis (time of an [F, T] spectrogram) or along
// the slow axis (frequency) through the ALONG_FAST template flag, so the
// frequency-direction median needs no transposed copy; a batch of
// spectrograms is the grid's z index.
//
// Bound. The bytes are one read and one write of the tensor: 3.2 us for
// [1025, 1292] at 3.35 TB/s. A min or max (FMNMX) issues at 64 per SM per
// clock on compute capability 9.0, half the FP32 FMA rate, so an output that
// costs c of them takes c * n / (132 * 64 * f_sm) for n outputs. The TPU
// kernel's odd-even transposition sort costs win*(win-1) min/max per output
// (930 at win 31: about 74 us for [1025, 1292] at 1.98 GHz), 23 times the
// byte bound. What the design does about it: each thread computes K adjacent
// outputs along the median axis from the win+K-1 values their windows span,
// loaded into registers once, and runs a straight-line selection network
// generated by ops/median.py::median_schedule (the header median_schedule.h):
// the K windows share one pruned sort of their common core, a recursive split
// merges in the values each half of them adds, and only the ranks that can
// still be a median are kept. At win 31 with K 16 that is 518 min/max for
// 16 outputs (32.4 per output, about 2.6 us for [1025, 1292] at 1.98 GHz);
// at win 17 with K 8, 176 for 8 (22 per output). The issue bound is then
// near the byte bound. Shared-memory reads fall to (win+K-1)/K per output.
//
// Layout. A block covers 32 lanes across the median axis (one per thread of
// a warp) and `along` outputs along it. It stages their window rows, edge
// indices clamped instead of padding a copy, in shared memory as
// tile[along position][lane] with a pitch of 33 floats, so a warp's reads of
// one row hit 32 banks, and so does the transposing store of the along-fast
// load. Warps take the block's K-output segments in turn. Along the slow
// axis a warp's 32 outputs are neighbours in memory and go straight out;
// along the fast axis they are staged in shared memory and written along
// rows. `along` is chosen per launch: the fewest blocks of at most 128
// outputs, evened out, so a 130-frame axis is two blocks of 72 rather than
// 128 + 2. A thread whose segment runs past the edge reads clamped values
// and its stores are masked.
//
// Windows without a network (any other odd window below 128) take a rank
// selection kernel over the same tile: O(win^2) shared-memory reads per
// output, off the main path.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch; it launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "median_schedule.h"  // generated: MedianNet<WIN>, MEDIAN_NET_WINDOWS

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPitch = 33;  // floats per staged row
constexpr int kMaxAlongNet = 128;
constexpr int kMaxAlongRank = 64;  // keeps a 127 window's tile under 48 KB

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One block's share of one [n_slow, n_fast] plane: lanes c0..c0+31 across
// the median axis, outputs a0..a0+along-1 along it.
template <bool ALONG_FAST>
struct Plane {
  const float* x;
  float* y;
  int n_fast, n_along, n_across, a0, c0, along;
  float* tile;  // [along + win - 1][kPitch] input rows
  float* out;   // [along][kPitch] staged outputs (ALONG_FAST only)

  __device__ Plane(const float* x_, float* y_, int n_slow, int n_fast_, int along_, int win, float* smem)
      : n_fast(n_fast_), along(along_), tile(smem), out(smem + (along_ + win - 1) * kPitch) {
    const int64_t plane = (int64_t)n_slow * n_fast_;
    x = x_ + blockIdx.z * plane;
    y = y_ + blockIdx.z * plane;
    n_along = ALONG_FAST ? n_fast_ : n_slow;
    n_across = ALONG_FAST ? n_slow : n_fast_;
    a0 = blockIdx.y * along_;
    c0 = blockIdx.x * 32;
  }

  // Stage rows a0-half .. a0+along+half-1, indices clamped (edges
  // replicated; lanes past the edge read the last line and store nothing).
  __device__ void load(int win) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rows = along + win - 1, first = a0 - win / 2;
    if (ALONG_FAST) {  // a warp reads a run of one line, the along axis
      for (int c = warp; c < 32; c += kWarps) {
        const float* line = x + (int64_t)min(c0 + c, n_across - 1) * n_fast;
        for (int a = lane; a < rows; a += 32) tile[a * kPitch + c] = line[clampi(first + a, 0, n_along - 1)];
      }
    } else {  // a warp reads 32 neighbours of one line
      const int gc = min(c0 + lane, n_across - 1);
      for (int a = warp; a < rows; a += kWarps)
        tile[a * kPitch + lane] = x[(int64_t)clampi(first + a, 0, n_along - 1) * n_fast + gc];
    }
  }

  __device__ __forceinline__ void put(int a, int lane, float v) {
    if (ALONG_FAST)
      out[a * kPitch + lane] = v;
    else if (a0 + a < n_along && c0 + lane < n_across)
      y[(int64_t)(a0 + a) * n_fast + c0 + lane] = v;
  }

  // Along the fast axis: write the staged outputs along their rows.
  __device__ void flush() {
    if (!ALONG_FAST) return;
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = min(along, n_along - a0);
    for (int c = warp; c < 32 && c0 + c < n_across; c += kWarps) {
      float* line = y + (int64_t)(c0 + c) * n_fast + a0;
      for (int a = lane; a < n; a += 32) line[a] = out[a * kPitch + c];
    }
  }
};

template <int WIN, bool ALONG_FAST>
__global__ void __launch_bounds__(kThreads)
median_net_kernel(const float* __restrict__ x, float* __restrict__ y, int n_slow, int n_fast, int along) {
  using Net = MedianNet<WIN>;
  constexpr int K = Net::kOutputs;
  extern __shared__ float smem[];
  Plane<ALONG_FAST> p(x, y, n_slow, n_fast, along, WIN, smem);
  p.load(WIN);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int s = (threadIdx.x >> 5) * K; s < along; s += kWarps * K) {
    float r[Net::kRegs], m[K];
#pragma unroll
    for (int k = 0; k < WIN + K - 1; ++k) r[k] = p.tile[(s + k) * kPitch + lane];
    Net::run(r, m);
#pragma unroll
    for (int k = 0; k < K; ++k) p.put(s + k, lane, m[k]);
  }
  p.flush();
}

// The median is the element whose rank interval [less, less + equal) holds
// win/2, which is exact for ties too.
template <bool ALONG_FAST>
__global__ void __launch_bounds__(kThreads)
median_rank_kernel(const float* __restrict__ x, float* __restrict__ y, int n_slow, int n_fast, int along,
                   int win) {
  extern __shared__ float smem[];
  Plane<ALONG_FAST> p(x, y, n_slow, n_fast, along, win, smem);
  p.load(win);
  __syncthreads();
  const int lane = threadIdx.x & 31, half = win / 2;
  for (int a = threadIdx.x >> 5; a < along; a += kWarps) {
    const float* w = p.tile + a * kPitch + lane;
    float med = w[0];
    for (int k = 0; k < win; ++k) {
      const float c = w[k * kPitch];
      int less = 0, equal = 0;
      for (int j = 0; j < win; ++j) {
        const float u = w[j * kPitch];
        less += u < c;
        equal += u == c;
      }
      if (less <= half && half < less + equal) {
        med = c;
        break;
      }
    }
    p.put(a, lane, med);
  }
  p.flush();
}

// Outputs along the median axis per block: the fewest blocks of at most
// max_along, evened out and rounded up to whole segments of k.
int along_per_block(int n_along, int k, int max_along) {
  const int blocks = (n_along + max_along - 1) / max_along;
  const int per = (n_along + blocks - 1) / blocks;
  return (per + k - 1) / k * k;
}

template <bool ALONG_FAST>
cudaError_t launch(const float* x, float* y, int batch, int n_slow, int n_fast, int win, cudaStream_t stream) {
  const int n_along = ALONG_FAST ? n_fast : n_slow;
  const int n_across = ALONG_FAST ? n_slow : n_fast;
  int k = 1, max_along = kMaxAlongRank;
  switch (win) {
#define NET_OUTPUTS_CASE(W)              \
  case W:                                \
    k = MedianNet<W>::kOutputs;          \
    max_along = kMaxAlongNet;            \
    break;
    MEDIAN_NET_WINDOWS(NET_OUTPUTS_CASE)
#undef NET_OUTPUTS_CASE
  }
  const int along = along_per_block(n_along, k, max_along);
  const dim3 grid((n_across + 31) / 32, (n_along + along - 1) / along, batch);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * kPitch * (size_t)(along + win - 1 + (ALONG_FAST ? along : 0));
  switch (win) {
#define NET_LAUNCH_CASE(W)                                                                         \
  case W:                                                                                          \
    median_net_kernel<W, ALONG_FAST><<<grid, kThreads, smem, stream>>>(x, y, n_slow, n_fast, along); \
    break;
    MEDIAN_NET_WINDOWS(NET_LAUNCH_CASE)
#undef NET_LAUNCH_CASE
    default:
      median_rank_kernel<ALONG_FAST><<<grid, kThreads, smem, stream>>>(x, y, n_slow, n_fast, along, win);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: contiguous float32 [batch, n_slow, n_fast] on the device.
// along_fast != 0: median along the contiguous axis; else along n_slow.
// Returns the cudaError_t of the launch (0 on success); 1 for bad arguments.
int median_filter_f32(const void* x, void* y, int batch, int n_slow, int n_fast, int win,
                      int along_fast, void* stream) {
  if (win < 1 || win >= 128 || (win & 1) == 0 || batch < 1 || n_slow < 1 || n_fast < 1 ||
      batch > 65535)
    return 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const cudaError_t err = along_fast ? launch<true>(xf, yf, batch, n_slow, n_fast, win, s)
                                     : launch<false>(xf, yf, batch, n_slow, n_fast, win, s);
  return static_cast<int>(err);
}

}  // extern "C"
