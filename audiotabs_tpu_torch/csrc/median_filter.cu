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
// Bound: the bytes are one read and one write of the tensor (about 3 us for
// [1025, 1292] at 3.35 TB/s), but an odd-even transposition network costs
// win*(win-1)/2 compare-exchanges per output (465 for win 31), so this kernel
// is bound by min/max throughput, well above the byte bound. What the design
// does about the bytes: each block stages its tile plus the (win-1) halo in
// shared memory once, with edge indices clamped instead of padding a copy,
// and every thread then reads its window from shared memory into registers
// and sorts it there; global memory is touched once per element in and once
// per element out. A cheaper selection network is later work.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch; it launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Tile shape: along the median axis the tile carries the halo.
template <bool ALONG_FAST>
struct Tile {
  static constexpr int kFast = ALONG_FAST ? 128 : 32;  // outputs along fast axis
  static constexpr int kSlow = ALONG_FAST ? 8 : 32;    // outputs along slow axis
};

// Stage the tile plus halo in shared memory, with clamped (edge-replicated)
// indices. Threads walk the fast axis fastest, so loads coalesce.
template <int WIN, bool ALONG_FAST>
__device__ __forceinline__ void load_tile(const float* __restrict__ xb, float* tile,
                                          int n_slow, int n_fast, int s0, int f0) {
  constexpr int HALF = WIN / 2;
  constexpr int SF = Tile<ALONG_FAST>::kFast + (ALONG_FAST ? WIN - 1 : 0);
  constexpr int SS = Tile<ALONG_FAST>::kSlow + (ALONG_FAST ? 0 : WIN - 1);
  for (int i = threadIdx.x; i < SS * SF; i += blockDim.x) {
    const int ss = i / SF;
    const int sf = i - ss * SF;
    const int gs = clampi(s0 + ss - (ALONG_FAST ? 0 : HALF), 0, n_slow - 1);
    const int gf = clampi(f0 + sf - (ALONG_FAST ? HALF : 0), 0, n_fast - 1);
    tile[i] = xb[(int64_t)gs * n_fast + gf];
  }
}

// Register version for the main-path windows: the window is read into
// registers and sorted by a fully unrolled odd-even transposition network
// (the TPU kernel's algorithm); the middle register is the median.
template <int WIN, bool ALONG_FAST>
__global__ void __launch_bounds__(kThreads)
median_net_kernel(const float* __restrict__ x, float* __restrict__ y, int n_slow, int n_fast) {
  constexpr int TF = Tile<ALONG_FAST>::kFast;
  constexpr int TS = Tile<ALONG_FAST>::kSlow;
  constexpr int SF = TF + (ALONG_FAST ? WIN - 1 : 0);
  constexpr int SS = TS + (ALONG_FAST ? 0 : WIN - 1);
  __shared__ float tile[SS * SF];

  const int64_t plane = (int64_t)n_slow * n_fast;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int f0 = blockIdx.x * TF;
  const int s0 = blockIdx.y * TS;
  load_tile<WIN, ALONG_FAST>(xb, tile, n_slow, n_fast, s0, f0);
  __syncthreads();

  for (int o = threadIdx.x; o < TS * TF; o += blockDim.x) {
    const int os = o / TF;
    const int of = o - os * TF;
    const int gs = s0 + os;
    const int gf = f0 + of;
    if (gs >= n_slow || gf >= n_fast) continue;
    float v[WIN];
#pragma unroll
    for (int k = 0; k < WIN; ++k)
      v[k] = ALONG_FAST ? tile[os * SF + of + k] : tile[(os + k) * SF + of];
#pragma unroll
    for (int rnd = 0; rnd < WIN; ++rnd) {
#pragma unroll
      for (int k = rnd & 1; k < WIN - 1; k += 2) {
        const float a = v[k];
        const float b = v[k + 1];
        v[k] = fminf(a, b);
        v[k + 1] = fmaxf(a, b);
      }
    }
    yb[(int64_t)gs * n_fast + gf] = v[WIN / 2];
  }
}

// Any other odd window below 128: rank selection over the staged window.
// The median is the element whose rank interval [less, less + equal) holds
// win/2, which is exact for ties too. O(win^2) shared-memory reads, so it
// is kept off the main path.
template <bool ALONG_FAST>
__global__ void __launch_bounds__(kThreads)
median_rank_kernel(const float* __restrict__ x, float* __restrict__ y, int n_slow, int n_fast,
                   int win) {
  constexpr int TF = Tile<ALONG_FAST>::kFast;
  constexpr int TS = Tile<ALONG_FAST>::kSlow;
  extern __shared__ float tile[];
  const int half = win / 2;
  const int SF = TF + (ALONG_FAST ? win - 1 : 0);
  const int SS = TS + (ALONG_FAST ? 0 : win - 1);

  const int64_t plane = (int64_t)n_slow * n_fast;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int f0 = blockIdx.x * TF;
  const int s0 = blockIdx.y * TS;
  for (int i = threadIdx.x; i < SS * SF; i += blockDim.x) {
    const int ss = i / SF;
    const int sf = i - ss * SF;
    const int gs = clampi(s0 + ss - (ALONG_FAST ? 0 : half), 0, n_slow - 1);
    const int gf = clampi(f0 + sf - (ALONG_FAST ? half : 0), 0, n_fast - 1);
    tile[i] = xb[(int64_t)gs * n_fast + gf];
  }
  __syncthreads();

  const int step = ALONG_FAST ? 1 : SF;
  for (int o = threadIdx.x; o < TS * TF; o += blockDim.x) {
    const int os = o / TF;
    const int of = o - os * TF;
    const int gs = s0 + os;
    const int gf = f0 + of;
    if (gs >= n_slow || gf >= n_fast) continue;
    const float* w = tile + os * SF + of;
    float med = w[0];
    for (int k = 0; k < win; ++k) {
      const float c = w[k * step];
      int less = 0, equal = 0;
      for (int j = 0; j < win; ++j) {
        const float u = w[j * step];
        less += u < c;
        equal += u == c;
      }
      if (less <= half && half < less + equal) {
        med = c;
        break;
      }
    }
    yb[(int64_t)gs * n_fast + gf] = med;
  }
}

template <bool ALONG_FAST>
cudaError_t launch(const float* x, float* y, int batch, int n_slow, int n_fast, int win,
                   cudaStream_t stream) {
  constexpr int TF = Tile<ALONG_FAST>::kFast;
  constexpr int TS = Tile<ALONG_FAST>::kSlow;
  const dim3 grid((n_fast + TF - 1) / TF, (n_slow + TS - 1) / TS, batch);
  switch (win) {
    case 5:
      median_net_kernel<5, ALONG_FAST><<<grid, kThreads, 0, stream>>>(x, y, n_slow, n_fast);
      break;
    case 17:
      median_net_kernel<17, ALONG_FAST><<<grid, kThreads, 0, stream>>>(x, y, n_slow, n_fast);
      break;
    case 31:
      median_net_kernel<31, ALONG_FAST><<<grid, kThreads, 0, stream>>>(x, y, n_slow, n_fast);
      break;
    default: {
      const size_t smem = sizeof(float) * (size_t)(TS + (ALONG_FAST ? 0 : win - 1)) *
                          (size_t)(TF + (ALONG_FAST ? win - 1 : 0));
      median_rank_kernel<ALONG_FAST><<<grid, kThreads, smem, stream>>>(x, y, n_slow, n_fast, win);
    }
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
