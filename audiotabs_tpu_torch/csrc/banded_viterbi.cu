// pYIN's Viterbi over [voiced bins | unvoiced bins] with banded pitch moves:
// the forward pass and the backtrack of a batch of rows, one launch.
//
// Replaces the two lax.scans of audiotabs_tpu/ops/pyin.py::_banded_viterbi
// (the forward scan at :171 and the backtrack at :185), which the JAX
// package vmaps over the content windows inside its device program.
//
// The state of a row is two float32 score vectors of n_bins, voiced (sv) and
// unvoiced (su). Each frame, for each bin b and each layer, the max-plus
// propagation max_d s[b + d] + log_tri[d] over d in [-band, band] (first
// maximum; bins outside the range are -inf) gives pv / pu and the offset of
// the winner; then the new voiced score is max(pv + log_stay, pu + log_switch)
// plus the voiced observation, switching only when strictly better, and the
// unvoiced one the same way round. The backtrack, from the best final state
// (voiced on a tie), follows the layer flag and then that layer's offset.
//
// Exactness. log_tri, log_stay, log_switch, the initial score and the
// observations come from the caller, computed as the plain loop of
// ops/pyin.py computes them; this kernel only adds and compares, in that
// loop's order, so the two agree bit for bit.
//
// Bound. The content windows of one song are 20 rows of 130 frames of 241
// bins: 51 candidate adds and maxima per bin and layer per frame, about
// 0.53 G operations for a chunk of four songs (80 rows), about 0.016 ms at
// 132 SMs x 128 FP32 lanes x 1.98 GHz; the observations read (two
// [80, 130, 241] float32 arrays, 20 MB) take about 6 us at 3.35 TB/s. So
// operations bound it. A
// row is a chain of 130 dependent frames. What the design does about that:
// one block per row, one thread per bin, the two score vectors in shared
// memory (two barriers per frame, no device-memory round trip for the
// state); the rows run on separate SMs. The four backpointer arrays (int8
// offsets, byte flags) go to device memory, read once by the backtrack on
// one thread.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBins = 1024;

// max-plus propagation at bin b: the first maximum of s[b + k - band] +
// tri[k] over the k whose bin lies in [0, n_bins); the others are -inf and
// can never be the first maximum, as one valid k (k = band) always exists.
__device__ __forceinline__ float propagate(const float* s, const float* tri, int b, int n_bins, int band,
                                           int* arg) {
  const int k0 = max(0, band - b);
  const int k1 = min(2 * band, n_bins - 1 - b + band);
  float best = s[b + k0 - band] + tri[k0];
  int bk = k0;
  for (int k = k0 + 1; k <= k1; ++k) {
    const float v = s[b + k - band] + tri[k];
    if (v > best) {
      best = v;
      bk = k;
    }
  }
  *arg = bk - band;
  return best;
}

__global__ void __launch_bounds__(kMaxBins)
banded_viterbi_kernel(const float* __restrict__ obs_v,    // [R, T, n_bins]
                      const float* __restrict__ obs_u,    // [R, T, n_bins]
                      const float* __restrict__ log_tri,  // [2 band + 1]
                      float log_stay, float log_switch, float init,
                      int8_t* __restrict__ bp_av,         // [R, T, n_bins]
                      int8_t* __restrict__ bp_au,
                      uint8_t* __restrict__ bp_v_from_u,
                      uint8_t* __restrict__ bp_u_from_v,
                      int64_t* __restrict__ bins,         // [R, T]
                      uint8_t* __restrict__ voiced,       // [R, T]
                      int T, int n_bins, int band) {
  extern __shared__ float smem[];
  float* sv = smem;
  float* su = sv + n_bins;
  float* tri = su + n_bins;

  const int r = blockIdx.x;
  const int b = threadIdx.x;
  for (int k = b; k < 2 * band + 1; k += blockDim.x) tri[k] = log_tri[k];
  if (b < n_bins) {
    sv[b] = init;
    su[b] = init;
  }
  __syncthreads();

  const size_t row = static_cast<size_t>(r) * T * n_bins;
  for (int t = 0; t < T; ++t) {
    float nv = 0.0f, nu = 0.0f;
    if (b < n_bins) {
      int av, au;
      const float pv = propagate(sv, tri, b, n_bins, band, &av);
      const float pu = propagate(su, tri, b, n_bins, band, &au);
      const float nv_stay = pv + log_stay, nv_sw = pu + log_switch;
      const float nu_stay = pu + log_stay, nu_sw = pv + log_switch;
      const bool v_from_u = nv_sw > nv_stay;
      const bool u_from_v = nu_sw > nu_stay;
      const size_t at = row + static_cast<size_t>(t) * n_bins + b;
      nv = (v_from_u ? nv_sw : nv_stay) + obs_v[at];
      nu = (u_from_v ? nu_sw : nu_stay) + obs_u[at];
      bp_av[at] = static_cast<int8_t>(av);
      bp_au[at] = static_cast<int8_t>(au);
      bp_v_from_u[at] = v_from_u;
      bp_u_from_v[at] = u_from_v;
    }
    __syncthreads();
    if (b < n_bins) {
      sv[b] = nv;
      su[b] = nu;
    }
    __syncthreads();
  }
  if (b != 0) return;

  // the end state: voiced when its best score is at least the unvoiced one;
  // each argmax the first maximum
  float mv = sv[0], mu = su[0];
  int iv = 0, iu = 0;
  for (int k = 1; k < n_bins; ++k) {
    if (sv[k] > mv) {
      mv = sv[k];
      iv = k;
    }
    if (su[k] > mu) {
      mu = su[k];
      iu = k;
    }
  }
  bool is_v = mv >= mu;
  int bin = is_v ? iv : iu;
  for (int t = T - 1; t >= 0; --t) {
    bins[static_cast<size_t>(r) * T + t] = bin;
    voiced[static_cast<size_t>(r) * T + t] = is_v;
    const size_t at = row + static_cast<size_t>(t) * n_bins + bin;
    // the previous layer, then the offset from that layer
    const bool prev_is_v = is_v ? !bp_v_from_u[at] : bp_u_from_v[at];
    const int delta = prev_is_v ? bp_av[at] : bp_au[at];
    bin = min(max(bin + delta, 0), n_bins - 1);
    is_v = prev_is_v;
  }
}

}  // namespace

extern "C" {

// obs_v, obs_u: contiguous float32 [R, T, n_bins]; log_tri float32 [2 band + 1];
// bp_av, bp_au int8 and bp_v_from_u, bp_u_from_v bool scratch [R, T, n_bins];
// bins int64 and voiced bool [R, T]. All on the device.
int banded_viterbi_f32(const void* obs_v, const void* obs_u, const void* log_tri, float log_stay, float log_switch,
                       float init, void* bp_av, void* bp_au, void* bp_v_from_u, void* bp_u_from_v, void* bins,
                       void* voiced, int R, int T, int n_bins, int band, void* stream) {
  if (R < 1 || T < 1 || n_bins < 1 || n_bins > kMaxBins || band < 1 || band > 127) return -1;
  const int threads = (n_bins + 31) / 32 * 32;
  const int smem = static_cast<int>(sizeof(float) * (2 * n_bins + 2 * band + 1));
  banded_viterbi_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs_v), static_cast<const float*>(obs_u), static_cast<const float*>(log_tri),
      log_stay, log_switch, init, static_cast<int8_t*>(bp_av), static_cast<int8_t*>(bp_au),
      static_cast<uint8_t*>(bp_v_from_u), static_cast<uint8_t*>(bp_u_from_v), static_cast<int64_t*>(bins),
      static_cast<uint8_t*>(voiced), T, n_bins, band);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
