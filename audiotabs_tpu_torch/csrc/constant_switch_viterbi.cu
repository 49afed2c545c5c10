// Min-cost Viterbi with a constant switch penalty (the template chord
// backend): the forward pass and the backtrack of a batch of sequences, one
// launch.
//
// Replaces the two lax.scans of
// audiotabs_tpu/decode/viterbi.py::viterbi_constant_switch (the forward scan
// at :46 and the backtrack at :54).
//
// Each frame t, in the order of the JAX step: m = min(dp) and argm, the
// FIRST state reaching it; switch = m + penalty; a state stays (its
// backpointer is itself) when dp[s] <= switch, a tie included, and comes
// from argm otherwise; dp[s] = min(dp[s], switch) + logp[s, t]. The
// backtrack starts from the first minimum of the last dp.
//
// Exactness. The costs logp = -log(clamp(emissions, 1e-9, 1)) come from the
// caller (torch takes every logarithm); this kernel only adds, compares and
// selects, so it agrees with the plain loop of decode/viterbi.py bit for bit.
// The minimum is taken over order-preserving integer keys of the floats:
// -0 and +0 share a key, and a NaN takes the least key, so a NaN cost wins
// the minimum and spreads, as torch.min, torch.argmin and torch.minimum do.
//
// Bound. A 30 s song is 301 frames of 49 states (majmin7; 61 for
// majmin7plus): per frame S compares for the minimum, S for the stay test
// and S + 1 adds, about 45,000 operations (well under a microsecond at 132
// SMs), and 59 KB of costs read and 1.2 KB of path written (0.02 us at
// 3.35 TB/s). What bounds it is the chain of dependent frames: each one
// needs the minimum of the one before. What the design does about that: one
// warp per sequence, each lane holding K = ceil(S / 32) states in registers,
// so a frame needs no barrier: the minimum is one integer warp reduction
// (redux.sync) over the keys, its first state K ballots; the next frame's
// costs are loaded a frame ahead, and the loop over frames is unrolled by 4
// so that those loads need no register move. The backpointers of a frame
// are stored as K ballot words of the states that stay plus argm, so the
// backtrack's loads do not depend on the state it walks: the warp loads 32
// frames' records at once and walks them through shuffles.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWords = 2;  // at most 64 states: the largest vocabulary, majmin7plus, has 61

// An integer key whose signed order is the float order: -0 and +0 share the
// key of +0 (the sum with +0 turns -0 into +0), every NaN takes INT_MIN.
__device__ __forceinline__ int min_key(float v) {
  if (v != v) return INT_MIN;
  const int i = __float_as_int(__fadd_rn(v, 0.0f));
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// The float of a key (a NaN for INT_MIN).
__device__ __forceinline__ float key_value(int k) {
  if (k == INT_MIN) return __int_as_float(0x7fc00000);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The least key over the warp's states and the first state holding it
// (state s = k * 32 + lane; a smaller k is a smaller state).
template <int K>
__device__ __forceinline__ int first_min(const int (&key)[K], int& arg) {
  int local = key[0];
#pragma unroll
  for (int k = 1; k < K; ++k) local = min(local, key[k]);
  const int mk = __reduce_min_sync(kFull, local);
  arg = -1;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const unsigned hit = __ballot_sync(kFull, key[k] == mk);
    if (hit) arg = k * 32 + __ffs(hit) - 1;
  }
  return mk;
}

template <int K>
__global__ void __launch_bounds__(32)
constant_switch_viterbi_kernel(const float* __restrict__ logp,  // [B, S, T]
                               unsigned* __restrict__ rec,       // [B, T - 1, K + 1]
                               int* __restrict__ path,           // [B, T]
                               int T, int S, float penalty) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* lp = logp + static_cast<size_t>(b) * S * T;
  unsigned* rec_b = rec + static_cast<size_t>(b) * (T > 1 ? T - 1 : 1) * (K + 1);

  bool valid[K];
  const float* row[K];
  float dp[K], x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    valid[k] = s < S;
    row[k] = lp + static_cast<size_t>(valid[k] ? s : 0) * T;
    dp[k] = valid[k] ? __ldg(row[k]) : 0.0f;
    x[k] = valid[k] && T > 1 ? __ldg(row[k] + 1) : 0.0f;
  }

  int key[K];
#pragma unroll 4
  for (int t = 1; t < T; ++t) {
    float next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      next[k] = valid[k] && t + 1 < T ? __ldg(row[k] + t + 1) : 0.0f;
      key[k] = valid[k] ? min_key(dp[k]) : INT_MAX;
    }
    int argm;
    const float sw = __fadd_rn(key_value(first_min<K>(key, argm)), penalty);
    unsigned* r = rec_b + static_cast<size_t>(t - 1) * (K + 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool stay = dp[k] <= sw;  // false for a NaN: the NaN switch cost spreads
      const unsigned words = __ballot_sync(kFull, valid[k] && stay);
      if (lane == k) r[k] = words;
      dp[k] = __fadd_rn(stay ? dp[k] : sw, x[k]);
      x[k] = next[k];
    }
    if (lane == K) r[K] = static_cast<unsigned>(argm);
  }

#pragma unroll
  for (int k = 0; k < K; ++k) key[k] = valid[k] ? min_key(dp[k]) : INT_MAX;
  int s;
  first_min<K>(key, s);

  // backtrack: path[t] = bp_t[path[t + 1]], 32 frames a round; lane j of a
  // round holds the record of frame hi - j, and keeps the state of that frame
  int* path_b = path + static_cast<size_t>(b) * T;
  if (lane == 0) path_b[T - 1] = s;
  for (int hi = T - 2; hi >= 0; hi -= 32) {
    const int t = hi - lane;
    unsigned w[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) w[k] = t >= 0 ? rec_b[static_cast<size_t>(t) * (K + 1) + k] : 0u;
    const int n = hi + 1 < 32 ? hi + 1 : 32;
    int mine = 0;
    for (int j = 0; j < n; ++j) {
      unsigned word = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned v = __shfl_sync(kFull, w[k], j);
        if ((s >> 5) == k) word = v;
      }
      const int from = static_cast<int>(__shfl_sync(kFull, w[K], j));
      s = (word >> (s & 31)) & 1u ? s : from;
      if (lane == j) mine = s;
    }
    if (t >= 0) path_b[t] = mine;
  }
}

template <int K>
cudaError_t launch(const float* logp, unsigned* rec, int* path, int B, int T, int S, float penalty, cudaStream_t stream) {
  constant_switch_viterbi_kernel<K><<<B, 32, 0, stream>>>(logp, rec, path, T, S, penalty);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logp float32 [B, S, T]; rec int32 [B, max(T - 1, 1), ceil(S / 32) + 1]
// scratch; path int32 [B, T]. All contiguous, on the device.
int constant_switch_viterbi_f32(const void* logp, void* rec, void* path, int B, int T, int S, float penalty, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > 32 * kMaxWords) return -1;
  const auto* lp = static_cast<const float*>(logp);
  auto* r = static_cast<unsigned*>(rec);
  auto* p = static_cast<int*>(path);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = S <= 32 ? launch<1>(lp, r, p, B, T, S, penalty, st) : launch<2>(lp, r, p, B, T, S, penalty, st);
  return static_cast<int>(err);
}

}  // extern "C"
