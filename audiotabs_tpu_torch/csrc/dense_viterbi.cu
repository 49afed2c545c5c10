// Max-product Viterbi with a dense [S, S] log-transition matrix: the forward
// pass and the backtrack of a batch of sequences, one launch.
//
// Replaces the two lax.scans of audiotabs_tpu/decode/viterbi.py::viterbi_log_dense
// (the forward scan at :79 and the backtrack at :86), which decode the CRF
// chord states inside the JAX package's device program.
//
// Each frame t: for each target state j, the maximum over source states i
// of score[i] + trans[i, j] and its first argmax (the backpointer), then the
// frame's log-emission of j is added. The backtrack starts from the first
// maximum of the last score; the last score's maximum is returned too.
//
// Exactness. The emissions, transitions and initial scores come from the
// caller (log_softmax and the checkpoint's tables in torch); this kernel
// only adds and compares, the sums of the plain loop of decode/viterbi.py,
// so the two agree bit for bit. A maximum is the same in any order, so the
// forward pass takes only maxima, NaN-propagating ones (max.NaN.f32), as
// jnp.max and torch.max propagate a NaN. It keeps, per frame, the score
// vector and each target's maximum; the backtrack recomputes, for the one
// state the path is in, the sums of its sources and takes the first that
// equals that maximum or, when the maximum is a NaN, the first NaN: the
// argmax of jnp.argmax and torch.argmax, lowest index on a tie.
//
// Bound. The CRF decode of a song is 301 frames of 25 states: 2 x 25 x 25
// adds and maxima per frame, about 0.38 M operations (0.01 us at 132 SMs x
// 128 FP32 lanes x 1.98 GHz), and about 32 KB of emissions and path (0.01 us
// at 3.35 TB/s). What bounds it on the card is the chain of dependent
// frames: each frame needs the whole score of the one before. What the
// design does about that, for S <= 32 (every path's 25 states): one warp per
// sequence and no block barrier. Lane j keeps the column trans[:, j] in
// registers; a frame's score goes to shared memory once and every lane reads
// it back as broadcast 16-byte loads after a __syncwarp; the 32 sums are
// independent and a max tree of depth 5 reduces them. The emissions are
// staged into shared memory kChunk frames ahead by cp.async, so no device
// load sits on the frame chain. Each frame's score and maxima go to device
// memory (fire and forget). The backtrack is the same warp: per frame one
// shuffle for the state's maximum, one shared-memory load of the transition
// and one ballot, with the records loaded kRound frames ahead. For 33 to
// 1,024 states a block per sequence: a group of G lanes per target state
// splits the sources, reduces by xor shuffles, and one barrier separates
// frames; warp 0 then walks the records back.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <climits>

// clock stamps for scripts/decoder_clock_split.py, which defines them; nothing otherwise
#ifndef SPLIT
#define SPLIT_START
#define SPLIT(part)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStates = 1024;
constexpr int kWarpStates = 32;  // the warp layout: one lane per target state
constexpr int kChunk = 128;      // frames of emissions staged at a time (warp layout)
constexpr int kRound = 16;       // frames of records the warp layout's backtrack loads ahead
constexpr int kTrStride = 33;    // the shared transition matrix's row stride: lane i reads row i, no bank conflict
constexpr int kStageFloats = 10240;  // emissions staged at a time by the block layout (40 KB)

// max.NaN.f32: a NaN when either input is one, as torch.max and jnp.max
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// An integer key whose signed order is the float order, every NaN above
// every number (torch.argmax takes a NaN for the maximum); -0 and +0 share
// the key of +0 (the sum with +0 turns -0 into +0).
__device__ __forceinline__ int max_key(float v) {
  if (v != v) return INT_MAX;
  const int i = __float_as_int(__fadd_rn(v, 0.0f));
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// Whether v is the argmax's pick among sums whose NaN-propagating maximum is
// m: equal to it or, when m is a NaN, a NaN itself (no sum is a NaN unless m is)
__device__ __forceinline__ bool hits_max(float v, float m) { return v == m || v != v; }

// The first state holding the maximum of the warp's scores (state
// k * 32 + lane in v[k], K words; lanes past S hold INT_MIN keys).
template <int K>
__device__ __forceinline__ int first_max(const float (&v)[K], int S, int lane) {
  int key[K];
  int local = INT_MIN;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    key[k] = k * 32 + lane < S ? max_key(v[k]) : INT_MIN;
    local = max(local, key[k]);
  }
  const int mk = __reduce_max_sync(kFull, local);
  int arg = -1;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const unsigned hit = __ballot_sync(kFull, key[k] == mk);
    if (hit) arg = k * 32 + __ffs(hit) - 1;
  }
  return arg;
}

// a 4-byte copy from device to shared memory that does not wait
__device__ __forceinline__ void copy_async4(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::); }

// frames t0 .. t0 + kChunk - 1 of a sequence's emissions [T, S] into the
// staging buffer dst, by the warp's lanes, in the background
__device__ __forceinline__ void stage(float* dst, const float* em_b, int t0, int T, int S, int lane) {
  const int n = min(kChunk, T - t0) * S;
  for (int x = lane; x < n; x += 32) copy_async4(dst + x, em_b + static_cast<size_t>(t0) * S + x);
  copies_commit();
}

// The warp layout (S <= 32): one warp per sequence. The records of frame t
// (t < T - 1) are rec[t][0][j], the score after frame t, and rec[t][1][j],
// the maximum entering frame t + 1 (before its emission).
__global__ void __launch_bounds__(32)
dense_viterbi_kernel_warp(const float* __restrict__ em,     // [B, T, S]
                          const float* __restrict__ trans,  // [S, S] (from, to)
                          const float* __restrict__ init,   // [S]
                          float* __restrict__ rec,          // [B, T - 1, 2, 32]
                          int* __restrict__ path,           // [B, T]
                          float* __restrict__ best,         // [B]
                          int T, int S) {
  __shared__ __align__(16) float score[2][kWarpStates];
  __shared__ float ems[2][kChunk * kWarpStates];
  __shared__ float tr[kWarpStates * kTrStride];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const bool on = lane < S;
  const float* em_b = em + static_cast<size_t>(b) * T * S;
  float* rec_b = rec + static_cast<size_t>(b) * (T > 1 ? T - 1 : 1) * 2 * kWarpStates;
  SPLIT_START;

  stage(ems[0], em_b, 0, T, S, lane);

  // lane j's transition column (sources past S add 0 to a -inf score), the
  // matrix in shared memory for the backtrack, the padding scores
  float col[kWarpStates];
#pragma unroll
  for (int i = 0; i < kWarpStates; ++i) col[i] = on && i < S ? __ldg(trans + i * S + lane) : 0.0f;
  for (int x = lane; x < S * S; x += 32) tr[(x / S) * kTrStride + x % S] = __ldg(trans + x);

  copies_done();
  __syncwarp();
  if (T > kChunk) stage(ems[1], em_b, kChunk, T, S, lane);
  // every lane stores, without a branch: lanes past S keep -inf scores, and
  // their records fill the padding
  float v = on ? init[lane] + ems[0][lane] : -INFINITY;
  score[0][lane] = v;
  if (T > 1) rec_b[lane] = v;
  __syncwarp();
  SPLIT(6);  // the staging of the first chunk, the columns, frame 0

  int c = 1;  // the frame's place in its staged chunk
  for (int t = 1; t < T; ++t, ++c) {
    if (c == kChunk) {
      // every lane is past the previous frame's __syncwarp, so the buffer of the chunk before is free
      copies_done();
      __syncwarp();
      c = 0;
      if (t + kChunk < T) stage(ems[(t / kChunk + 1) & 1], em_b, t + kChunk, T, S, lane);
      SPLIT(3);  // the chunk's wait
    }
    const float4* cur = reinterpret_cast<const float4*>(score[(t - 1) & 1]);
    float x[kWarpStates];
#pragma unroll
    for (int q = 0; q < kWarpStates / 4; ++q) {
      const float4 s4 = cur[q];
      x[4 * q] = s4.x + col[4 * q];
      x[4 * q + 1] = s4.y + col[4 * q + 1];
      x[4 * q + 2] = s4.z + col[4 * q + 2];
      x[4 * q + 3] = s4.w + col[4 * q + 3];
    }
    // the max tree over the 32 sums, 5 levels
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = max_nan(x[i], x[i + 16]);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = max_nan(x[i], x[i + 8]);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = max_nan(x[i], x[i + 4]);
    x[0] = max_nan(x[0], x[2]);
    x[1] = max_nan(x[1], x[3]);
    const float m = max_nan(x[0], x[1]);
    SPLIT(0);  // the 32 sums and the max tree
    v = on ? m + ems[(t / kChunk) & 1][c * S + (on ? lane : 0)] : -INFINITY;
    score[t & 1][lane] = v;
    float* r = rec_b + static_cast<size_t>(t - 1) * 2 * kWarpStates;
    r[kWarpStates + lane] = m;
    if (t < T - 1) r[2 * kWarpStates + lane] = v;
    SPLIT(1);  // the emission, the score and the records
    __syncwarp();
    SPLIT(2);  // the __syncwarp
  }

  // the first maximum of the last score, and the path back from it
  const float last[1] = {v};
  int s = first_max<1>(last, S, lane);
  const float vs = __shfl_sync(kFull, v, s);
  int* path_b = path + static_cast<size_t>(b) * T;
  if (lane == 0) {
    best[b] = vs;
    path_b[T - 1] = s;
  }
  SPLIT(4);  // the final argmax

  // frame t's state: the first source i whose score[t][i] + trans[i][s]
  // hits the maximum that entered state s at frame t + 1. Lane k of a round
  // keeps the state of frame hi - k; the next round's records load ahead.
  const float* tr_lane = tr + lane * kTrStride;  // row `lane` of the transitions
  float h[kRound], mx[kRound];
#pragma unroll
  for (int k = 0; k < kRound; ++k) {
    const int t = T - 2 - k;
    const float* r = rec_b + static_cast<size_t>(t > 0 ? t : 0) * 2 * kWarpStates;
    h[k] = t >= 0 ? r[lane] : 0.0f;
    mx[k] = t >= 0 ? r[kWarpStates + lane] : 0.0f;
  }
  for (int hi = T - 2; hi >= 0; hi -= kRound) {
    float h_next[kRound], mx_next[kRound];
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int t = hi - kRound - k;
      const float* r = rec_b + static_cast<size_t>(t > 0 ? t : 0) * 2 * kWarpStates;
      h_next[k] = t >= 0 ? r[lane] : 0.0f;
      mx_next[k] = t >= 0 ? r[kWarpStates + lane] : 0.0f;
    }
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      if (hi - k >= 0) {  // the same for every lane
        const float m = __shfl_sync(kFull, mx[k], s);
        const float sum = h[k] + tr_lane[s];  // lanes past S read padding, which no ballot takes
        s = __ffs(__ballot_sync(kFull, on & hits_max(sum, m))) - 1;
        if (lane == k) mine = s;
      }
    }
    if (lane < kRound && hi - lane >= 0) path_b[hi - lane] = mine;
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      h[k] = h_next[k];
      mx[k] = mx_next[k];
    }
  }
  SPLIT(5);  // the backtrack
}

// The block layout (33 to 1,024 states): a group of G lanes per target state
// (G a power of two, S G <= 1,024 threads), each lane the sources l, l + G, ...;
// one barrier per frame. Records as the warp layout's, of width S.
__global__ void __launch_bounds__(kMaxStates)
dense_viterbi_kernel_block(const float* __restrict__ em,     // [B, T, S]
                           const float* __restrict__ trans,  // [S, S] (from, to)
                           const float* __restrict__ init,   // [S]
                           float* __restrict__ rec,          // [B, T - 1, 2, S]
                           int* __restrict__ path,           // [B, T]
                           float* __restrict__ best,         // [B]
                           int T, int S, int G, int chunk) {
  extern __shared__ float smem[];
  float* score = smem;           // [2][S]
  float* ems = score + 2 * S;    // [chunk][S]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int l = tid % G;
  const bool active = tid / G < S;
  const int j = active ? tid / G : S - 1;  // an idle group mirrors the last state and stores nothing
  const bool owner = active && l == 0;
  const float* em_b = em + static_cast<size_t>(b) * T * S;
  float* rec_b = rec + static_cast<size_t>(b) * (T > 1 ? T - 1 : 1) * 2 * S;

  int c = chunk;  // the frame's place in the staged chunk
  for (int t = 0; t < T; ++t, ++c) {
    if (c == chunk) {
      // every thread is past the previous frame's barrier, so the old chunk is free
      const int n = min(chunk, T - t) * S;
      for (int x = tid; x < n; x += blockDim.x) ems[x] = em_b[static_cast<size_t>(t) * S + x];
      c = 0;
      __syncthreads();
    }
    float m = -INFINITY;
    if (t > 0) {
      const float* cur = score + ((t - 1) & 1) * S;
      for (int i = l; i < S; i += G) m = max_nan(m, cur[i] + __ldg(trans + static_cast<size_t>(i) * S + j));
      for (int off = G / 2; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, off));
    }
    if (owner) {
      const float v = (t > 0 ? m : init[j]) + ems[c * S + j];
      score[(t & 1) * S + j] = v;
      if (t > 0) rec_b[(static_cast<size_t>(t - 1) * 2 + 1) * S + j] = m;
      if (t < T - 1) rec_b[static_cast<size_t>(t) * 2 * S + j] = v;
    }
    __syncthreads();
  }
  if (tid >= 32) return;

  // warp 0: the first maximum of the last score, then the path back
  const float* fin = score + ((T - 1) & 1) * S;
  int mk = INT_MIN;
  for (int i = lane; i < S; i += 32) mk = max(mk, max_key(fin[i]));
  mk = __reduce_max_sync(kFull, mk);
  int s = -1;
  for (int i0 = 0; s < 0 && i0 < S; i0 += 32) {
    const unsigned hit = __ballot_sync(kFull, i0 + lane < S && max_key(fin[i0 + lane]) == mk);
    if (hit) s = i0 + __ffs(hit) - 1;
  }
  int* path_b = path + static_cast<size_t>(b) * T;
  if (lane == 0) {
    best[b] = fin[s];
    path_b[T - 1] = s;
  }
  for (int t = T - 2; t >= 0; --t) {
    const float* r = rec_b + static_cast<size_t>(t) * 2 * S;
    const float m = r[S + s];
    int next = -1;
    for (int i0 = 0; next < 0 && i0 < S; i0 += 32) {
      const int i = i0 + lane;
      const bool hit = i < S && hits_max(r[i] + __ldg(trans + static_cast<size_t>(i) * S + s), m);
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hits) next = i0 + __ffs(hits) - 1;
    }
    s = next;
    if (lane == 0) path_b[t] = s;
  }
}

}  // namespace

extern "C" {

// em float32 [B, T, S], trans [S, S], init [S]; rec float32 [B, max(T - 1, 1),
// 2, max(S, 32)] scratch; path int32 [B, T]; best float32 [B]. All
// contiguous, on the device.
int dense_viterbi_f32(const void* em, const void* trans, const void* init, void* rec, void* path, void* best,
                      int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > kMaxStates) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const float*>(em);
  const auto* tr = static_cast<const float*>(trans);
  const auto* in = static_cast<const float*>(init);
  auto* r = static_cast<float*>(rec);
  auto* p = static_cast<int*>(path);
  auto* bs = static_cast<float*>(best);
  if (S <= kWarpStates) {
    dense_viterbi_kernel_warp<<<B, 32, 0, st>>>(e, tr, in, r, p, bs, T, S);
  } else {
    int G = 32;
    while (S * G > kMaxStates) G >>= 1;
    const int threads = (S * G + 31) / 32 * 32;
    const int chunk = kStageFloats / S;
    dense_viterbi_kernel_block<<<B, threads, sizeof(float) * (2 + chunk) * S, st>>>(e, tr, in, r, p, bs, T, S, G, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
