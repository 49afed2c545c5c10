// Min-cost Viterbi with a constant switch penalty (the template chord
// backend): the forward pass, the backtrack and the confidences of a batch
// of sequences, one launch.
//
// Replaces the two lax.scans of
// audiotabs_tpu/decode/viterbi.py::viterbi_constant_switch (the forward scan
// at :46 and the backtrack at :54) and its gather of the confidences.
//
// Each frame t, in the order of the JAX step: m = min(dp) and argm, the
// FIRST state reaching it; switch = m + penalty; a state stays (its
// backpointer is itself) when dp[s] <= switch, a tie included, and comes
// from argm otherwise; dp[s] = min(dp[s], switch) + logp[s, t]. The
// backtrack starts from the first minimum of the last dp; the confidence of
// frame t is emissions[path[t], t].
//
// Exactness. The costs logp = -log(clamp(emissions, 1e-9, 1)) come from the
// caller (torch takes every logarithm); this kernel only adds, compares and
// selects, so it agrees with the plain loop of decode/viterbi.py bit for
// bit. A NaN cost wins the minimum and spreads, as torch.min, torch.argmin
// and torch.minimum do; -0 and +0 are equal.
//
// Bound. A 30 s song is 301 frames of 49 states (majmin7; 61 for
// majmin7plus): about 45,000 adds and compares (well under a microsecond at
// 132 SMs), and 59 KB of costs read and 2.4 KB of path and confidences
// written (0.02 us at 3.35 TB/s). What bounds it is the chain of dependent
// frames: each needs the minimum of the one before, a reduction across the
// states. What the design does about that:
//  - One warp per sequence (a batch chunk's B sequences are B warps of one
//    launch), each lane holding K = ceil(S / 32) states in registers, so a
//    frame needs no barrier.
//  - The frame's minimum is off the reduction. Rounding is monotone, so
//    min_s(min(dp[s], sw) + x[s]) = min(A, sw + X) exactly, where
//    A = min_s(dp[s] + x[s]), the minimum had every state stayed, and
//    X = min_s x[s]. A needs only the scores before the frame, so its
//    reduction (one redux.sync over order-preserving integer keys) runs a
//    frame ahead, beside the next frame's update; X needs only the costs, and
//    each lane takes it for one frame of the tile when the tile arrives. The
//    chain of a frame is then two adds and a minimum, and the reduction's
//    latency spreads over two frames.
//  - The costs arrive in shared memory as [frame][state] tiles of 32 frames
//    (cp.async, three tiles in flight), so a frame's costs are K
//    conflict-free shared loads, made a frame ahead.
//  - Nothing else waits on the frame: no ballot, no argm, no stay words
//    (each of those, consumed a few instructions after it is made, stalls
//    the warp's in-order issue). A frame stores its scores dp to device
//    scratch (a coalesced store a lane), lane j keeps frame j's minimum m
//    for one store a tile, and the frame goes on.
//  - The backtrack recomputes, per frame, what the forward pass did not
//    keep: state s stays into frame t + 1 when dp_t[s] <= m_t + penalty
//    (the same adds and compare), else the path comes from argm(dp_t), the
//    first state equal to m_t (or a NaN). It walks 32 frames a round with
//    the rounds' scores staged kRing rounds ahead (16-byte cp.async into
//    the tiles' shared memory): a ballot of the frames where s does not
//    stay finds the next switch, the path holds s until there, and only
//    there a ballot over the states finds argm. The confidences are
//    gathered after the walk, many loads in flight.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <climits>

// clock stamps for scripts/decoder_clock_split.py, which defines them; nothing otherwise
#ifndef SPLIT
#define SPLIT_START
#define SPLIT(part)
#define SPLIT_SKIP
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWords = 2;  // at most 64 states: the largest vocabulary, majmin7plus, has 61
constexpr int kTile = 32;     // frames a staged tile holds
constexpr int kBuf = 3;       // tiles in shared memory: the current one, the next (its first frame is read ahead) and one in flight
constexpr int kRing = 3;      // rounds of scores the backtrack stages ahead, in the tiles' shared memory

// min.NaN.f32: a NaN when either input is one, as torch.minimum
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// An integer key whose signed order is the order of the floats that are not
// NaN; -0 sits just below +0, which only the sign of a zero minimum sees.
// A NaN's key is arbitrary: where a sum the keys order is a NaN, the other
// operand of the frame's minimum, sw + X, is a NaN too (a NaN cost makes X
// one, a NaN score made the last minimum one), so the minimum is a NaN
// whatever A is.
__device__ __forceinline__ int min_key(float v) {
  const int i = __float_as_int(v);
  return i ^ ((i >> 31) & 0x7fffffff);
}

// The float of a key: its own inverse.
__device__ __forceinline__ float key_value(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

// a 4-byte copy from device to shared memory that does not wait
__device__ __forceinline__ void copy_async4(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the newest N has landed
template <int N>
__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// frames t0 .. t0 + kTile - 1 of a sequence's costs [S, T] into the tile
// dst [kTile][SP], in the background: lane j copies frame t0 + j of each
// state (a row's 32 frames are one coalesced read)
template <int SP>
__device__ __forceinline__ void stage(float* dst, const float* lp, int t0, int T, int S, int lane) {
  if (t0 + lane < T) {
    const float* src = lp + t0 + lane;
    float* d = dst + lane * SP;
    for (int s = 0; s < S; ++s) copy_async4(d + s, src + static_cast<size_t>(s) * T);
  }
  copies_commit();
}

// The state one frame hands to the next.
template <int K>
struct Carry {
  float dp[K];  // the lane's scores after the frame
  float x[K];   // the costs of the frame it enters (loaded by the frame before)
  float m;      // the frame's minimum
  float sw;     // and that plus the penalty
  int a_key;    // the key of A for the next frame: the least dp[s] + x[s]
  float mj;     // lane j's copy of the minimum of frame j of the tile, stored once a tile
};

// Frame t, the j-th of its tile: the costs of frame t + 1 `next` ([SP]), the
// least cost X of frame t; its scores go to dp_t.
template <int K>
__device__ __forceinline__ void frame(Carry<K>& c, const float* next, float X, float* dp_t, int j, int lane,
                                      const bool (&valid)[K], float penalty) {
  SPLIT_START;
  float xn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) xn[k] = next[k * 32 + lane];  // lanes past S read the tile's padding, which nothing uses
  SPLIT(0);  // the next frame's loads
  // the new scores: stay or switch, min(dp, sw) + x as torch.minimum takes it (a NaN
  // score makes sw a NaN too; at a tie of -0 and +0 only the sign of a zero can differ,
  // and no comparison, and no output, sees it)
  const float sw = c.sw;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c.dp[k] = __fadd_rn(min_nan(c.dp[k], sw), c.x[k]);
    dp_t[k * 32 + lane] = c.dp[k];
  }
  SPLIT(3);  // the update and its store
  // A for the next frame, its least cost had every state stayed
  int local = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) local = min(local, valid[k] ? min_key(__fadd_rn(c.dp[k], xn[k])) : INT_MAX);
  const int a_next = __reduce_min_sync(kFull, local);
  SPLIT(4);  // the next frame's keys and reduction
  // the frame's minimum: min(A, sw + X), exact
  c.m = min_nan(key_value(c.a_key), __fadd_rn(sw, X));
  c.sw = __fadd_rn(c.m, penalty);
  c.mj = lane == j ? c.m : c.mj;
  c.a_key = a_next;
#pragma unroll
  for (int k = 0; k < K; ++k) c.x[k] = xn[k];
  SPLIT(1);  // the minimum and the switch cost
}

// The first state of v (state k * 32 + lane in v[k]) equal to m, or a NaN
// (a NaN minimum is only reached by a NaN score): argmin's first minimum.
template <int K>
__device__ __forceinline__ int first_at(const float (&v)[K], float m, const bool (&valid)[K]) {
  int arg = 0;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const unsigned hit = __ballot_sync(kFull, valid[k] & ((v[k] == m) | (v[k] != v[k])));
    arg = hit ? k * 32 + __ffs(hit) - 1 : arg;
  }
  return arg;
}

// a 16-byte copy from device to shared memory that does not wait (both 16-byte aligned)
__device__ __forceinline__ void copy_async16(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// Round r of the backtrack's scores into its slot of the ring (an empty
// group of copies when the round is not `live`): row j of the slot
// ([32][RS]) holds the scores after frame T - 2 - 32 r - j, 16 bytes a
// copy, and m[j] that frame's minimum
template <int K, int RS>
__device__ __forceinline__ void fetch_round(float* ring, float* ring_m, const float* dp_rec, const float* m_rec, int r, int T,
                                            int lane, bool live) {
  constexpr int kRow4 = 8 * K;  // 16-byte pieces of a row of 32 K scores
  if (live) {
    const int hi = T - 2 - 32 * r;
    float* slot = ring + (r % kRing) * 32 * RS;
#pragma unroll
    for (int u = 0; u < kRow4; ++u) {
      const int j = (u * 32 + lane) / kRow4, q = (u * 32 + lane) % kRow4;
      if (hi - j >= 0) copy_async16(slot + j * RS + 4 * q, dp_rec + static_cast<size_t>(hi - j) * 32 * K + 4 * q);
    }
    if (hi - lane >= 0) copy_async4(ring_m + (r % kRing) * 32 + lane, m_rec + hi - lane);
  }
  copies_commit();
}

template <int K>
__global__ void __launch_bounds__(32)
constant_switch_viterbi_kernel(const float* __restrict__ logp,  // [B, S, T]
                               const float* __restrict__ em,    // [B, S, T]
                               float* __restrict__ rec,         // [B, T, 32 K] scores after each frame, then [B, T] minima
                               int* __restrict__ path,          // [B, T]
                               float* __restrict__ conf,        // [B, T]
                               int B, int T, int S, float penalty) {
  constexpr int SP = 32 * K + 1;  // a tile's row stride: odd, so a column's 32 rows hit 32 banks
  constexpr int RS = 32 * K + 4;  // a backtrack row's stride: 16-byte rows (a column's 32 rows hit 8 banks)
  constexpr int kTiles = kBuf * kTile * SP, kRingFloats = kRing * 32 * RS;
  // the tiles of the forward pass, then the ring of the backtrack
  __shared__ __align__(16) float smem[kTiles > kRingFloats ? kTiles : kRingFloats];
  __shared__ float ring_m[kRing * 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* lp = logp + static_cast<size_t>(b) * S * T;
  float* dp_rec = rec + static_cast<size_t>(b) * T * 32 * K;
  float* m_rec = rec + static_cast<size_t>(B) * T * 32 * K + static_cast<size_t>(b) * T;
  const int n_tiles = (T + kTile - 1) / kTile;
  SPLIT_START;

#pragma unroll
  for (int i = 0; i < kBuf; ++i) stage<SP>(smem + i * kTile * SP, lp, i * kTile, i < n_tiles ? T : 0, S, lane);
  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) valid[k] = k * 32 + lane < S;

  Carry<K> c;
  for (int i = 0; i < n_tiles; ++i) {
    // tiles i and i + 1 have landed (a frame reads the next one's costs)
    copies_wait<kBuf - 2>();
    __syncwarp();
    const float* tl = smem + (i % kBuf) * kTile * SP;
    const float* tn = smem + ((i + 1) % kBuf) * kTile * SP;
    const int t0 = i * kTile;
    const int n = min(kTile, T - t0);
    // lane j: the least cost of frame t0 + j
    float Xl = 0.0f;
    if (lane < n) {
      Xl = tl[lane * SP];
      for (int s = 1; s < S; ++s) Xl = min_nan(Xl, tl[lane * SP + s]);
    }
    int j0 = 0;
    if (i == 0) {
      // frame 0: dp = its costs, their minimum X; A of frame 1
      const float* row1 = T > 1 ? tl + SP : tl;
      int local = INT_MAX;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c.dp[k] = valid[k] ? tl[k * 32 + lane] : 0.0f;
        c.x[k] = row1[k * 32 + lane];
        dp_rec[k * 32 + lane] = c.dp[k];
        local = min(local, valid[k] ? min_key(__fadd_rn(c.dp[k], c.x[k])) : INT_MAX);
      }
      c.a_key = __reduce_min_sync(kFull, local);
      c.m = c.mj = __shfl_sync(kFull, Xl, 0);
      c.sw = __fadd_rn(c.m, penalty);
      j0 = 1;
    }
    SPLIT(6);  // the tile's wait and its least costs (and frame 0)
    float* dp_t = dp_rec + static_cast<size_t>(t0) * 32 * K;
    if (j0 == 0 && n == kTile) {
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        frame<K>(c, j + 1 < kTile ? tl + (j + 1) * SP : tn, __shfl_sync(kFull, Xl, j), dp_t + j * 32 * K, j, lane, valid, penalty);
    } else {
      for (int j = j0; j < n; ++j)
        frame<K>(c, j + 1 < kTile ? tl + (j + 1) * SP : tn, __shfl_sync(kFull, Xl, j), dp_t + j * 32 * K, j, lane, valid, penalty);
    }
    SPLIT_SKIP;    // the frames' own marks count their clocks
    __syncwarp();  // every lane has read tile i before it is refilled
    stage<SP>(smem + (i % kBuf) * kTile * SP, lp, t0 + kBuf * kTile, i + kBuf < n_tiles ? T : 0, S, lane);
    if (lane < n) m_rec[t0 + lane] = c.mj;  // the tile's minima, one store
    SPLIT(7);  // the next tile's staging and the minima's store
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();  // every lane's scores and minima are stored, and the tiles are free

  // Backtrack: the path ends at the first minimum of the last scores.
  float* ring = smem;  // [kRing][32][RS]
  const int n_rounds = (T + 30) / 32;
  for (int r = 0; r < kRing; ++r) fetch_round<K, RS>(ring, ring_m, dp_rec, m_rec, r, T, lane, r < n_rounds);
  int* path_b = path + static_cast<size_t>(b) * T;
  int s = first_at<K>(c.dp, c.m, valid);
  if (lane == 0) path_b[T - 1] = s;
  for (int r = 0; r < n_rounds; ++r) {
    copies_wait<kRing - 1>();
    __syncwarp();
    const float* slot = ring + (r % kRing) * 32 * RS;
    const float* row = slot + lane * RS;  // the scores after frame hi - lane
    const float m = ring_m[(r % kRing) * 32 + lane];
    const float sw = __fadd_rn(m, penalty);
    const int hi = T - 2 - 32 * r;
    const int n = hi + 1 < 32 ? hi + 1 : 32;
    int mine = s;
    for (int j = 0; j < n;) {
      // the first lane from j on whose frame s does not stay into, and the path holds s until there
      const unsigned leave = __ballot_sync(kFull, (lane >= j) & (lane < n) & !(row[s] <= sw));
      const int jn = leave ? __ffs(leave) - 1 : n;
      mine = (lane >= j) & (lane < jn) ? s : mine;
      if (jn == n) break;
      // a switch: the first state at the minimum of frame hi - jn's scores
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = slot[jn * RS + k * 32 + lane];
      s = first_at<K>(v, __shfl_sync(kFull, m, jn), valid);
      mine = lane == jn ? s : mine;
      j = jn + 1;
    }
    if (lane < n) path_b[hi - lane] = mine;
    __syncwarp();  // every lane has read the slot before it is refilled
    fetch_round<K, RS>(ring, ring_m, dp_rec, m_rec, r + kRing, T, lane, r + kRing < n_rounds);
  }
  __syncwarp();  // the path is written before its lanes read it back

  // the confidences, emissions[path[t], t]: independent loads, several in flight
  const float* em_b = em + static_cast<size_t>(b) * S * T;
  float* conf_b = conf + static_cast<size_t>(b) * T;
#pragma unroll 8
  for (int t = lane; t < T; t += 32) conf_b[t] = em_b[static_cast<size_t>(path_b[t]) * T + t];
  SPLIT(5);  // the backtrack and the confidences
}

template <int K>
cudaError_t launch(const float* logp, const float* em, float* rec, int* path, float* conf, int B, int T, int S, float penalty,
                   cudaStream_t stream) {
  constant_switch_viterbi_kernel<K><<<B, 32, 0, stream>>>(logp, em, rec, path, conf, B, T, S, penalty);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logp and em float32 [B, S, T]; rec float32 scratch of B T (32 ceil(S / 32)
// + 1) floats; path int32 [B, T]; conf float32 [B, T]. All contiguous, on
// the device.
int constant_switch_viterbi_f32(const void* logp, const void* em, void* rec, void* path, void* conf, int B, int T, int S,
                                float penalty, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > 32 * kMaxWords) return -1;
  const auto* lp = static_cast<const float*>(logp);
  const auto* e = static_cast<const float*>(em);
  auto* r = static_cast<float*>(rec);
  auto* p = static_cast<int*>(path);
  auto* cf = static_cast<float*>(conf);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = S <= 32 ? launch<1>(lp, e, r, p, cf, B, T, S, penalty, st) : launch<2>(lp, e, r, p, cf, B, T, S, penalty, st);
  return static_cast<int>(err);
}

}  // extern "C"
