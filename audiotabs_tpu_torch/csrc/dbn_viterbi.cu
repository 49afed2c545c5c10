// Viterbi over the DBN bar-pointer beat model: the forward pass and the
// backtrack of a batch of songs, one launch.
//
// Replaces the two lax.scans of audiotabs_tpu/decode/dbn_beats.py::_dbn_forward
// (the forward scan at :90 and the backtrack at :104), which run inside the
// JAX package's one device program.
//
// The state of a song is a [n_tempi, P] float32 score (tempo i, phase p; only
// p < L_i is valid, the rest holds -1e30). Each frame t: the score at each
// tempo's last phase, plus the [n_tempi, n_tempi] log tempo-transition
// matrix, gives by max over the source tempo (first maximum) the score that
// enters phase 0 of each target tempo and its backpointer; every other phase
// takes the previous phase's score (a roll); the observation (log activation
// in the beat window p < ceil(L_i / lambda), else the off-beat term) is added
// and invalid phases are set to -1e30 again. The backtrack walks the phases
// down and, at phase 0, follows the backpointer of the tempo.
//
// Exactness. The caller computes every logarithm (observations, initial
// score, transition matrix) with torch and passes it in; this kernel only
// adds and compares, in the order the plain loop of decode/dbn_beats.py uses,
// so the two agree bit for bit. The forward pass takes the maximum entering
// each phase 0 (a max is the same in any order) and keeps each frame's
// last-phase scores; the backtrack recomputes, at each beat, the same sums
// and takes their first maximum: each lane scans its ascending candidates
// with a strict > (a NaN above a number), and the warp then takes the
// largest order-preserving integer key and the lowest index holding it (two
// redux.sync), which gives the first maximum whatever the order. A NaN is
// the maximum, as torch.max and torch.argmax take it: the maxima propagate
// it (max.NaN.f32) and every argmax takes the first NaN.
//
// Bound. One 3,000-frame song needs about 60 M adds and compares (2,999
// frames of 84 x 84 transition candidates, each an add and a compare, and
// 5,754 valid phases, each an add): about 1.3 us at 132 SMs x 128 FP32 adds
// (64 compares) per clock at 1.98 GHz. Its inputs and outputs are about
// 76 KB: 0.02 us at 3.35 TB/s. So operations bound it, but a song is a chain
// of 3,000 dependent frames, and a frame's work (about 16 K operations) fits
// one SM. What the design does about that: one block per song (a batch's
// songs run on separate SMs), and each frame spread over the block behind
// one barrier. Each target tempo j is owned by a group of kLanes lanes of
// one warp. Its lanes split the source tempi into runs of S (the transition
// column in registers, the last-phase scores read as float4 from shared
// memory) and reduce their maxima by xor shuffles, so the critical path is S
// adds and maxima and log2(kLanes) shuffle steps. No argmax is taken there:
// the backtrack needs a backpointer only where the path enters phase 0, once
// a beat. The same group holds tempo j's phases in registers, R per lane
// (lane l: phases l R to l R + R - 1), so the roll is a register move plus
// one shuffle across each lane boundary; phases past L_j hold whatever rolls
// into them and are set to -1e30 once, before the final argmax. The lane that
// holds phase L_j - 1 picks it by a tree of selects over the bits of its slot
// and writes it into a double-buffered vector in shared memory, so one
// barrier separates frames, and into the song's history in device memory
// (fire and forget). The observations are staged in shared memory kChunk
// frames at a time, so no device-memory read is on the frame chain. The
// backtrack, by one warp, recomputes each beat's backpointer from the
// history (84 candidates over 32 lanes) and writes the beat's run of frames
// with its 32 lanes.
//
// Larger grids. The register layouts take up to 128 tempi and 160 phases
// (the shipped grid is 84 and 110). Any other grid the JAX scan takes (at
// 100 fps, a min_bpm below 37.5; the shipped bpm range at 200 fps) takes
// the general layout, one block of 1,024 threads per song. Its score is one
// circular buffer per tempo, sum(L_i) floats: phase p of tempo i at frame t
// lies in slot (p - t) mod L_i, so the roll moves nothing, and the slot that
// held the last phase receives phase 0. The buffer sits in shared memory
// where it fits (19,749 states at (30, 215, 100 fps), 22,605 at
// (55, 215, 200), 44,960 at (20, 300, 100): one copy each, read and
// written in place), else in device memory (the `score` scratch), so only
// device memory bounds the grid (180,195 states at (10, 400, 100)). The
// transition matrix joins it in shared memory where both fit, else the L2
// serves it (281 tempi: 316 KB). A frame is two steps behind a barrier
// each: the targets' maxima (a group of lanes per target splits the sources
// and reduces by shuffles; consecutive lanes hold consecutive targets, so a
// row of the matrix is read coalesced), then each tempo's slots by one warp
// (every slot adds its observation, the phase-0 slot takes the entry). Its
// bound is the register layouts': operations, n^2 + sum(L_i) a frame;
// a frame's n^2 transition reads from the L2 where the matrix stays there.
// It is right first and slow: a frame takes 12 to 120 times the register
// layout's, mostly the slot update (a shared or device load, an add and a
// store per slot) and the transition maximum (fewer lanes per target). The
// argmax rules, the history and the backtrack are the register layouts' own.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take and -2
// when the general layout's per-tempo vectors (5 n floats) do not fit one
// block's shared memory, past about 11,500 tempi (the launcher is the one
// owner of the layout).

#include <cuda_runtime.h>

#include <climits>

// clock stamps for scripts/decoder_clock_split.py, which defines them; nothing otherwise
#ifndef SPLIT
#define SPLIT_START
#define SPLIT(part)
#endif

namespace {

constexpr int kLanes = 8;     // lanes per target tempo: a power of two, within one warp
constexpr int kChunk = 2048;  // frames of observations staged in shared memory at a time
constexpr float kNegInf = -1e30f;

// max.NaN.f32: a NaN when either input is one, as torch.max, torch.maximum and jnp.max
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// an ascending scan's step: a later index wins only a larger value, or a
// NaN over a number (torch.argmax takes a NaN for the maximum)
__device__ __forceinline__ void take_if_above(float& bv, int& bi, float v, int i) {
  if (v > bv || (v != v && bv == bv)) {
    bv = v;
    bi = i;
  }
}

// An integer key whose signed order is the float order, every NaN above
// every number; -0 and +0 share the key of +0.
__device__ __forceinline__ int max_key(float v) {
  if (v != v) return INT_MAX;
  const int i = __float_as_int(__fadd_rn(v, 0.0f));
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// The warp's first maximum of the lanes' (key, index) pairs: the largest
// key, then the lowest index holding it (two integer warp reductions)
__device__ __forceinline__ int first_max_index(int key, int i, int& max_key_out) {
  max_key_out = __reduce_max_sync(0xffffffffu, key);
  return __reduce_min_sync(0xffffffffu, key == max_key_out ? i : INT_MAX);
}

// r[k] for 0 <= k < R by a tree of selects over the bits of k (another k gives any r)
template <int R>
__device__ __forceinline__ float pick(const float (&r)[R], int k) {
  float a[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = r[i];
#pragma unroll
  for (int lvl = 0; (1 << lvl) < R; ++lvl) {
    const bool hi = (k >> lvl) & 1;
#pragma unroll
    for (int i = 0; i + (1 << lvl) < R; i += 2 << lvl) a[i] = hi ? a[i + (1 << lvl)] : a[i];
  }
  return a[0];
}

// The block's first maximum of its threads' (value, flat index) pairs, each
// thread's the first maximum of its own ascending scan (index INT_MAX: none
// held): known to warp 0 after one barrier, whose lanes all return it; the
// other warps return -1.
__device__ __forceinline__ int block_first_max(float bv, int bk, int* red_k, int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int mk;
  int bi = first_max_index(max_key(bv), bk, mk);
  if (lane == 0) {
    red_k[warp] = mk;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return -1;
  const int n_warps = (blockDim.x + 31) / 32;
  return first_max_index(lane < n_warps ? red_k[lane] : INT_MIN, lane < n_warps ? red_i[lane] : INT_MAX, mk);
}

// The backtrack of song b by one warp from the final state bi = tempo P +
// phase: the frames lo .. k of a beat hold one tempo, the phase falling by
// one per earlier frame; at phase 0 the previous frame is at (backpointer of
// the tempo, its last phase), the backpointer the first maximum of the
// last-phase scores after frame lo - 1 plus the transition.
__device__ __forceinline__ void backtrack(int bi, const float* hist_b, const float* __restrict__ log_trans, const int* L,
                                          int* ph_b, int* iv_b, int T, int n, int P) {
  const int lane = threadIdx.x & 31;
  int tempo = bi / P;
  int phase = bi % P;
  int k = T - 1;
  while (true) {
    const int lo = max(k - phase, 0);
    const int Lt = L[tempo];
    for (int f = lo + lane; f <= k; f += 32) {
      ph_b[f] = phase - (k - f);
      iv_b[f] = Lt;
    }
    if (lo == 0) break;
    const float* h = hist_b + static_cast<size_t>(lo - 1) * n;
    float bv = -INFINITY;
    bi = INT_MAX;
    for (int i = lane; i < n; i += 32) {
      take_if_above(bv, bi, h[i] + log_trans[i * n + tempo], i);
    }
    int mk;
    tempo = first_max_index(max_key(bv), bi, mk);
    phase = L[tempo] - 1;
    k = lo - 1;
  }
}

// The shared-memory layout, in floats: the last-phase scores [2][S kLanes],
// the staged observations [2][kChunk], the transition matrix transposed
// [n][S kLanes + 4] when it is not held in registers, the intervals [n], and
// the argmax's (value, index) per warp [32][2].
constexpr size_t smem_floats(int S, bool lt_shared, int n) {
  return 2 * static_cast<size_t>(S) * kLanes + 2 * kChunk + (lt_shared ? static_cast<size_t>(n) * (S * kLanes + 4) : 0) + n + 64;
}

// R phases per lane (P <= R kLanes), S source tempi per lane (n <= S kLanes);
// the transition column in registers, or (kLtShared) in shared memory
template <int R, int S, bool kLtShared>
__global__ void __launch_bounds__(S * kLanes * kLanes)
dbn_viterbi_kernel(const float* __restrict__ init,       // [B, n, P]
                   const float* __restrict__ lo_beat,    // [B, T]
                   const float* __restrict__ lo_off,     // [B, T]
                   const float* __restrict__ log_trans,  // [n, n] (from, to)
                   const int* __restrict__ intervals,    // [n]
                   const int* __restrict__ beat_len,     // [n]: ceil(L / lambda)
                   float* __restrict__ hist,             // [B, T - 1, n]: last-phase scores after frames 0 .. T - 2
                   int* __restrict__ phases,             // [B, T]
                   int* __restrict__ out_intervals,      // [B, T]
                   int T, int n, int P) {
  constexpr int NS = S * kLanes;  // source slots; those past n hold -inf
  constexpr int LT = NS + 4;      // row stride of the shared transition matrix
  extern __shared__ float smem[];
  float* lastv = smem;          // [2][NS]
  float* ob = lastv + 2 * NS;   // [kChunk]: log activation of the staged frames
  float* oo = ob + kChunk;      // [kChunk]: their off-beat term
  float* ltT = oo + kChunk;     // [n][LT] (kLtShared): ltT[j][i] = log_trans[i][j]
  int* L = reinterpret_cast<int*>(ltT + (kLtShared ? n * LT : 0));
  int* red_k = L + n;        // [32]: each warp's largest key
  int* red_i = red_k + 32;   // [32]: its first index

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int l = tid % kLanes;  // lane in the group
  const int g = tid / kLanes;  // the group: target tempo g
  const bool active = g < n;
  const int j = active ? g : n - 1;  // an idle group mirrors the last tempo and stores nothing
  const int Lj = intervals[j];
  const int blj = beat_len[j];
  const int base = l * R;  // this lane's first phase; its slots k are phases base + k
  const int in_row = P - base;     // slots k < in_row lie in the [n, P] score
  const int in_beat = blj - base;  // slots k < in_beat lie in the beat window
  const bool owns_last = active && base <= Lj - 1 && Lj - 1 < base + R;
  SPLIT_START;

  float lt[kLtShared ? 1 : S];
  if constexpr (kLtShared) {
    for (int k = tid; k < n * NS; k += blockDim.x) {
      const int jj = k / NS, i = k % NS;
      ltT[jj * LT + i] = i < n ? log_trans[i * n + jj] : 0.0f;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = l * S + s;
      lt[s] = i < n ? log_trans[i * n + j] : 0.0f;
    }
  }
  for (int k = tid; k < 2 * NS; k += blockDim.x) {
    if (k % NS >= n) lastv[k] = -INFINITY;  // the padding sources never win
  }
  for (int k = tid; k < n; k += blockDim.x) L[k] = intervals[k];

  // the score at frame 0, and tempo j's last phase into buffer 0
  const float* init_j = init + (static_cast<size_t>(b) * n + j) * P;
  float r[R];
#pragma unroll
  for (int k = 0; k < R; ++k) r[k] = k < in_row ? init_j[base + k] : kNegInf;
  float* hist_b = hist + static_cast<size_t>(b) * (T - 1) * n;
  float* hist_j = hist_b + j;  // tempo j's entry of the next frame to keep
  if (owns_last) {
    lastv[j] = init_j[Lj - 1];
    if (T > 1) *hist_j = init_j[Lj - 1];
  }
  // the first frame stages its observations behind a barrier, which also publishes the above
  SPLIT(6);

  const float* lb_b = lo_beat + static_cast<size_t>(b) * T;
  const float* lo_b = lo_off + static_cast<size_t>(b) * T;
  const float* ltc = ltT + j * LT + l * S;
  int c = kChunk;  // the frame's place in the staged chunk
  for (int t = 1; t < T; ++t, ++c) {
    if (c == kChunk) {
      // every thread is past the previous frame's barrier, so the old chunk is free
      for (int k = tid; k < kChunk && t + k < T; k += blockDim.x) {
        ob[k] = lb_b[t + k];
        oo[k] = lo_b[t + k];
      }
      c = 0;
      __syncthreads();
    }
    const float* cur = lastv + ((t - 1) & 1) * NS;
    float* nxt = lastv + (t & 1) * NS;

    // the score entering phase 0 of tempo j: the maximum over this lane's
    // sources l S .. l S + S - 1, then over the group
    // independent chains, for latency: four, or two where the transitions
    // come from shared memory and a 1,024-thread block leaves 64 registers
    constexpr int kChains = kLtShared ? 2 : 4;
    float part[kChains];
#pragma unroll
    for (int q = 0; q < kChains; ++q) part[q] = -INFINITY;
#pragma unroll
    for (int s4 = 0; s4 < S; s4 += 4) {
      const float4 x = *reinterpret_cast<const float4*>(cur + l * S + s4);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) part[q % kChains] = max_nan(part[q % kChains], xs[q] + (kLtShared ? ltc[s4 + q] : lt[kLtShared ? 0 : s4 + q]));
    }
    float best;
    if constexpr (kChains == 4) {
      best = max_nan(max_nan(part[0], part[1]), max_nan(part[2], part[3]));
    } else {
      best = max_nan(part[0], part[1]);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) best = max_nan(best, __shfl_xor_sync(0xffffffffu, best, off));
    SPLIT(0);  // the transition max: the lane's run and the group's shuffles

    // the roll: phase p takes phase p - 1 (across a lane boundary by a
    // shuffle), phase 0 the best entry; then the observation
    const float lb = ob[c];
    const float lo = oo[c];
    const float carry = __shfl_up_sync(0xffffffffu, r[R - 1], 1, kLanes);
#pragma unroll
    for (int k = R - 1; k > 0; --k) r[k] = r[k - 1] + (k < in_beat ? lb : lo);
    r[0] = (l == 0 ? best : carry) + (0 < in_beat ? lb : lo);
    const float last = pick(r, Lj - 1 - base);
    hist_j += n;
    if (owns_last) {
      nxt[j] = last;
      if (t < T - 1) *hist_j = last;
    }
    SPLIT(2);  // the phase update and the last phase
    __syncthreads();
    SPLIT(3);  // the barrier (and, once per chunk, the staging)
  }

  // flat argmax over [n, P] in row-major order, first maximum: the valid
  // phases and -1e30 at the others, each lane ascending, then the block
  float bv = -INFINITY;
  int bk = INT_MAX;  // the lane's first best slot
  if (active) {
    const int valid = Lj - base;  // slots k < valid are phases of tempo j
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k < in_row) take_if_above(bv, bk, k < valid ? r[k] : kNegInf, k);
    }
  }
  const int bi = block_first_max(bv, bk == INT_MAX ? INT_MAX : j * P + base + bk, red_k, red_i);
  if (warp != 0) return;
  SPLIT(4);  // the final argmax

  // backtrack by warp 0
  backtrack(bi, hist_b, log_trans, L, phases + static_cast<size_t>(b) * T, out_intervals + static_cast<size_t>(b) * T, T, n, P);
  SPLIT(5);  // the backtrack
}

template <int R, int S, bool kLtShared>
int launch(const void* init, const void* lo_beat, const void* lo_off, const void* log_trans, const void* intervals,
           const void* beat_len, void* hist, void* phases, void* out_intervals, int B, int T, int n, int P,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(S, kLtShared, n);
  int device = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return -2;
  auto kernel = dbn_viterbi_kernel<R, S, kLtShared>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (n * kLanes + 31) / 32 * 32;
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const float*>(init), static_cast<const float*>(lo_beat), static_cast<const float*>(lo_off),
      static_cast<const float*>(log_trans), static_cast<const int*>(intervals), static_cast<const int*>(beat_len),
      static_cast<float*>(hist), static_cast<int*>(phases), static_cast<int*>(out_intervals), T, n, P);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kGeneralThreads = 1024;
constexpr int kGeneralChunk = 256;  // frames of observations staged at a time

// The general layout's shared memory, in floats: the last-phase scores [n],
// the entries [n], the intervals, beat windows and buffer offsets [3][n],
// the staged observations [2][kGeneralChunk], the argmax's [32][2]; then the
// transition matrix [n][n] and the score buffer [n_states] where they fit.
constexpr size_t general_base_floats(int n) { return 5 * static_cast<size_t>(n) + 2 * kGeneralChunk + 64; }

// Any grid: one block per song, the score as one circular buffer per tempo
// in shared memory (kScoreShared) or in the song's row of `score`
// (a minimum of one block per SM: with the bound alone, ptxas held the
// device-memory instantiation to 32 registers and spilled)
template <bool kScoreShared>
__global__ void __launch_bounds__(kGeneralThreads, 1)
dbn_viterbi_kernel_general(const float* __restrict__ init,       // [B, n, P]
                           const float* __restrict__ lo_beat,    // [B, T]
                           const float* __restrict__ lo_off,     // [B, T]
                           const float* __restrict__ log_trans,  // [n, n] (from, to)
                           const int* __restrict__ intervals,    // [n]
                           const int* __restrict__ beat_len,     // [n]: ceil(L / lambda)
                           float* __restrict__ hist,             // [B, T - 1, n]: last-phase scores after frames 0 .. T - 2
                           float* __restrict__ score,            // [B, n_states] (not kScoreShared): the circular buffers
                           int* __restrict__ phases,             // [B, T]
                           int* __restrict__ out_intervals,      // [B, T]
                           int T, int n, int P, int n_states, bool lt_shared, int ls) {
  extern __shared__ float smem[];
  float* lastv = smem;                                // [n]
  float* enter = lastv + n;                           // [n]: the score entering phase 0 of each tempo
  int* L = reinterpret_cast<int*>(enter + n);         // [n]
  int* bl = L + n;                                    // [n]: beat window
  int* off = bl + n;                                  // [n]: tempo i's buffer starts at off[i]
  float* ob = reinterpret_cast<float*>(off + n);      // [kGeneralChunk]: log activation of the staged frames
  float* oo = ob + kGeneralChunk;                     // [kGeneralChunk]: their off-beat term
  int* red_k = reinterpret_cast<int*>(oo + kGeneralChunk);
  int* red_i = red_k + 32;
  float* lt_s = reinterpret_cast<float*>(red_i + 32);  // [n][n] (lt_shared)
  float* buf = kScoreShared ? lt_s + (lt_shared ? static_cast<size_t>(n) * n : 0)
                            : score + static_cast<size_t>(blockIdx.x) * n_states;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int tw = 32 / ls;  // targets per warp, ls lanes each: lane l takes target l % tw, sources l / tw + k ls
  SPLIT_START;

  for (int i = tid; i < n; i += blockDim.x) {
    L[i] = intervals[i];
    bl[i] = beat_len[i];
  }
  if (lt_shared) {
    for (int k = tid; k < n * n; k += blockDim.x) lt_s[k] = log_trans[k];
  }
  __syncthreads();
  if (warp == 0) {  // the offsets: an exclusive scan of the intervals
    int carry = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      int v = i0 + lane < n ? L[i0 + lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      if (i0 + lane < n) off[i0 + lane] = carry + v - L[i0 + lane];
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float* lt = lt_shared ? lt_s : log_trans;

  // frame 0: phase p of tempo i in slot p; its last phase
  float* hist_b = hist + static_cast<size_t>(b) * (T - 1) * n;
  for (int i = warp; i < n; i += n_warps) {
    const float* init_i = init + (static_cast<size_t>(b) * n + i) * P;
    float* row = buf + off[i];
    for (int q = lane; q < L[i]; q += 32) row[q] = init_i[q];
    if (lane == 0) {
      lastv[i] = init_i[L[i] - 1];
      if (T > 1) hist_b[i] = init_i[L[i] - 1];
    }
  }

  const float* lb_b = lo_beat + static_cast<size_t>(b) * T;
  const float* lo_b = lo_off + static_cast<size_t>(b) * T;
  int c = kGeneralChunk;  // the frame's place in the staged chunk
  SPLIT(6);  // the start: intervals, offsets, the matrix and frame 0 into place
  for (int t = 1; t < T; ++t, ++c) {
    __syncthreads();  // frame t - 1 is done: its last phases are in, its observations read
    if (c == kGeneralChunk) {
      for (int k = tid; k < kGeneralChunk && t + k < T; k += blockDim.x) {
        ob[k] = lb_b[t + k];
        oo[k] = lo_b[t + k];
      }
      c = 0;
      __syncthreads();
    }
    SPLIT(3);  // the frame's first barrier (and, once per chunk, the staging)

    // the score entering phase 0 of each target j: the maximum over the
    // sources, this lane's every ls-th, four chains, then over the group
    for (int j0 = 0; j0 < n; j0 += n_warps * tw) {
      const int j = j0 + warp * tw + lane % tw;
      float part[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      if (j < n) {
        int i = lane / tw;
        for (; i + 3 * ls < n; i += 4 * ls) {
#pragma unroll
          for (int q = 0; q < 4; ++q) part[q] = max_nan(part[q], lastv[i + q * ls] + lt[(i + q * ls) * n + j]);
        }
        for (; i < n; i += ls) part[0] = max_nan(part[0], lastv[i] + lt[i * n + j]);
      }
      float best = max_nan(max_nan(part[0], part[1]), max_nan(part[2], part[3]));
      for (int d = 16; d >= tw; d >>= 1) best = max_nan(best, __shfl_xor_sync(0xffffffffu, best, d));
      if (j < n && lane < tw) enter[j] = best;
    }
    SPLIT(0);  // the transition max: the lanes' sources and the groups' shuffles
    __syncthreads();  // the entries are in, and every last phase was read
    SPLIT(1);  // the second barrier

    // each tempo's slots, one warp a tempo: slot q holds phase (q + t) mod L;
    // every phase adds its observation, phase 0 to the entry
    const float lb = ob[c];
    const float lo = oo[c];
    for (int i = warp; i < n; i += n_warps) {
      const int Li = L[i];
      const int bli = bl[i];
      const int tm = t % Li;
      float* row = buf + off[i];
      for (int q = lane; q < Li; q += 32) {
        int p = q + tm;
        if (p >= Li) p -= Li;
        const float o = p < bli ? lb : lo;
        const float v = (p == 0 ? enter[i] : row[q]) + o;
        row[q] = v;
        if (p == Li - 1) {
          lastv[i] = v;
          if (t < T - 1) hist_b[static_cast<size_t>(t) * n + i] = v;
        }
      }
    }
    SPLIT(2);  // the slots of this warp's tempi
  }
  __syncthreads();

  // flat argmax over [n, P] in row-major order, first maximum: the valid
  // phases and -1e30 at the others, each thread ascending, then the block
  float bv = -INFINITY;
  int bk = INT_MAX;
  for (int k = tid; k < n * P; k += blockDim.x) {
    const int i = k / P;
    const int p = k - i * P;
    const int Li = L[i];
    float v = kNegInf;
    if (p < Li) {
      int q = p - (T - 1) % Li;
      if (q < 0) q += Li;
      v = buf[off[i] + q];
    }
    take_if_above(bv, bk, v, k);
  }
  const int bi = block_first_max(bv, bk, red_k, red_i);
  if (warp != 0) return;
  SPLIT(4);  // the final argmax
  backtrack(bi, hist_b, log_trans, L, phases + static_cast<size_t>(b) * T, out_intervals + static_cast<size_t>(b) * T, T, n, P);
  SPLIT(5);  // the backtrack
}

template <bool kScoreShared>
int launch_general(const void* init, const void* lo_beat, const void* lo_off, const void* log_trans, const void* intervals,
                   const void* beat_len, void* hist, void* score, void* phases, void* out_intervals, int B, int T, int n,
                   int P, int n_states, size_t smem, bool lt_shared, cudaStream_t stream) {
  auto kernel = dbn_viterbi_kernel_general<kScoreShared>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int ls = 1;  // lanes per target: as many as keep every target in one pass over the block
  while (ls < 32 && 2 * ls * n <= kGeneralThreads) ls *= 2;
  kernel<<<B, kGeneralThreads, smem, stream>>>(
      static_cast<const float*>(init), static_cast<const float*>(lo_beat), static_cast<const float*>(lo_off),
      static_cast<const float*>(log_trans), static_cast<const int*>(intervals), static_cast<const int*>(beat_len),
      static_cast<float*>(hist), static_cast<float*>(score), static_cast<int*>(phases), static_cast<int*>(out_intervals),
      T, n, P, n_states, lt_shared, ls);
  return static_cast<int>(cudaGetLastError());
}

// The general layout: the score in shared memory where it fits beside the
// per-tempo vectors, the transition matrix too where both fit; -2 where the
// per-tempo vectors alone do not
int launch_any_grid(const void* init, const void* lo_beat, const void* lo_off, const void* log_trans, const void* intervals,
                    const void* beat_len, void* hist, void* score, void* phases, void* out_intervals, int B, int T, int n,
                    int P, int n_states, cudaStream_t stream) {
  int device = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t cap = static_cast<size_t>(limit) / sizeof(float);
  const size_t base = general_base_floats(n);
  const size_t lt = static_cast<size_t>(n) * n;
  if (base > cap) return -2;
  const bool score_shared = base + n_states <= cap;
  const bool lt_shared = base + lt + (score_shared ? n_states : 0) <= cap;
  const size_t smem = sizeof(float) * (base + (lt_shared ? lt : 0) + (score_shared ? n_states : 0));
  if (score_shared)
    return launch_general<true>(init, lo_beat, lo_off, log_trans, intervals, beat_len, hist, score, phases, out_intervals, B,
                                T, n, P, n_states, smem, lt_shared, stream);
  return launch_general<false>(init, lo_beat, lo_off, log_trans, intervals, beat_len, hist, score, phases, out_intervals, B,
                               T, n, P, n_states, smem, lt_shared, stream);
}

}  // namespace

extern "C" {

// init [B, n, P], lo_beat and lo_off [B, T], log_trans [n, n] float32;
// intervals and beat_len [n] int32; hist [B, max(T - 1, 1), n] and score
// [B, n_states] float32 scratch, n_states = sum(intervals) (only the general
// layout with the score in device memory uses it); phases and
// out_intervals [B, T] int32. All contiguous, on the device. The shipped
// tempo grid (84 tempi, 110 phases) takes the first layout.
int dbn_viterbi_f32(const void* init, const void* lo_beat, const void* lo_off, const void* log_trans,
                    const void* intervals, const void* beat_len, void* hist, void* score, void* phases,
                    void* out_intervals, int B, int T, int n, int P, int n_states, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || n < 1 || P < 1 || n_states < n || static_cast<long long>(n) * P > INT_MAX ||
      n_states > static_cast<long long>(n) * P)
    return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 12 * kLanes && P <= 14 * kLanes)
    return launch<14, 12, false>(init, lo_beat, lo_off, log_trans, intervals, beat_len, hist, phases, out_intervals, B, T, n, P, s);
  if (n <= 16 * kLanes && P <= 20 * kLanes)
    return launch<20, 16, true>(init, lo_beat, lo_off, log_trans, intervals, beat_len, hist, phases, out_intervals, B, T, n, P, s);
  return launch_any_grid(init, lo_beat, lo_off, log_trans, intervals, beat_len, hist, score, phases, out_intervals, B, T, n,
                         P, n_states, s);
}

}  // extern "C"
