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
// loop's order, so the two agree bit for bit. The forward pass takes each
// propagation's maximum (a max is the same in any order) and keeps, per bin
// and frame, both maxima and the bin's previous scores; the backtrack
// recomputes the sums around its bin and takes the first one equal to the
// maximum: the lowest offset, as the first maximum. A NaN is the maximum, as
// torch.max, torch.maximum and torch.argmax take it: the maxima propagate it
// (max.NaN.f32) and every argmax takes the first NaN.
//
// Bound. The content windows of one song are 20 rows of 130 frames of 241
// bins: 51 candidate adds and maxima per bin and layer per frame, about
// 0.13 G operations, about 0.004 ms at 132 SMs x 128 FP32 adds (64 compares)
// per clock at 1.98 GHz; the observations read (two [20, 130, 241] float32
// arrays, 5 MB) take about 1.5 us at 3.35 TB/s. So operations bound it. A
// row is a chain of 130 dependent frames, and a frame's work (about 25 K
// candidates) fits one SM. What the design does about that: one block per
// row (the rows run on separate SMs), and each frame spread over the block
// behind one barrier. A group of kLanes lanes owns kBins adjacent bins; lane
// q takes the offsets q C .. q C + C - 1 (C = ceil((2 band + 1) / kLanes))
// of all of them, so a score it loads from shared memory serves kBins
// candidates (a window of kBins scores slides along its offsets), the two
// layers interleaved, an add and a max each; the group reduces each bin's
// maxima by xor shuffles, and lane q finishes bin q of the group. No argmax
// is taken there: the backtrack needs one bin's offset per frame. The score
// vectors, padded with -inf by the band on both sides, are double-buffered
// in shared memory, so one barrier separates frames; each lane loads its
// bin's next observations while it works on this one, and stores the bin's
// record of the frame (both maxima, both previous scores: one float4) to
// device memory. The backtrack stages the records back into shared memory
// by asynchronous copies, up to kStageBytes at a time, and one warp walks
// them: per frame the layer flag from the two maxima, then ballots over the
// band's sums (32 offsets each, all loaded at once) for the first that
// equals the chosen layer's maximum.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

// clock stamps for scripts/decoder_clock_split.py, which defines them; nothing otherwise
#ifndef SPLIT
#define SPLIT_START
#define SPLIT(part)
#endif

namespace {

constexpr int kMaxBins = 1024;
constexpr int kLanes = 4;  // lanes per group, each with a run of the offsets
constexpr int kBins = 4;   // adjacent bins per group; lane q finishes bin q
static_assert(kLanes == kBins, "each lane finishes one bin of its group");
constexpr int kStageBytes = 128 * 1024;  // frame records staged for the backtrack at a time

// max.NaN.f32: a NaN when either input is one, as torch.max, torch.maximum and jnp.max
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Whether (ov, oi) is the first maximum over (bv, bi) as torch.argmax takes
// it: a NaN above every number, the lower index on a tie (two NaNs tie)
__device__ __forceinline__ bool before(float ov, int oi, float bv, int bi) {
  const bool o_nan = ov != ov, b_nan = bv != bv;
  if (o_nan || b_nan) return o_nan && (!b_nan || oi < bi);
  return ov > bv || (ov == bv && oi < bi);
}

// Whether v is the argmax's pick among sums whose NaN-propagating maximum is
// m: equal to it or, when m is a NaN, a NaN itself (no sum is a NaN unless m is)
__device__ __forceinline__ bool hits_max(float v, float m) { return v == m || v != v; }

// (value, index) pairs: the first maximum wins
__device__ __forceinline__ void take_first_max(float& bv, int& bi, float ov, int oi) {
  if (before(ov, oi, bv, bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void reduce_first_max(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    take_first_max(bv, bi, ov, oi);
  }
}

// a[k] for 0 <= k < N by a tree of selects over the bits of k
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int k) {
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = a[i];
#pragma unroll
  for (int lvl = 0; (1 << lvl) < N; ++lvl) {
    const bool hi = (k >> lvl) & 1;
#pragma unroll
    for (int i = 0; i + (1 << lvl) < N; i += 2 << lvl) t[i] = hi ? t[i + (1 << lvl)] : t[i];
  }
  return t[0];
}

// a 16-byte copy from device to shared memory that does not wait
__device__ __forceinline__ void copy_async(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::); }

// The shared-memory layout, in 4-byte words: the padded voiced and unvoiced
// scores [2][W] each (W = n_bins rounded up to kBins, plus 2 band), log_tri
// [2 band + 1], the end state's (value, index) per warp and layer [4][32],
// then, from a 16-byte boundary, the staged frame records [stage][n_bins][4].
__host__ __device__ int padded_width(int n_bins, int band) { return (n_bins + kBins - 1) / kBins * kBins + 2 * band; }

__host__ __device__ size_t records_at(int n_bins, int band) {
  const int W = padded_width(n_bins, band);
  return (4 * static_cast<size_t>(W) + 2 * band + 1 + 128 + 3) / 4 * 4;
}

size_t smem_words(int n_bins, int band, int stage) { return records_at(n_bins, band) + 4 * static_cast<size_t>(stage) * n_bins; }

__global__ void __launch_bounds__(kMaxBins)
banded_viterbi_kernel(const float* __restrict__ obs_v,    // [R, T, n_bins]
                      const float* __restrict__ obs_u,    // [R, T, n_bins]
                      const float* __restrict__ log_tri,  // [2 band + 1]
                      float log_stay, float log_switch, float init,
                      float4* __restrict__ rec,           // [R, T, n_bins]: pv, pu, previous sv, su
                      int64_t* __restrict__ bins,         // [R, T]
                      uint8_t* __restrict__ voiced,       // [R, T]
                      int T, int n_bins, int band, int stage) {
  extern __shared__ float smem[];
  const int n_groups = (n_bins + kBins - 1) / kBins;
  const int W = padded_width(n_bins, band);  // bin x at x + band; -inf outside the bins
  float* sv = smem;         // [2][W]
  float* su = sv + 2 * W;   // [2][W]
  float* tri = su + 2 * W;  // [2 band + 1]
  float* red_v = tri + 2 * band + 1;                // [2][32]: the layers' best value per warp
  int* red_i = reinterpret_cast<int*>(red_v + 64);  // [2][32]: its bin
  float4* staged = reinterpret_cast<float4*>(smem + records_at(n_bins, band));  // [stage][n_bins]

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = tid % kLanes;
  const int g = min(tid / kLanes, n_groups - 1);  // an idle group mirrors the last and stores nothing
  const int b0 = g * kBins;                       // the group's first bin
  const int mine = b0 + q;                        // the bin this lane finishes
  const bool stores = tid / kLanes < n_groups && mine < n_bins;
  const int C = (2 * band + kLanes) / kLanes;  // offsets per lane
  const int k0 = q * C;
  const int cnt = min(C, 2 * band + 1 - k0);  // may be 0 or less for the last lane
  const int kw = min(k0, 2 * band);           // where its window starts (any place when cnt <= 0)
  SPLIT_START;

  for (int k = tid; k < 2 * W; k += blockDim.x) {
    const int x = k % W;
    const float v = x >= band && x < band + n_bins ? init : -INFINITY;
    sv[k] = v;
    su[k] = v;
  }
  for (int k = tid; k < 2 * band + 1; k += blockDim.x) tri[k] = log_tri[k];
  const size_t row = static_cast<size_t>(r) * T * n_bins;
  const float* ov_b = obs_v + row + min(mine, n_bins - 1);
  const float* ou_b = obs_u + row + min(mine, n_bins - 1);
  float4* rec_b = rec + row + min(mine, n_bins - 1);
  float ov = ov_b[0];
  float ou = ou_b[0];
  __syncthreads();
  SPLIT(6);

  for (int t = 0; t < T; ++t) {
    const float* cv = sv + (t & 1) * W;
    const float* cu = su + (t & 1) * W;
    // the next frame's observations, loaded while this one is worked on
    const float ov_next = t + 1 < T ? ov_b[static_cast<size_t>(t + 1) * n_bins] : 0.0f;
    const float ou_next = t + 1 < T ? ou_b[static_cast<size_t>(t + 1) * n_bins] : 0.0f;
    // max-plus propagation of both layers for the group's bins over this
    // lane's offsets: the candidate of bin b0 + i at offset k is the padded
    // score at b0 + i + k plus log_tri[k]; a window of kBins scores slides
    float pv[kBins], pu[kBins], wv[kBins], wu[kBins];
#pragma unroll
    for (int i = 0; i < kBins; ++i) pv[i] = pu[i] = -INFINITY;
#pragma unroll
    for (int i = 0; i + 1 < kBins; ++i) {
      wv[i] = cv[b0 + kw + i];
      wu[i] = cu[b0 + kw + i];
    }
#pragma unroll 4
    for (int m = 0; m < cnt; ++m) {
      const int k = k0 + m;
      const float tk = tri[k];
      wv[kBins - 1] = cv[b0 + k + kBins - 1];
      wu[kBins - 1] = cu[b0 + k + kBins - 1];
#pragma unroll
      for (int i = 0; i < kBins; ++i) {
        pv[i] = max_nan(pv[i], wv[i] + tk);
        pu[i] = max_nan(pu[i], wu[i] + tk);
      }
#pragma unroll
      for (int i = 0; i + 1 < kBins; ++i) {
        wv[i] = wv[i + 1];
        wu[i] = wu[i + 1];
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kBins; ++i) {
        pv[i] = max_nan(pv[i], __shfl_xor_sync(0xffffffffu, pv[i], off));
        pu[i] = max_nan(pu[i], __shfl_xor_sync(0xffffffffu, pu[i], off));
      }
    }
    SPLIT(0);  // the candidates and the group's shuffles

    // lane q finishes bin b0 + q: stay or switch and the observation; its record
    const float mv = pick(pv, q), mu = pick(pu, q);
    const float nv_stay = mv + log_stay, nv_sw = mu + log_switch;
    const float nu_stay = mu + log_stay, nu_sw = mv + log_switch;
    if (stores) {
      rec_b[static_cast<size_t>(t) * n_bins] = make_float4(mv, mu, cv[mine + band], cu[mine + band]);
      sv[((t + 1) & 1) * W + mine + band] = max_nan(nv_stay, nv_sw) + ov;
      su[((t + 1) & 1) * W + mine + band] = max_nan(nu_stay, nu_sw) + ou;
    }
    ov = ov_next;
    ou = ou_next;
    SPLIT(1);  // stay or switch, the new scores and the record
    __syncthreads();
    SPLIT(3);  // the barrier
  }

  // the end state: voiced when its best score is at least the unvoiced one;
  // each argmax the first maximum (each thread ascending, then the block)
  const float* fv = sv + (T & 1) * W + band;
  const float* fu = su + (T & 1) * W + band;
  float mv = -INFINITY, mu = -INFINITY;
  int iv = INT_MAX, iu = INT_MAX;
  for (int x = tid; x < n_bins; x += blockDim.x) {
    take_first_max(mv, iv, fv[x], x);
    take_first_max(mu, iu, fu[x], x);
  }
  reduce_first_max(mv, iv);
  reduce_first_max(mu, iu);
  if (lane == 0) {
    red_v[warp] = mv;
    red_i[warp] = iv;
    red_v[32 + warp] = mu;
    red_i[32 + warp] = iu;
  }
  __syncthreads();
  const int n_warps = (blockDim.x + 31) / 32;
  bool is_v = false;
  int at = 0;
  if (warp == 0) {
    mv = lane < n_warps ? red_v[lane] : -INFINITY;
    iv = lane < n_warps ? red_i[lane] : INT_MAX;
    mu = lane < n_warps ? red_v[32 + lane] : -INFINITY;
    iu = lane < n_warps ? red_i[32 + lane] : INT_MAX;
    reduce_first_max(mv, iv);
    reduce_first_max(mu, iu);
    is_v = mv >= mu;
    at = is_v ? iv : iu;
  }

  // backtrack by warp 0 over the records staged in shared memory, from the
  // last frames back: the previous layer from the two maxima (switch only
  // when strictly better), then the lowest offset whose sum of that layer's
  // previous score and log_tri equals its maximum (lane i tries the
  // offsets i, i + 32, ...; the first ballot with a hit gives it)
  const float tri0 = lane <= 2 * band ? tri[lane] : 0.0f;
  const float tri1 = 32 + lane <= 2 * band ? tri[32 + lane] : 0.0f;
  SPLIT(4);  // the end state
  for (int hi = T; hi > 0; hi -= stage) {
    const int lo = max(hi - stage, 0);
    const int records = (hi - lo) * n_bins;
    __syncthreads();  // the previous stage has been walked
    for (int x = tid; x < records; x += blockDim.x) copy_async(staged + x, rec + row + static_cast<size_t>(lo) * n_bins + x);
    copies_done();
    __syncthreads();
    SPLIT(7);  // the staging
    if (warp != 0) continue;
    for (int t = hi - 1; t >= lo; --t) {
      const float4* frame = staged + static_cast<size_t>(t - lo) * n_bins;
      bins[static_cast<size_t>(r) * T + t] = at;  // the same value from every lane: one store
      voiced[static_cast<size_t>(r) * T + t] = is_v;
      // the record of offset k (k = c 32 + lane), -inf where it is out of the band or the bins
      const auto near = [&](int k) {
        const int y = at + k - band;
        return k <= 2 * band && y >= 0 && y < n_bins ? frame[y] : make_float4(0.0f, 0.0f, -INFINITY, -INFINITY);
      };
      // this bin's record and the first 64 offsets', loaded together
      const float4 here = frame[at];
      const float4 near0 = near(lane), near1 = near(32 + lane);
      const bool prev_is_v = is_v ? !(here.y + log_switch > here.x + log_stay) : here.x + log_switch > here.y + log_stay;
      const float target = prev_is_v ? here.x : here.y;
      const unsigned hit0 = __ballot_sync(0xffffffffu, hits_max((prev_is_v ? near0.z : near0.w) + tri0, target));
      const unsigned hit1 = __ballot_sync(0xffffffffu, hits_max((prev_is_v ? near1.z : near1.w) + tri1, target));
      int k = hit0 ? __ffs(hit0) - 1 : hit1 ? 32 + __ffs(hit1) - 1 : -1;
      for (int c = 2; k < 0 && c * 32 <= 2 * band; ++c) {  // a band wider than 31
        const float4 w = near(c * 32 + lane);
        const float tk = c * 32 + lane <= 2 * band ? tri[c * 32 + lane] : 0.0f;
        const unsigned hit = __ballot_sync(0xffffffffu, hits_max((prev_is_v ? w.z : w.w) + tk, target));
        if (hit) k = c * 32 + __ffs(hit) - 1;
      }
      at = min(max(at + k - band, 0), n_bins - 1);
      is_v = prev_is_v;
    }
    SPLIT(5);  // the walk
  }
}

}  // namespace

extern "C" {

// obs_v, obs_u: contiguous float32 [R, T, n_bins]; log_tri float32 [2 band + 1];
// rec float32 scratch [R, T, n_bins, 4]; bins int64 and voiced bool [R, T].
// All on the device.
int banded_viterbi_f32(const void* obs_v, const void* obs_u, const void* log_tri, float log_stay, float log_switch,
                       float init, void* rec, void* bins, void* voiced, int R, int T, int n_bins, int band,
                       void* stream) {
  if (R < 1 || T < 1 || n_bins < 1 || n_bins > kMaxBins || band < 1 || band > 127) return -1;
  const int stage = std::max(1, std::min(T, kStageBytes / (16 * n_bins)));  // frames of records
  const size_t smem = 4 * smem_words(n_bins, band, stage);
  cudaError_t err = cudaFuncSetAttribute(banded_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((n_bins + kBins - 1) / kBins * kLanes + 31) / 32 * 32;
  banded_viterbi_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs_v), static_cast<const float*>(obs_u), static_cast<const float*>(log_tri),
      log_stay, log_switch, init, static_cast<float4*>(rec), static_cast<int64_t*>(bins),
      static_cast<uint8_t*>(voiced), T, n_bins, band, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
