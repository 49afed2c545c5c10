// The bidirectional block-max envelope that normalises the salience frame
// posteriors: block maxima of the salience, a forward and a reverse decaying
// maximum over them, and a floor, for a batch of rows in one launch.
//
// Replaces the two lax.scans of
// audiotabs_tpu/models/basicpitch.py::salience_posteriors (`_env` at :197,
// scanned forward and in reverse at :201-202), with the block maxima and
// the floor around them.
//
// For each row r of sal [R, F, T]: the row is padded with zeros to nblk
// blocks of kStride frames, m[i] = the maximum of block i over the F pitch
// rows (the last block's zeros included, as jnp.pad and F.pad put them
// there); fwd[i] = max(m[i], decay * fwd[i - 1]) and bwd[i] = max(m[i],
// decay * bwd[i + 1]) from 0; norm[i] = max(max(fwd[i], bwd[i]), floor *
// max(sal[r])), the last maximum over the unpadded row.
//
// Exactness. A maximum is the same float in any order, so the block maxima
// may be reduced in parallel; the scans keep the loop's order, a multiply
// rounded on its own (__fmul_rn: no fused operation), then a maximum. Every
// maximum propagates NaN (max.NaN.f32), as torch.maximum and torch.amax do,
// where fmaxf would drop it. The kernel agrees with the plain loop of
// models/basicpitch.py bit for bit.
//
// Bound. A 30 s song is [1, 88, 2584]: 227,392 floats read once (0.91 MB,
// 0.27 us at 3.35 TB/s) and about as many maxima (0.01 us); the 180 s song
// is [1, 88, 15504], 5.5 MB. So it is bound by bytes, and at these sizes by
// the latency of one pass over them and of the launch. What the design does
// about that:
//  - Plain blocks in one wave, no cluster. The clock split of the cluster
//    design this replaces (scripts/decoder_clock_split.py) put a fifth of
//    its first block's marked clocks at [1, 88, 2584] into two cluster
//    barriers, one only to wait for every block to start, and half into
//    its segment reduction (scalar loads, a max chain after each). Here
//    each block writes its segments' maxima to device memory and takes a
//    ticket (a __threadfence, then an atomicAdd on the row's counter); the
//    row's last block does the tail and sets the counter back to 0, so
//    back-to-back launches need no reset. The counters are the caller's,
//    one set for each stream (models/basicpitch.py keeps them), since
//    launches on two streams at once would count each other's blocks.
//  - Loads in flight. Each warp reduces a 32-frame segment of all 88 rows:
//    8 lanes x 4 frames per row, 4 rows per instruction, so 22 independent
//    16-byte loads a lane, issued before any maximum, one round trip for the
//    segment. Where T % 4 != 0 or the rows are not 16-byte aligned, each lane
//    takes one frame and loads 22 rows at a time.
//  - The tail on one warp, without divergence: lane j reduces the segment
//    maxima of blocks j, j + 32, ... (loads from L2) into the block maxima
//    and the row's maximum, which shuffles finish; lane 0 runs the forward
//    scan and lane 1 the reverse scan in the same instructions (lane 1
//    walks from nblk - 1 with a step of -1), loading a run of block maxima
//    before it scans them, and padding around the buffers spares every
//    bounds test; then every lane writes the envelope.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take, -2 for a
// stride other than kStride, the one the port uses (models/basicpitch.py's
// ENVELOPE_STRIDE): its block's two segments are a loop unrolled, whose
// loads are in flight together (with the count read at run time they went
// one after another: 0.0090 against 0.0081 ms at [1, 88, 2584] and 0.0131
// against 0.0104 ms at [1, 88, 15504] on an H100 80GB HBM3 at 700 W, by
// scripts/decoder_clock_split.py).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

// clock stamps for scripts/decoder_clock_split.py, which defines them; nothing otherwise
#ifndef SPLIT
#define SPLIT_START_IF(cond)
#define SPLIT_FOLLOW(cond)
#define SPLIT(part)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // a block's warps, each one 32-frame segment
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 22;  // loads a lane keeps in flight: 88 rows of 4 frames in 16-byte loads, 4 rows an instruction
constexpr int kMaxRows = 65535;  // rows a launch takes (the grid's y extent)
constexpr int kTailRound = 4;    // blocks a tail lane reduces before it stores their maxima
constexpr int kScanRun = 16;     // block maxima a scan lane loads before it runs over them
constexpr int kMaxShared = 227 * 1024;
constexpr int kStride = 64;             // frames a block of the envelope spans
constexpr int kPer = kStride / 32;      // segments a block

// max.NaN.f32: a NaN when either input is one, as torch.maximum and torch.amax
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The maximum of v[0 .. N), a tree of depth ceil(log2 N).
template <int N>
__device__ __forceinline__ float tree_max(float (&v)[N]) {
#pragma unroll
  for (int h = 1; h < N; h *= 2) {
#pragma unroll
    for (int i = 0; i + h < N; i += 2 * h) v[i] = max_nan(v[i], v[i + h]);
  }
  return v[0];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
salience_envelope_kernel(const float* __restrict__ sal,  // [R, F, T]
                         float* __restrict__ seg,        // [R, n_seg] scratch: each segment's maximum, valid frames only
                         unsigned* __restrict__ ticket,  // [R] zeros: blocks of the row that have written their
                                                         // segment maxima; the row's last block resets it to 0
                         float* __restrict__ norm,       // [R, nblk]
                         int F, int T, int nblk, float decay, float floor_frac, int vec) {
  extern __shared__ float smem[];  // the tail's block maxima and its two scans, each with kScanRun floats of padding
  __shared__ bool last;
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_seg = (T + 31) / 32;
  const int j = blockIdx.x * kWarps + warp;  // this warp's segment: frames 32 j .. 32 j + 31
  const float* x = sal + static_cast<size_t>(r) * F * T;
  float* seg_r = seg + static_cast<size_t>(r) * n_seg;
  SPLIT_START_IF(blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0);

  // 1. the segment's maximum over the F rows, frames past T left out
  if (j < n_seg) {
    float v = -CUDART_INF_F;
    if (vec) {
      // lane: 4 frames from 32 j + 4 (lane % 8) of the rows lane / 8, lane / 8 + 4, ...
      // (T % 4 == 0, so the 4 frames are all in the row or all past it)
      const int col = j * 32 + 4 * (lane & 7);
      if (col < T) {
        for (int f0 = lane >> 3; f0 < F; f0 += 4 * kLoads) {
          float4 q[kLoads];
#pragma unroll
          for (int k = 0; k < kLoads; ++k) {
            const int f = f0 + 4 * k;
            q[k] = f < F ? __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(f) * T + col))
                         : make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
          }
          float w[kLoads];
#pragma unroll
          for (int k = 0; k < kLoads; ++k) w[k] = max_nan(max_nan(q[k].x, q[k].y), max_nan(q[k].z, q[k].w));
          v = max_nan(v, tree_max(w));
        }
      }
    } else {
      const int col = j * 32 + lane;
      if (col < T) {
        for (int f0 = 0; f0 < F; f0 += kLoads) {
          float w[kLoads];
#pragma unroll
          for (int k = 0; k < kLoads; ++k) w[k] = f0 + k < F ? __ldg(x + static_cast<size_t>(f0 + k) * T + col) : -CUDART_INF_F;
          v = max_nan(v, tree_max(w));
        }
      }
    }
    v = warp_max(v);
    if (lane == 0) seg_r[j] = v;
  }
  SPLIT(0);  // the segment reduction

  // 2. the ticket: the row's last block to arrive does the tail
  __threadfence();  // this block's segment maxima are visible to every block before its ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned done = atomicAdd(ticket + r, 1u);
    last = done == gridDim.x - 1;
    if (last) ticket[r] = 0u;  // every block of the row has counted: ready for the next launch
  }
  __syncthreads();
  SPLIT(1);  // the fence, the ticket and two block barriers
  if (!last || warp != 0) return;
  SPLIT_FOLLOW(blockIdx.y == 0 && threadIdx.x == 0);  // from here the tail block's thread 0

  // 3. the block maxima (a partial last block holds the padding's zeros) and
  // the row's maximum, from the segment maxima in L2 (written by other blocks):
  // lane j takes blocks j, j + 32, ..., every load of a round before its stores
  float* m = smem + kScanRun;  // [kScanRun pad][nblk][kScanRun pad]
  float* fwd = m + nblk + kScanRun;  // [nblk][kScanRun pad]
  float* bwd = fwd + nblk + 2 * kScanRun;  // [kScanRun pad][nblk]
  float g = -CUDART_INF_F;
  for (int i0 = lane; i0 < nblk; i0 += 32 * kTailRound) {
    float v[kTailRound];
#pragma unroll
    for (int u = 0; u < kTailRound; ++u) {
      const int i = i0 + 32 * u;
      v[u] = (i + 1) * kStride > T ? 0.0f : -CUDART_INF_F;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int at = i * kPer + q;  // past the row's segments for every block past nblk
        const float sm = at < n_seg ? __ldcg(seg_r + at) : -CUDART_INF_F;
        v[u] = max_nan(v[u], sm);
        g = max_nan(g, sm);
      }
    }
#pragma unroll
    for (int u = 0; u < kTailRound; ++u)
      if (i0 + 32 * u < nblk) m[i0 + 32 * u] = v[u];
  }
  __syncwarp();
  SPLIT(2);  // the block maxima and the row's maximum

  // 4. the two scans from e = 0: lane 0 forward from m[0], lane 1 in reverse
  // from m[nblk - 1], the same instructions; a run of kScanRun block maxima is
  // loaded before it is scanned (a store to the scan may not pass a later
  // load of m), and the runs past the row read and write the padding
  if (lane < 2) {
    const int step = lane ? -1 : 1;
    const float* in = m + (lane ? nblk - 1 : 0);
    float* out = lane ? bwd + nblk - 1 : fwd;
    float e = 0.0f;
    for (int i0 = 0; i0 < nblk; i0 += kScanRun) {
      float v[kScanRun];
#pragma unroll
      for (int q = 0; q < kScanRun; ++q) v[q] = in[step * (i0 + q)];
#pragma unroll
      for (int q = 0; q < kScanRun; ++q) {
        e = max_nan(v[q], __fmul_rn(decay, e));
        out[step * (i0 + q)] = e;
      }
    }
  }
  g = warp_max(g);
  __syncwarp();  // the scans are in shared memory
  SPLIT(3);  // the two scans

  // 5. the envelope, floored at floor_frac of the row's maximum
  const float fl = __fmul_rn(floor_frac, g);
  float* out = norm + static_cast<size_t>(r) * nblk;
  for (int i = lane; i < nblk; i += 32) out[i] = max_nan(max_nan(fwd[i], bwd[i]), fl);
  SPLIT(4);  // the floor and the store
}

}  // namespace

extern "C" {

// sal float32 [R, F, T]; seg float32 [R, ceil(T / 32)] scratch; ticket
// int32 [R], zeros, used by no other stream while this launch runs; norm
// float32 [R, nblk] with nblk = max(1, ceil(T / stride)), stride = kStride.
// All contiguous, on the device.
int salience_envelope_f32(const void* sal, void* seg, void* ticket, void* norm, int R, int F, int T, int stride, float decay,
                          float floor_frac, void* stream) {
  if (R < 1 || R > kMaxRows || F < 1 || T < 1 || stride < 1) return -1;
  if (stride != kStride) return -2;
  const int n_seg = (T + 31) / 32;
  const int nblk = (T + stride - 1) / stride;
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(nblk) + 4 * kScanRun);
  if (smem > kMaxShared) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(salience_envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte loads along T when every row starts on 16 bytes
  const int vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(sal) % 16 == 0;
  const dim3 grid((n_seg + kWarps - 1) / kWarps, static_cast<unsigned>(R));
  salience_envelope_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sal), static_cast<float*>(seg), static_cast<unsigned*>(ticket), static_cast<float*>(norm), F, T,
      nblk, decay, floor_frac, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
