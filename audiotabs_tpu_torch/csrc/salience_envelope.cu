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
// blocks of `stride` frames, m[i] = the maximum of block i over the F pitch
// rows (the last block's zeros included, as jnp.pad and F.pad put them
// there); fwd[i] = max(m[i], decay * fwd[i - 1]) and bwd[i] = max(m[i],
// decay * bwd[i + 1]) from 0; norm[i] = max(max(fwd[i], bwd[i]), floor *
// max(sal[r])), the last maximum over the unpadded row.
//
// Exactness. A maximum is the same float in any order, so the block maxima
// may be reduced in parallel; the scans keep the loop's order, a multiply
// rounded on its own (__fmul_rn: no fused operation), then a maximum. Every
// maximum propagates NaN, as torch.maximum and torch.amax do, where fmaxf
// would drop it. The kernel agrees with the plain loop of
// models/basicpitch.py bit for bit.
//
// Bound. A 30 s song is [1, 88, 2584]: 227,392 floats read once (0.91 MB,
// 0.27 us at 3.35 TB/s) and about as many maxima (0.01 us); the 180 s song
// is [1, 88, 15504], 5.5 MB. So it is bound by bytes. What the design does
// about that: a cluster of up to 8 blocks on neighbouring SMs shares a row,
// each warp reducing 32-frame segments over the pitch rows with many loads in
// flight, and writes each segment's maximum straight into the first block's
// shared memory (distributed shared memory); after one cluster barrier the
// first block alone forms the block maxima, runs the two short scans (one
// thread each, side by side) and writes the row's norm.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take, -2 for a
// stride that is not a multiple of 32 frames.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxShared = 227 * 1024;

// torch.maximum: a NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void __launch_bounds__(kThreads)
salience_envelope_kernel(const float* __restrict__ sal,  // [R, F, T]
                         float* __restrict__ norm,        // [R, nblk]
                         int F, int T, int stride, int nblk, float decay, float floor_frac) {
  extern __shared__ float smem[];
  const int n_seg = (T + 31) / 32;  // 32-frame segments; a block is stride / 32 of them
  float* seg = smem;                // [n_seg]: each segment's maximum over the rows, valid frames only
  float* m = seg + n_seg;           // [nblk]
  float* fwd = m + nblk;            // [nblk]
  float* bwd = fwd + nblk;          // [nblk]
  float* red = bwd + nblk;          // [kWarps]

  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.x / size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* x = sal + static_cast<size_t>(r) * F * T;
  float* seg0 = cluster.map_shared_rank(seg, 0);
  cluster.sync();  // every block of the cluster has started before its shared memory is written

  // 1. segment maxima, spread over the cluster's warps
  for (int j = rank * kWarps + warp; j < n_seg; j += size * kWarps) {
    const int col = j * 32 + lane;
    float v = -CUDART_INF_F;
    if (col < T) {
      const float* p = x + col;
#pragma unroll 22
      for (int f = 0; f < F; ++f) v = max_nan(v, __ldg(p + static_cast<size_t>(f) * T));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) seg0[j] = v;
  }
  cluster.sync();  // the segment maxima are in the first block's shared memory
  if (rank != 0) return;

  // 2. block maxima (a partial last block holds the padding's zeros) and the row's maximum
  const int per = stride / 32;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    float v = (i + 1) * stride > T ? 0.0f : -CUDART_INF_F;
    for (int q = i * per; q < (i + 1) * per && q < n_seg; ++q) v = max_nan(v, seg[q]);
    m[i] = v;
  }
  float g = -CUDART_INF_F;
  for (int j = threadIdx.x; j < n_seg; j += kThreads) g = max_nan(g, seg[j]);
#pragma unroll
  for (int o = 16; o; o >>= 1) g = max_nan(g, __shfl_xor_sync(kFull, g, o));
  if (lane == 0) red[warp] = g;
  __syncthreads();

  // 3. the two scans, one thread each, from e = 0
  if (threadIdx.x == 0) {
    float e = 0.0f;
    for (int i = 0; i < nblk; ++i) {
      e = max_nan(m[i], __fmul_rn(decay, e));
      fwd[i] = e;
    }
  } else if (threadIdx.x == 32) {
    float e = 0.0f;
    for (int i = nblk - 1; i >= 0; --i) {
      e = max_nan(m[i], __fmul_rn(decay, e));
      bwd[i] = e;
    }
  }
  __syncthreads();

  // 4. the envelope, floored at floor_frac of the row's maximum
  g = red[0];
  for (int w = 1; w < kWarps; ++w) g = max_nan(g, red[w]);
  const float fl = __fmul_rn(floor_frac, g);
  float* out = norm + static_cast<size_t>(r) * nblk;
  for (int i = threadIdx.x; i < nblk; i += kThreads) out[i] = max_nan(max_nan(fwd[i], bwd[i]), fl);
}

}  // namespace

extern "C" {

// sal float32 [R, F, T]; norm float32 [R, nblk] with nblk = max(1, ceil(T /
// stride)). Both contiguous, on the device.
int salience_envelope_f32(const void* sal, void* norm, int R, int F, int T, int stride, float decay, float floor_frac,
                          void* stream) {
  if (R < 1 || F < 1 || T < 1 || stride < 1) return -1;
  if (stride % 32) return -2;
  const int n_seg = (T + 31) / 32;
  const int nblk = (T + stride - 1) / stride;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_seg) + 3 * static_cast<size_t>(nblk) + kWarps);
  if (smem > kMaxShared) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(salience_envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // enough blocks that each warp reduces about one segment, at most 8 (the portable cluster size)
  int size = 1;
  while (size < kMaxCluster && size * kWarps < n_seg) size *= 2;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R * size));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(size);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, salience_envelope_kernel, static_cast<const float*>(sal),
                                             static_cast<float*>(norm), F, T, stride, nblk, decay, floor_frac);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
