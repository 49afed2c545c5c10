// Max-product Viterbi with a dense [S, S] log-transition matrix: the forward
// pass and the backtrack of a batch of sequences, one launch.
//
// Replaces the two lax.scans of audiotabs_tpu/decode/viterbi.py::viterbi_log_dense
// (the forward scan at :79 and the backtrack at :86), which decode the CRF
// chord states inside the JAX package's device program.
//
// Each frame t: for each target state j, the first maximum over source
// states i of score[i] + trans[i, j] and its backpointer, then the frame's
// log-emission of j is added. The backtrack starts from the first maximum of
// the last score; the last score's maximum is returned too.
//
// Exactness. The emissions, transitions and initial scores come from the
// caller (log_softmax and the checkpoint's tables in torch); this kernel
// only adds and compares, in the order of the plain loop of decode/viterbi.py,
// so the two agree bit for bit.
//
// Bound. The CRF decode of a song is 301 frames of 25 states: 2 x 25 x 25
// adds and maxima per frame, about 0.38 M operations (0.01 us at 132 SMs x
// 128 FP32 lanes x 1.98 GHz), and about 32 KB of emissions and path (0.01 us
// at 3.35 TB/s). What bounds it on the card is the chain of dependent
// frames. What the design does about that: one block per sequence, one
// thread per target state, the score vector in shared memory (two barriers
// per frame); the transition matrix is read through the cache; backpointers
// go to device memory and the backtrack runs on one thread.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStates = 1024;

__global__ void __launch_bounds__(kMaxStates)
dense_viterbi_kernel(const float* __restrict__ em,     // [B, T, S]
                     const float* __restrict__ trans,  // [S, S] (from, to)
                     const float* __restrict__ init,   // [S]
                     int* __restrict__ bp,             // [B, T - 1, S]
                     int* __restrict__ path,           // [B, T]
                     float* __restrict__ best,         // [B]
                     int T, int S) {
  extern __shared__ float score[];  // [S]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const float* em_b = em + static_cast<size_t>(b) * T * S;
  int* bp_b = bp + static_cast<size_t>(b) * (T - 1) * S;
  if (j < S) score[j] = init[j] + em_b[j];
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    float v = 0.0f;
    if (j < S) {
      float m = score[0] + __ldg(trans + j);
      int arg = 0;
      for (int i = 1; i < S; ++i) {
        const float c = score[i] + __ldg(trans + static_cast<size_t>(i) * S + j);
        if (c > m) {
          m = c;
          arg = i;
        }
      }
      v = m + em_b[static_cast<size_t>(t) * S + j];
      bp_b[static_cast<size_t>(t - 1) * S + j] = arg;
    }
    __syncthreads();
    if (j < S) score[j] = v;
    __syncthreads();
  }
  if (j != 0) return;
  float m = score[0];
  int s = 0;
  for (int i = 1; i < S; ++i) {
    if (score[i] > m) {
      m = score[i];
      s = i;
    }
  }
  best[b] = m;
  int* path_b = path + static_cast<size_t>(b) * T;
  path_b[T - 1] = s;
  for (int k = T - 2; k >= 0; --k) {
    s = bp_b[static_cast<size_t>(k) * S + s];
    path_b[k] = s;
  }
}

}  // namespace

extern "C" {

// em float32 [B, T, S], trans [S, S], init [S]; bp int32 [B, T - 1, S]
// scratch; path int32 [B, T]; best float32 [B]. All contiguous, on the device.
int dense_viterbi_f32(const void* em, const void* trans, const void* init, void* bp, void* path, void* best,
                      int B, int T, int S, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > kMaxStates) return -1;
  const int threads = (S + 31) / 32 * 32;
  dense_viterbi_kernel<<<B, threads, sizeof(float) * S, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(em), static_cast<const float*>(trans), static_cast<const float*>(init),
      static_cast<int*>(bp), static_cast<int*>(path), static_cast<float*>(best), T, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
