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
// so the two agree bit for bit. Every argmax takes the first maximum (an
// ascending scan with a strict >), the final flat argmax in row-major order.
//
// Bound. One 3,000-frame song needs about 98 M adds and maxima (2,999 frames
// of 84 x 84 transition candidates and 84 x 110 phase updates, each an add
// and a compare): about 3 us at 132 SMs x 128 FP32 lanes x 1.98 GHz. Its
// inputs and outputs are about 76 KB: 0.02 us at 3.35 TB/s. So operations
// bound it, but a song is a chain of 3,000 dependent frames, and a frame's
// work (about 16 K operations) fills only a small part of one SM. What the
// design does about that: one block of 1,024 threads per song keeps the whole
// score, double-buffered, and the transition matrix in shared memory
// (103.7 KB at 84 x 110), so a frame is two barriers and no device-memory
// round trip; the batch's songs run on separate SMs. The backpointers (one
// byte per tempo per frame) go to device memory, and the backtrack, on one
// thread, reads one of them per beat only (at phase 0). The latency of the
// frame chain stays: closing the gap to the bound means splitting a frame
// over more of the card, a later step.
//
// Interface: a plain C function returning cudaGetLastError() after the
// launch (0 on success), -1 for arguments the kernel does not take and -2
// when the score does not fit in the shared memory a block may opt into on
// the current device (the launcher is the one owner of the layout).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
dbn_viterbi_kernel(const float* __restrict__ init,       // [B, n, P]
                   const float* __restrict__ lo_beat,    // [B, T]
                   const float* __restrict__ lo_off,     // [B, T]
                   const float* __restrict__ log_trans,  // [n, n] (from, to)
                   const int* __restrict__ intervals,    // [n]
                   const int* __restrict__ beat_len,     // [n]: ceil(L / lambda)
                   uint8_t* __restrict__ bp,             // [B, T - 1, n]
                   int* __restrict__ phases,             // [B, T]
                   int* __restrict__ out_intervals,      // [B, T]
                   int T, int n, int P) {
  extern __shared__ float smem[];
  const int nP = n * P;
  float* cur = smem;                 // [n, P]
  float* nxt = cur + nP;             // [n, P]
  float* lt = nxt + nP;              // [n, n]
  float* enter = lt + n * n;         // [n]: score entering phase 0
  float* lastv = enter + n;          // [n]: score at phase L_i - 1
  int* L = reinterpret_cast<int*>(lastv + n);
  int* bl = L + n;
  float* red_v = reinterpret_cast<float*>(bl + n);  // [kWarps]
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int k = tid; k < n * n; k += kThreads) lt[k] = log_trans[k];
  for (int k = tid; k < n; k += kThreads) {
    L[k] = intervals[k];
    bl[k] = beat_len[k];
  }
  const float* init_b = init + static_cast<size_t>(b) * nP;
  for (int k = tid; k < nP; k += kThreads) cur[k] = init_b[k];
  __syncthreads();
  for (int k = tid; k < n; k += kThreads) lastv[k] = cur[k * P + L[k] - 1];
  __syncthreads();

  const float* lb_b = lo_beat + static_cast<size_t>(b) * T;
  const float* lo_b = lo_off + static_cast<size_t>(b) * T;
  uint8_t* bp_b = bp + static_cast<size_t>(b) * (T - 1) * n;
  for (int t = 1; t < T; ++t) {
    // phase 0 of each target tempo j: the best source tempo (first maximum)
    if (tid < n) {
      float best = lastv[0] + lt[tid];
      int arg = 0;
      for (int i = 1; i < n; ++i) {
        const float v = lastv[i] + lt[i * n + tid];
        if (v > best) {
          best = v;
          arg = i;
        }
      }
      enter[tid] = best;
      bp_b[static_cast<size_t>(t - 1) * n + tid] = static_cast<uint8_t>(arg);
    }
    __syncthreads();
    const float lb = lb_b[t];
    const float lo = lo_b[t];
    for (int i = warp; i < n; i += kWarps) {
      const int Li = L[i];
      const int bli = bl[i];
      for (int p = lane; p < P; p += 32) {
        float v = kNegInf;
        if (p < Li) {
          const float prev = p == 0 ? enter[i] : cur[i * P + p - 1];
          v = prev + (p < bli ? lb : lo);
          if (p == Li - 1) lastv[i] = v;
        }
        nxt[i * P + p] = v;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // flat argmax over [n, P] in row-major order, first maximum: each thread
  // starts from index 0 and scans its ascending indices with a strict >, then
  // (value, index) pairs reduce with the lower index winning a tie
  float bv = cur[0];
  int bi = 0;
  for (int k = tid; k < nP; k += kThreads) {
    if (cur[k] > bv) {
      bv = cur[k];
      bi = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid != 0) return;
  bv = red_v[0];
  bi = red_i[0];
  for (int w = 1; w < kWarps; ++w) {
    if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
      bv = red_v[w];
      bi = red_i[w];
    }
  }

  // backtrack: the phase falls by one per earlier frame; at phase 0 the
  // previous state is (backpointer of the tempo, its last phase)
  int tempo = bi / P;
  int phase = bi % P;
  int* ph_b = phases + static_cast<size_t>(b) * T;
  int* iv_b = out_intervals + static_cast<size_t>(b) * T;
  ph_b[T - 1] = phase;
  iv_b[T - 1] = L[tempo];
  for (int k = T - 2; k >= 0; --k) {
    if (phase == 0) {
      tempo = bp_b[static_cast<size_t>(k) * n + tempo];
      phase = L[tempo] - 1;
    } else {
      phase -= 1;
    }
    ph_b[k] = phase;
    iv_b[k] = L[tempo];
  }
}

}  // namespace

extern "C" {

// init [B, n, P], lo_beat and lo_off [B, T], log_trans [n, n] float32;
// intervals and beat_len [n] int32; bp [B, T - 1, n] uint8 scratch;
// phases and out_intervals [B, T] int32. All contiguous, on the device.
int dbn_viterbi_f32(const void* init, const void* lo_beat, const void* lo_off, const void* log_trans,
                    const void* intervals, const void* beat_len, void* bp, void* phases, void* out_intervals,
                    int B, int T, int n, int P, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || n < 1 || n > 255 || P < 1) return -1;
  // the kernel's layout: two scores, the transition matrix, two [n] float
  // and two [n] int vectors, and the argmax's (value, index) per warp
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(n) * P + n * n + 2 * n + kWarps) + sizeof(int) * (2 * n + kWarps);
  int device = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return -2;
  err = cudaFuncSetAttribute(dbn_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dbn_viterbi_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(init), static_cast<const float*>(lo_beat), static_cast<const float*>(lo_off),
      static_cast<const float*>(log_trans), static_cast<const int*>(intervals), static_cast<const int*>(beat_len),
      static_cast<uint8_t*>(bp), static_cast<int*>(phases), static_cast<int*>(out_intervals), T, n, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
