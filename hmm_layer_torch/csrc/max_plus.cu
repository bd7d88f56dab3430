// Max-plus (tropical) kernels of the chunked Viterbi decode, for Hopper
// (sm_90a).
//
// These are the CUDA counterparts of the q <= 16 Pallas TPU kernels in
// hmm_layer_tpu/ops/pallas_viterbi.py. They compute what those kernels
// compute, with the TPU tiling dropped: q <= 16 states exactly (no padding
// to 16 sublanes in memory), R chunk elements exactly (the ragged last block
// is masked), and the model axis m as a grid dimension.
//
// Layouts (float32 unless stated, contiguous; R = b * P chunk elements, lane
// r is sequence r / P and chunk r % P):
//   log_A    (m, q, q)     log(max(A, EPS))
//   log_E_T  (m, c, q, R)  log(max(E, EPS)); reading log_E_T[mi, t, p, r] for
//                          neighbouring r coalesces
//   C_T      (m, R, q, q)  C_T[mi, r, j, i] = best log path score from left
//                          border i to right border j (TRANSPOSED)
//   deltas   (m, c, q, R)  max-plus forward values at every position
//   states   (m, c, R)     int32 decoded state at every position
//
// Exactness: the tropical semiring needs no rescaling. Every step is one
// rounded float add per term (delta[k] + log_A[k, p]), an exact max, and one
// rounded add of the emission, in that order, as in the plain PyTorch
// versions (ops/cuda_viterbi.py): kernel and plain version are bit-equal.
// Built without --use_fast_math; nothing here can be contracted into an FMA.
//
// Padding: the carry has MAXQ entries and log A is padded to MAXQ x MAXQ
// with NEG = -1e30 (the JAX sentinel _NEG, finite: never -inf). Entries
// p >= q stay near NEG and never win a max against a real score, which is
// at least -37 per step (log EPS).
//
// Each entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not cudaSuccess. Launches go to the caller's
// stream and never synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int MAXQ = 16;
constexpr int BLOCK = 128;
constexpr float NEG = -1e30f;

// log A of one model into shared memory, padded with NEG. Every thread of
// the block calls it (it ends in a barrier).
__device__ __forceinline__ void load_log_A(float (&sA)[MAXQ][MAXQ],
                                           const float* __restrict__ log_A,
                                           int q) {
  for (int idx = threadIdx.x; idx < MAXQ * MAXQ; idx += blockDim.x) {
    const int k = idx / MAXQ, p = idx % MAXQ;
    sA[k][p] = (k < q && p < q) ? log_A[k * q + p] : NEG;
  }
  __syncthreads();
}

// One max-plus step of a q-vector carry:
//   v[p] <- max_k (v[k] + log_A[k, p]) + e_t[p].
// The empty asm with a memory clobber makes the compiler read log A from
// shared memory again on every step instead of hoisting its 256 entries into
// registers for the whole time loop (the sum-product K1 of sum_product.cu
// does that: 255 registers and spills). Rows of log A are read as broadcasts: every thread of a warp reads
// the same address.
__device__ __forceinline__ void maxplus_step(float (&v)[MAXQ],
                                             const float (&sA)[MAXQ][MAXQ],
                                             const float* __restrict__ et,
                                             int q, int R) {
  asm volatile("" ::: "memory");
  float acc[MAXQ];
#pragma unroll
  for (int p = 0; p < MAXQ; ++p) acc[p] = v[0] + sA[0][p];
#pragma unroll
  for (int k = 1; k < MAXQ; ++k) {
    const float vk = v[k];
#pragma unroll
    for (int p = 0; p < MAXQ; ++p) acc[p] = fmaxf(acc[p], vk + sA[k][p]);
  }
#pragma unroll
  for (int p = 0; p < MAXQ; ++p)
    v[p] = p < q ? acc[p] + et[(size_t)p * R] : acc[p];
}

// K6 — replaces maxplus_chunk_summaries
// (hmm_layer_tpu/ops/pallas_viterbi.py:151, body _kernel :103-147).
//
// One thread per (model, chunk element r, left-border state i). It carries
// column i of the transposed operator, v[j] = C_T[r, j, i], in registers:
// step 0 is the identity (0 / NEG) for chunk 0 of a sequence and row i of
// log A otherwise, plus the first emission; every later step is
// maxplus_step. No thread waits for another.
//
// Bound on an H100: operations. Each step does q*q adds and as many maxes
// per (r, i): 2.15e9 at the flagship shape (q=15, c=303, R=1056) against
// 20 MB of emissions in and operators out. Design: log A in shared memory,
// read as broadcasts; the carry never leaves registers; each emission load
// is one coalesced 128-byte line per warp. The transposed output is written
// once, strided.
__global__ void __launch_bounds__(BLOCK)
    chunk_summaries_kernel(const float* __restrict__ log_A,
                           const float* __restrict__ log_E_T,
                           float* __restrict__ C_T, int c, int q, int R,
                           int P) {
  __shared__ __align__(16) float sA[MAXQ][MAXQ];
  const int mi = blockIdx.z;
  const int i = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  load_log_A(sA, log_A + (size_t)mi * q * q, q);
  if (r >= R) return;

  const float* e = log_E_T + (size_t)mi * c * q * R + r;
  const bool first = (r % P) == 0;  // chunk 0 of its sequence

  float v[MAXQ];
#pragma unroll
  for (int j = 0; j < MAXQ; ++j) {
    const float start = first ? (i == j ? 0.f : NEG) : sA[i][j];
    v[j] = j < q ? start + e[(size_t)j * R] : NEG;
  }
  for (int t = 1; t < c; ++t) maxplus_step(v, sA, e + (size_t)t * q * R, q, R);

  float* out = C_T + ((size_t)mi * R + r) * q * q + i;
#pragma unroll
  for (int j = 0; j < MAXQ; ++j)
    if (j < q) out[(size_t)j * q] = v[j];
}

// K7 — replaces maxplus_deltas (hmm_layer_tpu/ops/pallas_viterbi.py:353,
// q <= 16 body _fwd_kernel :214-236).
//
// One thread per (model, chunk element r): delta_0 is the given start, every
// later position is maxplus_step, and delta is stored at every position.
//
// Bound on an H100: bytes — emissions in and deltas out, 38 MB at the
// flagship shape, against 0.14 G operations. Design: reads and writes
// coalesce along r. First version: only R threads (1056 at the flagship
// shape) run a c-step dependent chain, far from that bound (as K2).
__global__ void __launch_bounds__(BLOCK)
    deltas_kernel(const float* __restrict__ log_A,
                  const float* __restrict__ log_E_T,
                  const float* __restrict__ delta0,
                  float* __restrict__ deltas, int c, int q, int R) {
  __shared__ __align__(16) float sA[MAXQ][MAXQ];
  const int mi = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  load_log_A(sA, log_A + (size_t)mi * q * q, q);
  if (r >= R) return;

  const size_t base = (size_t)mi * c * q * R + r;
  const float* e = log_E_T + base;
  float* out = deltas + base;

  float v[MAXQ];
#pragma unroll
  for (int p = 0; p < MAXQ; ++p) {
    v[p] = p < q ? delta0[((size_t)mi * q + p) * R + r] : NEG;
    if (p < q) out[(size_t)p * R] = v[p];
  }
  for (int t = 1; t < c; ++t) {
    maxplus_step(v, sA, e + (size_t)t * q * R, q, R);
    float* ot = out + (size_t)t * q * R;
#pragma unroll
    for (int p = 0; p < MAXQ; ++p)
      if (p < q) ot[(size_t)p * R] = v[p];
  }
}

// K8 — replaces maxplus_backtrace (hmm_layer_tpu/ops/pallas_viterbi.py:433,
// q <= 16 body _backtrace_kernel :239-266).
//
// One thread per (model, chunk element r) walks t = c-1 ... 0 from the given
// last state: s_t = the LOWEST k maximising deltas[t, k] + log_A[k, s_{t+1}]
// (k ascending, strict >, as jnp.argmax and torch.argmax break ties). No
// backpointers: each decision is re-derived from the stored deltas. A state
// outside [0, q) selects an all-NEG column, as the Pallas select tree does.
//
// Bound on an H100: bytes — deltas in and int32 states out, 21 MB at the
// flagship shape. Design and first-version limit as K7.
__global__ void __launch_bounds__(BLOCK)
    backtrace_kernel(const float* __restrict__ log_A,
                     const float* __restrict__ deltas,
                     const int* __restrict__ last_state,
                     int* __restrict__ states, int c, int q, int R) {
  __shared__ float sA[MAXQ][MAXQ];
  const int mi = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  load_log_A(sA, log_A + (size_t)mi * q * q, q);
  if (r >= R) return;

  const float* d = deltas + (size_t)mi * c * q * R + r;
  int* out = states + (size_t)mi * c * R + r;
  int s = last_state[(size_t)mi * R + r];
  out[(size_t)(c - 1) * R] = s;
  for (int t = c - 2; t >= 0; --t) {
    const float* dt = d + (size_t)t * q * R;
    const bool valid = (unsigned)s < (unsigned)q;
    float best = dt[0] + (valid ? sA[0][s] : NEG);
    int arg = 0;
#pragma unroll
    for (int k = 1; k < MAXQ; ++k) {
      if (k < q) {
        const float w = dt[(size_t)k * R] + (valid ? sA[k][s] : NEG);
        if (w > best) {
          best = w;
          arg = k;
        }
      }
    }
    s = arg;
    out[(size_t)t * R] = s;
  }
}

inline unsigned blocks_for(int R) { return (unsigned)((R + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" {

int hmm_maxplus_chunk_summaries(const float* log_A, const float* log_E_T,
                                float* C_T, int m, int c, int q, int R, int P,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(R), (unsigned)q, (unsigned)m);
  chunk_summaries_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      log_A, log_E_T, C_T, c, q, R, P);
  return (int)cudaGetLastError();
}

int hmm_maxplus_deltas(const float* log_A, const float* log_E_T,
                       const float* delta0, float* deltas, int m, int c, int q,
                       int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(R), (unsigned)m);
  deltas_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      log_A, log_E_T, delta0, deltas, c, q, R);
  return (int)cudaGetLastError();
}

int hmm_maxplus_backtrace(const float* log_A, const float* deltas,
                          const int* last_state, int* states, int m, int c,
                          int q, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(R), (unsigned)m);
  backtrace_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      log_A, deltas, last_state, states, c, q, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
