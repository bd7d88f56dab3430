// Affine adjoint kernels of the chunked engine's analytic VJPs, for Hopper
// (sm_90a).
//
// These are the CUDA counterparts of the two Pallas TPU kernels in
// hmm_layer_tpu/ops/pallas_adjoint.py. Both solve, chunk by chunk, the
// reverse recursion
//
//   x_t = s_t + u_t * (B @ (v_t * x_{t+1}))
//
// that the VJPs of recursion.forward / backward / posterior reduce to. They
// compute what the Pallas kernels compute, with the TPU tiling dropped: q
// states exactly (no padding to 16 sublanes in memory), R chunk elements
// exactly (the ragged last block is masked), and the model axis m as a grid
// dimension (the posterior VJP stacks B = [A; A^T] as 2m models).
//
// Layouts (all float32, contiguous; R = b * P chunk elements, lane r is
// sequence r / P and chunk r % P):
//   B           (m, q, q)       linear map, A or A^T
//   U, V, S     (m, c, q, R)    per-step diagonals u, v and sources s;
//                               reading [mi, t, p, r] for neighbouring r
//                               coalesces
//   comp        (m, R, q, q+1)  per-chunk composite [K | o]:
//                               x_chunk_start = K @ x_chunk_end + o
//   x_right     (m, q, R)       adjoint entering each chunk's right edge
//   out         (m, c, q, R)    x at every position
//
// No rescaling: the map entries u_i B[i, k] v_k are softmax weights in
// [0, 1] and the sources are centred, as in the Pallas kernels. The sums
// run in another order than the plain PyTorch versions (ops/cuda_adjoint.py)
// and may contract into FMAs, so the two agree to a tolerance, not bitwise.
//
// Each entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not cudaSuccess. Launches go to the caller's
// stream and never synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int MAXQ = 16;
constexpr int BLOCK = 128;

// B of one model into shared memory, zero-padded to MAXQ x MAXQ. Every
// thread of the block calls it (it ends in a barrier).
__device__ __forceinline__ void load_B(float (&sB)[MAXQ][MAXQ],
                                       const float* __restrict__ B, int q) {
  for (int idx = threadIdx.x; idx < MAXQ * MAXQ; idx += blockDim.x) {
    const int p = idx / MAXQ, k = idx % MAXQ;
    sB[p][k] = (p < q && k < q) ? B[p * q + k] : 0.f;
  }
  __syncthreads();
}

// One step of the map on a carried q-vector: x <- u * (B (v * x)) [+ s].
// The empty asm with a memory clobber makes the compiler read B from shared
// memory again at every step instead of hoisting the q x q block into
// registers for the whole time loop (register spills otherwise).
__device__ __forceinline__ void affine_step(float (&x)[MAXQ],
                                            const float (&sB)[MAXQ][MAXQ],
                                            const float* __restrict__ ut,
                                            const float* __restrict__ vt,
                                            const float* __restrict__ st,
                                            int q, int R) {
  asm volatile("" ::: "memory");
  float w[MAXQ];
#pragma unroll
  for (int k = 0; k < MAXQ; ++k) w[k] = k < q ? vt[(size_t)k * R] * x[k] : 0.f;
#pragma unroll
  for (int p = 0; p < MAXQ; ++p) {
    float acc = 0.f;
    if (p < q) {
#pragma unroll
      for (int k = 0; k < MAXQ; ++k) acc = fmaf(sB[p][k], w[k], acc);
      acc = ut[(size_t)p * R] * acc;
      if (st != nullptr) acc += st[(size_t)p * R];
    }
    x[p] = acc;
  }
}

// K4 — replaces affine_chunk_composites
// (hmm_layer_tpu/ops/pallas_adjoint.py:93, body _affine_summary_kernel
// :44-89).
//
// One thread per (model, chunk element r, composite column col), col in
// 0..q: each column of [K | o] evolves on its own,
//   X[:, col] <- u * (B (v * X[:, col])) + [col == q] s,
// from [I | 0] at the chunk's right edge, walking t = c-1 ... 0. Column q is
// the offset o and is the only one that adds the source.
//
// Bound on an H100: operations. Each step does q*q FMAs per (r, col): at the
// flagship posterior VJP (2m = 2, q = 15, c = 303, R = 1056) that is 2.3e9
// FMAs against 116 MB of u, v and s read once. Design: B is read from shared
// memory as a broadcast, the column never leaves registers, and the loads of
// u, v and s coalesce along r. First version: the q+1 column blocks of one r
// range each read u and v again (from L2), and 288 blocks of 128 threads
// fill the 132 SMs only thinly.
__global__ void __launch_bounds__(BLOCK)
    affine_composites_kernel(const float* __restrict__ B,
                             const float* __restrict__ U,
                             const float* __restrict__ V,
                             const float* __restrict__ S,
                             float* __restrict__ comp, int c, int q, int R) {
  __shared__ float sB[MAXQ][MAXQ];
  const int mi = blockIdx.z;
  const int col = blockIdx.y;  // 0..q; q is the offset column
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  load_B(sB, B + (size_t)mi * q * q, q);
  if (r >= R) return;

  const size_t base = (size_t)mi * c * q * R + r;
  const bool offset = col == q;

  // First step (t = c-1) applied to [I | 0]:
  // X[p, col < q] = B[p, col] v_col u_p; X[p, q] = s_p.
  const size_t last = base + (size_t)(c - 1) * q * R;
  float X[MAXQ];
#pragma unroll
  for (int p = 0; p < MAXQ; ++p) {
    float x = 0.f;
    if (p < q) {
      x = offset ? S[last + (size_t)p * R]
                 : sB[p][col] * V[last + (size_t)col * R] * U[last + (size_t)p * R];
    }
    X[p] = x;
  }

  for (int t = c - 2; t >= 0; --t) {
    const size_t at = base + (size_t)t * q * R;
    affine_step(X, sB, U + at, V + at, offset ? S + at : nullptr, q, R);
  }

  float* out = comp + ((size_t)mi * R + r) * q * (q + 1) + col;
#pragma unroll
  for (int p = 0; p < MAXQ; ++p)
    if (p < q) out[(size_t)p * (q + 1)] = X[p];
}

// K5 — replaces affine_reverse_outputs
// (hmm_layer_tpu/ops/pallas_adjoint.py:170, body _affine_out_kernel
// :145-166).
//
// One thread per (model, chunk element r), carrying x from x_right in reverse
// time and writing x_t at every position.
//
// Bound on an H100: bytes — u, v and s in and x out, 154 MB at the flagship
// posterior VJP, against 0.29 GFLOP. Design: reads and writes coalesce along
// r. First version: only 2m * R threads (2,112 at the flagship) run a c-step
// dependent chain, far from that bound.
__global__ void __launch_bounds__(BLOCK)
    affine_outputs_kernel(const float* __restrict__ B,
                          const float* __restrict__ U,
                          const float* __restrict__ V,
                          const float* __restrict__ S,
                          const float* __restrict__ x_right,
                          float* __restrict__ out, int c, int q, int R) {
  __shared__ float sB[MAXQ][MAXQ];
  const int mi = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  load_B(sB, B + (size_t)mi * q * q, q);
  if (r >= R) return;

  const size_t base = (size_t)mi * c * q * R + r;
  float x[MAXQ];
#pragma unroll
  for (int p = 0; p < MAXQ; ++p)
    x[p] = p < q ? x_right[((size_t)mi * q + p) * R + r] : 0.f;

  for (int t = c - 1; t >= 0; --t) {
    const size_t at = base + (size_t)t * q * R;
    affine_step(x, sB, U + at, V + at, S + at, q, R);
#pragma unroll
    for (int p = 0; p < MAXQ; ++p)
      if (p < q) out[at + (size_t)p * R] = x[p];
  }
}

inline unsigned blocks_for(int R) { return (unsigned)((R + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" {

int hmm_affine_chunk_composites(const float* B, const float* U, const float* V,
                                const float* S, float* comp, int m, int c,
                                int q, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(R), (unsigned)(q + 1), (unsigned)m);
  affine_composites_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      B, U, V, S, comp, c, q, R);
  return (int)cudaGetLastError();
}

int hmm_affine_reverse_outputs(const float* B, const float* U, const float* V,
                               const float* S, const float* x_right,
                               float* out, int m, int c, int q, int R,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(R), (unsigned)m);
  affine_outputs_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      B, U, V, S, x_right, out, c, q, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
