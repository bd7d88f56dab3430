// Sum-product chunk summaries for 16 < q <= 128 states (K9), for Hopper
// (sm_90a).
//
// K9 — replaces sum_chunk_summaries_mxu
// (hmm_layer_tpu/ops/pallas_mxu.py:147, body _mxu_summary_kernel :64-143).
// It computes the same chunk transfer operators as K1 (sum_product.cu) for
// the state counts K1's registers cannot hold:
//
//   C[r, i, j] = log P(chunk-r emissions, right border j | left border i).
//
// Each row (r, i) of the operator evolves on its own:
//   step 0:  s = max(R0[i, :], 0) * max(e_0, EPS), R0 the identity row i
//            for the first chunk of a sequence (r % P == 0), row i of A
//            otherwise;
//   step t:  s = max(M A, EPS) * max(e_t, EPS);
//   each:    z = max(sum_j s, 1e-30), M = s / z, LL += log z;
//   end:     C[r, i, :] = log(max(M, 1e-30)) + LL.
// The row normaliser is the only reduction.
//
// Mapping: ONE WARP PER ROW (r, i). Lane l holds M[i, j] for j = l + 32u,
// u < NJ = ceil(q / 32) (four columns per lane at q = 128). A lives in
// shared memory, padded with zeros to 32 * NJ rows and columns, so the
// inner loop runs over all 32 * NJ values of k with no branch on q (a
// branch per k keeps the shuffles from overlapping: 5.0 ms instead of
// 2.7 ms at q = 29, R = 1,056, c = 303 on an H100); the padded terms add
// exact zeros. Above 48 KB
// (q > 96) the launch raises the block's dynamic shared-memory limit. Each
// step broadcasts M[i, k]
// with __shfl_sync, accumulates the product with IEEE float32 FMAs (no
// TF32, no tensor cores: the TPU version of this kernel lost 0.66 nats of
// log-likelihood to a reduced-precision default, pallas_mxu.py:12-16), and
// a butterfly sum over the warp gives the normaliser. The order of the sums
// differs from the plain version's matmul, so the two agree to rounding,
// not bit for bit.
//
// Bound on an H100: operations — R * q rows, c steps, q * q FMAs each:
// 15.6 GFLOP at q = 29, R = 1,056, c = 303, against 41 MB of emissions in
// and operators out. What holds it above that bound: per FMA one
// shared-memory load of A and, per k, one shuffle; the card issues one of
// each per SM and clock.
//
// Layouts (float32, contiguous; R = b * P chunk elements, lane r is
// sequence r / P and chunk r % P):
//   A    (m, q, q)     linear transition matrices
//   E_S  (m, c, R, q)  linear emissions, states last (a warp reads one
//                      row: coalesced)
//   C    (m, R, q, q)  log operators
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not cudaSuccess. It launches on the caller's
// stream and never synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int MIN_Q = 17, MAX_Q = 128;
constexpr int ROWS = 8;  // warps (operator rows) per block
constexpr float EPS = 1e-16f;
constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <int NJ>
__global__ void __launch_bounds__(ROWS * 32)
    mxu_summary_kernel(const float* __restrict__ A,
                       const float* __restrict__ E_S, float* __restrict__ C,
                       int c, int q, int R, int P) {
  constexpr int QP = 32 * NJ;
  extern __shared__ float sA[];  // sA[k * QP + j] = A[k, j], 0 past q
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x;
  const int i = blockIdx.y * ROWS + threadIdx.x / 32;
  const int mi = blockIdx.z;
  const float* Am = A + (size_t)mi * q * q;
  for (int idx = threadIdx.x; idx < QP * QP; idx += blockDim.x) {
    const int k = idx / QP, j = idx % QP;
    sA[idx] = (k < q && j < q) ? Am[k * q + j] : 0.f;
  }
  __syncthreads();
  if (i >= q) return;  // the whole warp leaves together

  const size_t Rq = (size_t)R * q;
  const float* e = E_S + (size_t)mi * c * Rq + (size_t)r * q;
  const bool first = (r % P) == 0;

  float M[NJ];
  float part = 0.f;
#pragma unroll
  for (int u = 0; u < NJ; ++u) {
    const int j = lane + 32 * u;
    M[u] = 0.f;
    if (j < q) {
      const float r0 = first ? (i == j ? 1.f : 0.f) : sA[i * QP + j];
      M[u] = fmaxf(r0, 0.f) * fmaxf(e[j], EPS);
      part += M[u];
    }
  }
  float z = fmaxf(warp_sum(part), TINY);
#pragma unroll
  for (int u = 0; u < NJ; ++u) M[u] = M[u] / z;
  float LL = logf(z);

  for (int t = 1; t < c; ++t) {
    const float* et = e + (size_t)t * Rq;
    float ev[NJ];
#pragma unroll
    for (int u = 0; u < NJ; ++u) {
      const int j = lane + 32 * u;
      ev[u] = j < q ? fmaxf(et[j], EPS) : 0.f;
    }
    float acc[NJ];
#pragma unroll
    for (int u = 0; u < NJ; ++u) acc[u] = 0.f;
#pragma unroll
    for (int w = 0; w < NJ; ++w) {
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        const float mk = __shfl_sync(FULL, M[w], kk);  // 0 past q
        const float* row = sA + (32 * w + kk) * QP + lane;
#pragma unroll
        for (int u = 0; u < NJ; ++u) acc[u] = fmaf(mk, row[32 * u], acc[u]);
      }
    }
    part = 0.f;
#pragma unroll
    for (int u = 0; u < NJ; ++u) {
      M[u] = fmaxf(acc[u], EPS) * ev[u];  // 0 for j >= q
      part += M[u];
    }
    z = fmaxf(warp_sum(part), TINY);
#pragma unroll
    for (int u = 0; u < NJ; ++u) M[u] = M[u] / z;
    LL += logf(z);
  }

  float* out = C + (((size_t)mi * R + r) * q + i) * q;
#pragma unroll
  for (int u = 0; u < NJ; ++u) {
    const int j = lane + 32 * u;
    if (j < q) out[j] = logf(fmaxf(M[u], TINY)) + LL;
  }
}

template <int NJ>
cudaError_t launch(const float* A, const float* E_S, float* C, int m, int c,
                   int q, int R, int P, cudaStream_t stream) {
  const size_t smem = (size_t)32 * NJ * 32 * NJ * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mxu_summary_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)R, (unsigned)((q + ROWS - 1) / ROWS), (unsigned)m);
  mxu_summary_kernel<NJ><<<grid, ROWS * 32, smem, stream>>>(A, E_S, C, c, q, R, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hmm_sum_chunk_summaries_mxu(const float* A, const float* E_S, float* C,
                                int m, int c, int q, int R, int P, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q < MIN_Q || q > MAX_Q) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q <= 32) return (int)launch<1>(A, E_S, C, m, c, q, R, P, s);
  if (q <= 64) return (int)launch<2>(A, E_S, C, m, c, q, R, P, s);
  if (q <= 96) return (int)launch<3>(A, E_S, C, m, c, q, R, P, s);
  return (int)launch<4>(A, E_S, C, m, c, q, R, P, s);
}

}  // extern "C"
