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

#include <cuda_pipeline.h>
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

// Lane groups for the output scan K5: LANES lanes (a half-warp) own one
// chunk element, lane j its state j, and a block holds OUT_G chunk elements.
// The u, v and s of OUT_TS steps at a time are staged in shared memory with
// cp.async, in a ring of OUT_NB tiles, and the outputs go back through the s
// tile; the step loop is unrolled OUT_UNROLL times. These may be set with -D
// to try other tilings (hmm_layer_torch/tune_scans.py); the build uses the
// values below.
constexpr int LANES = 16;
constexpr unsigned FULL = 0xffffffffu;
#ifndef OUT_G
#define OUT_G 16
#endif
#ifndef OUT_TS
#define OUT_TS 8
#endif
#ifndef OUT_NB
#define OUT_NB 4
#endif
#ifndef OUT_UNROLL
#define OUT_UNROLL 2
#endif

// Word of state p of element g in a tile row of LANES words per element.
// The xor spreads the staging copies and the flush (G elements by 32 / G
// states a warp) over all 32 banks; a half-warp's own run of 16 words stays
// its own.
template <int G>
__device__ __forceinline__ int swz(int g, int p) {
  return g * LANES + (p ^ (((g >> 1) * (32 / G)) & (LANES - 1)));
}

// K5 — replaces affine_reverse_outputs
// (hmm_layer_tpu/ops/pallas_adjoint.py:170, body _affine_out_kernel
// :145-166).
//
// One lane group per (model, chunk element r), carrying x from x_right in
// reverse time and writing x_t at every position: lane j keeps row j of B in
// registers and x_j. A step forms w_j = v_j x_j in its own lane, broadcasts
// w with LANES shuffles and runs one FMA chain over k in ascending order
// (sum_k B[j, k] w_k), then x_j = u_j * that + s_j with the product
// rounded before the add: the roundings of the thread-per-element version,
// in its order. Lanes j >= q carry exact zeros
// (a zero row of B, zero u, v and s). No branch surrounds a shuffle, and a
// group past R stays in the loop with its loads and stores masked (a
// full-mask shuffle needs the whole warp).
//
// Bound on an H100: bytes — u, v and s in and x out, 154 MB at the flagship
// posterior VJP (2m = 2, q = 15, c = 303, R = 1056), against 0.29 GFLOP.
// Design: a step is LANES lanes wide instead of one thread's q*q FMAs, short
// enough that the chain of c steps is no longer the limit; the loads stay
// out of the chain (a ring of OUT_NB tiles keeps the copies of the next
// steps in flight with cp.async while the current ones are worked through);
// each row (t, p) of the block's OUT_G elements is read and written as
// whole sectors (64 bytes at OUT_G = 16, one block of 8 warps per SM at the
// flagship), the outputs through the s tile.
template <int G, int TS, int NB, int UNROLL>
__global__ void __launch_bounds__(G * LANES)
    affine_outputs_kernel(const float* __restrict__ B,
                          const float* __restrict__ U,
                          const float* __restrict__ V,
                          const float* __restrict__ S,
                          const float* __restrict__ x_right,
                          float* __restrict__ out, int c, int q, int R) {
  extern __shared__ __align__(16) float tiles_mem[];  // [NB][u, v, s][TS][G * LANES]
  constexpr int ROW = G * LANES, PLANE = TS * ROW, TILE = 3 * PLANE;
  const int j = threadIdx.x % LANES;  // this lane's state
  const int g = threadIdx.x / LANES;  // this group's element in the block
  const int mi = blockIdx.y;
  const int rb = blockIdx.x * G;      // first element of the block
  const int r = rb + g;
  const bool real = r < R && j < q;   // other lanes read zeros, never the tile
  const int nr = min(G, R - rb);      // elements of the block below R
  // Staging and flush: thread (sg, sp) moves row sp of element sg.
  const int sg = threadIdx.x % G, sp = threadIdx.x / G;
  const bool mover = sg < nr && sp < q;

  const float* Bm = B + (size_t)mi * q * q;
  float brow[LANES];
#pragma unroll
  for (int k = 0; k < LANES; ++k) brow[k] = (k < q && j < q) ? Bm[j * q + k] : 0.f;

  const size_t plane = (size_t)q * R;  // one step of U, V, S or out
  const size_t at = (size_t)mi * c * plane + (size_t)sp * R + rb + sg;
  const float *u = U + at, *v = V + at, *s = S + at;
  float* o = out + at;

  // Tile i holds steps lo_of(i) ... c-1 - i*TS, walked downwards.
  const int ntiles = (c + TS - 1) / TS;
  auto lo_of = [&](int i) { return max(0, c - (i + 1) * TS); };
  auto stage = [&](int i) {  // copy the steps of tile i, one commit group
    if (mover && i < ntiles) {
      float* dst = tiles_mem + (i % NB) * TILE + swz<G>(sg, sp);
      const int lo = lo_of(i), n = c - i * TS - lo;
      for (int tt = 0; tt < n; ++tt) {
        const size_t off = (size_t)(lo + tt) * plane;
        __pipeline_memcpy_async(dst + tt * ROW, u + off, 4);
        __pipeline_memcpy_async(dst + PLANE + tt * ROW, v + off, 4);
        __pipeline_memcpy_async(dst + 2 * PLANE + tt * ROW, s + off, 4);
      }
    }
    __pipeline_commit();  // empty past the last tile: the count stays uniform
  };

  float x = real ? x_right[((size_t)mi * q + j) * R + r] : 0.f;
  for (int i = 0; i < NB - 1; ++i) stage(i);
  for (int i = 0; i < ntiles; ++i) {
    const int lo = lo_of(i), n = c - i * TS - lo;
    float* tile = tiles_mem + (i % NB) * TILE;
    __pipeline_wait_prior(NB - 2);  // this thread's copies of tile i are done
    __syncthreads();  // ... and every thread's; tile i-1 is flushed
    stage(i + NB - 1);  // into the buffer of tile i-1
#pragma unroll UNROLL
    for (int tt = n - 1; tt >= 0; --tt) {
      float* slot = tile + tt * ROW + swz<G>(g, j);
      const float ut = real ? slot[0] : 0.f;
      const float vt = real ? slot[PLANE] : 0.f;
      const float st = real ? slot[2 * PLANE] : 0.f;
      const float w = vt * x;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < LANES; ++k) acc = fmaf(brow[k], __shfl_sync(FULL, w, k, LANES), acc);
      acc = __fmul_rn(ut, acc);  // rounded before s is added: never fused
      acc += st;
      x = acc;
      slot[2 * PLANE] = x;
    }
    __syncthreads();  // the outputs of tile i are in place
    if (mover) {
      const float* src = tile + 2 * PLANE + swz<G>(sg, sp);
      for (int k = 0; k < n; ++k) o[(size_t)(lo + k) * plane] = src[k * ROW];
    }
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
  constexpr int G = OUT_G, TS = OUT_TS, NB = OUT_NB;
  constexpr int smem = NB * 3 * TS * G * LANES * (int)sizeof(float);
  auto kernel = affine_outputs_kernel<G, TS, NB, OUT_UNROLL>;
  if (smem > 48 * 1024) {  // above the default limit of dynamic shared memory
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((R + G - 1) / G), (unsigned)m);
  kernel<<<grid, G * LANES, smem, (cudaStream_t)stream>>>(B, U, V, S, x_right, out, c, q, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
