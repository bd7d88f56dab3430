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
constexpr int LANES = 16;  // a lane group: a half-warp
constexpr unsigned FULL = 0xffffffffu;

// Tilings of K4 (COMP_) and K5 (OUT_): G chunk elements a block, TS steps a
// staged tile, NB tiles in the cp.async ring, the step loop unrolled UNROLL
// times. These may be set with -D to try others
// (hmm_layer_torch/tune_scans.py); the build uses the values below.
#ifndef COMP_G
#define COMP_G 8
#endif
#ifndef COMP_TS
#define COMP_TS 8
#endif
#ifndef COMP_NB
#define COMP_NB 2
#endif
#ifndef COMP_UNROLL
#define COMP_UNROLL 2
#endif
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
// its own. For G <= 8 the xor is a multiple of 4, so the four words of an
// aligned float4 stay together and in order.
template <int G>
__device__ __forceinline__ int swz_xor(int g) {
  return ((g >> 1) * (32 / G)) & (LANES - 1);
}
template <int G>
__device__ __forceinline__ int swz(int g, int p) {
  return g * LANES + (p ^ swz_xor<G>(g));
}

// K4 — replaces affine_chunk_composites
// (hmm_layer_tpu/ops/pallas_adjoint.py:93, body _affine_summary_kernel
// :44-89).
//
// Each (model, chunk element r, composite column col), col in 0..q, carries
// column col of [K | o] on its own,
//   X[:, col] <- u * (B (v * X[:, col])) + [col == q] s,
// from [I | 0] at the chunk's right edge, walking t = c-1 ... 0. Column q is
// the offset o and is the only one that adds the source.
//
// Bound on an H100: operations. Each step does q*q FMAs per (r, col): at the
// flagship posterior VJP (2m = 2, q = 15, c = 303, R = 1056) that is 2.3e9
// FMAs against 116 MB of u, v and s read once.
//
// Design: one thread per (element, column), G elements a block of 16 G
// threads (K1's body turned to columns; at q = 15 the 16 columns fill a
// half-warp). The column stays in registers; B^T is in shared memory and a
// step reads it as 64 broadcast 16-byte words, k outer and p inner, so each
// acc[p] still sums its FMAs over k in ascending order, as the first
// version's acc = fmaf(B[p][k], w[k], acc) did. The u, v and s of TS steps
// at a time come from a ring of NB cp.async tiles, staged once per element
// and read as broadcasts by its 16 columns (the first version read them
// from global memory inside the chain, once per column). The tiles are
// walked from the chunk's end, as K5's; slots of states >= q and of
// elements past R stay zero, so padded states carry exact zeros.
template <int G, int TS, int NB, int UNROLL>
__global__ void __launch_bounds__(G * LANES)
    affine_composites_kernel(const float* __restrict__ B,
                             const float* __restrict__ U,
                             const float* __restrict__ V,
                             const float* __restrict__ S,
                             float* __restrict__ comp, int c, int q, int R) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "float4 reads need swz_xor % 4 == 0");
  extern __shared__ __align__(16) float tiles_mem[];  // [NB][u, v, s][TS][G * LANES]
  __shared__ __align__(16) float sBT[MAXQ][MAXQ];     // sBT[k][p] = B[p][k]
  constexpr int ROW = G * LANES, PLANE = TS * ROW, TILE = 3 * PLANE;
  const int col = threadIdx.x % LANES;  // this thread's column; q is the offset
  const int g = threadIdx.x / LANES;    // its element in the block
  const int mi = blockIdx.y;
  const int rb = blockIdx.x * G;        // first element of the block
  const int r = rb + g;
  const int nr = min(G, R - rb);        // elements of the block below R
  const bool offset = col == q;
  const int xq = swz_xor<G>(g) / 4;     // float4 word w of the element's row is at w ^ xq
  // Staging: thread (sg, sp) copies row sp of element sg.
  const int sg = threadIdx.x % G, sp = threadIdx.x / G;
  const bool mover = sg < nr && sp < q;

  for (int idx = threadIdx.x; idx < NB * TILE; idx += blockDim.x) tiles_mem[idx] = 0.f;
  const float* Bm = B + (size_t)mi * q * q;
  for (int idx = threadIdx.x; idx < MAXQ * MAXQ; idx += blockDim.x) {
    const int k = idx / MAXQ, p = idx % MAXQ;
    sBT[k][p] = (p < q && k < q) ? Bm[p * q + k] : 0.f;
  }
  __syncthreads();  // also orders the zeros before the first copies

  const size_t plane = (size_t)q * R;  // one step of U, V or S
  const size_t at = (size_t)mi * c * plane + (size_t)sp * R + rb + sg;
  const float *u = U + at, *v = V + at, *s = S + at;

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

  float X[LANES];
  for (int i = 0; i < NB - 1; ++i) stage(i);
  for (int i = 0; i < ntiles; ++i) {
    const int lo = lo_of(i), n = c - i * TS - lo;
    const float* tile = tiles_mem + (i % NB) * TILE + g * LANES;
    __pipeline_wait_prior(NB - 2);  // this thread's copies of tile i are done
    __syncthreads();  // ... and every thread's; tile i-1 is read
    stage(i + NB - 1);  // into the buffer of tile i-1
    int tt = n - 1;
    if (i == 0) {  // step c-1 applied to [I | 0]: X[p] = B[p][col] v_col u_p, or s_p
      const float* slot = tile + tt * ROW;
      const float vc = slot[PLANE + (col ^ (4 * xq))];
#pragma unroll
      for (int w = 0; w < LANES / 4; ++w) {
        const float4 u4 = reinterpret_cast<const float4*>(slot)[w ^ xq];
        const float4 s4 = reinterpret_cast<const float4*>(slot + 2 * PLANE)[w ^ xq];
        const float4 b4 = reinterpret_cast<const float4*>(sBT[col])[w];
        X[4 * w] = offset ? s4.x : b4.x * vc * u4.x;
        X[4 * w + 1] = offset ? s4.y : b4.y * vc * u4.y;
        X[4 * w + 2] = offset ? s4.z : b4.z * vc * u4.z;
        X[4 * w + 3] = offset ? s4.w : b4.w * vc * u4.w;
      }
      --tt;
    }
#pragma unroll UNROLL
    for (; tt >= 0; --tt) {
      // B^T is read anew each step (a compiler-only memory barrier): hoisted
      // out of the loop, its 256 words would take the registers and spill,
      // as they did in K1 (sum_product.cu).
      asm volatile("" ::: "memory");
      const float4* u4 = reinterpret_cast<const float4*>(tile + tt * ROW);
      const float4* v4 = reinterpret_cast<const float4*>(tile + PLANE + tt * ROW);
      const float4* s4 = reinterpret_cast<const float4*>(tile + 2 * PLANE + tt * ROW);
      float w[LANES], acc[LANES];
#pragma unroll
      for (int j = 0; j < LANES / 4; ++j) {
        const float4 vv = v4[j ^ xq];
        w[4 * j] = vv.x * X[4 * j];
        w[4 * j + 1] = vv.y * X[4 * j + 1];
        w[4 * j + 2] = vv.z * X[4 * j + 2];
        w[4 * j + 3] = vv.w * X[4 * j + 3];
      }
#pragma unroll
      for (int p = 0; p < LANES; ++p) acc[p] = 0.f;
#pragma unroll
      for (int k = 0; k < LANES; ++k) {
        const float4* b4 = reinterpret_cast<const float4*>(sBT[k]);
#pragma unroll
        for (int j = 0; j < LANES / 4; ++j) {
          const float4 b = b4[j];
          acc[4 * j] = fmaf(b.x, w[k], acc[4 * j]);
          acc[4 * j + 1] = fmaf(b.y, w[k], acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(b.z, w[k], acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(b.w, w[k], acc[4 * j + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < LANES / 4; ++j) {
        const float4 uu = u4[j ^ xq];
        const float4 ss = s4[j ^ xq];
        const float uj[4] = {uu.x, uu.y, uu.z, uu.w}, sj[4] = {ss.x, ss.y, ss.z, ss.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = acc[4 * j + e];
          a = uj[e] * a;
          if (offset) a += sj[e];
          X[4 * j + e] = a;
        }
      }
    }
  }
  if (r < R && col <= q) {
    float* out = comp + ((size_t)mi * R + r) * q * (q + 1) + col;
#pragma unroll
    for (int p = 0; p < LANES; ++p)
      if (p < q) out[(size_t)p * (q + 1)] = X[p];
  }
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

// Raises the block's limit of dynamic shared memory to smem where smem and
// the kernel's static shared memory together exceed the default 48 KB.
template <class K>
cudaError_t allow_smem(K kernel, int smem, int static_smem = 0) {
  if (smem + static_smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

int hmm_affine_chunk_composites(const float* B, const float* U, const float* V,
                                const float* S, float* comp, int m, int c,
                                int q, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int G = COMP_G, TS = COMP_TS, NB = COMP_NB;
  constexpr int smem = NB * 3 * TS * G * LANES * (int)sizeof(float);
  constexpr int static_smem = MAXQ * MAXQ * (int)sizeof(float);  // its copy of B^T
  auto kernel = affine_composites_kernel<G, TS, NB, COMP_UNROLL>;
  if ((err = allow_smem(kernel, smem, static_smem)) != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((R + G - 1) / G), (unsigned)m);
  kernel<<<grid, G * LANES, smem, (cudaStream_t)stream>>>(B, U, V, S, comp, c, q, R);
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
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((R + G - 1) / G), (unsigned)m);
  kernel<<<grid, G * LANES, smem, (cudaStream_t)stream>>>(B, U, V, S, x_right, out, c, q, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
