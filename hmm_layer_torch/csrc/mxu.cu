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
// Bound on an H100: operations — R * q rows, c - 1 steps of q * q FMAs
// each: 15.6 GFLOP at q = 29, R = 1,056, c = 303 (16.6 G operations with
// the clamp, product, sum and scale: 0.248 ms at 67 TFLOP/s), against 41
// MB of emissions in and operators out (0.012 ms).
//
// What held the first body back: it gave one warp to each operator row and,
// per k of a step, broadcast M[i, k] with a shuffle and read A[k, j] with
// one shared-memory load per FMA, then summed the row with 5 shuffles. At
// q = 29 a row-step sent ~70 instructions to the shared-memory pipe (37
// shuffles, 32 loads) for 32 FMAs; that pipe takes about one warp
// instruction per SM and clock, so the kernel ran at that pipe's rate
// (2.71 ms at q = 29, R = 1,056, c = 303 on an H100, 11x the bound) with
// the FMA pipe ~10% busy.
//
// Design: every row of element r shares A and the emission row e_t, so a
// step is one (QP x QP) (QP x QP) product followed by a row rescale, QP = q
// rounded up to 32. A group of NT threads owns an element; each thread
// holds a TM x TN tile of the product in registers (TM consecutive rows, TN
// columns in 16-byte chunks NC apart), and per k reads TM values of column
// k of M and TN values of row k of A as 16-byte words (64 FMAs for four
// loads at 8 x 8) instead of one load and one shuffle per FMA. The
// element's running operator lives in shared memory transposed (Mt[k][i] =
// M[i, k]), its chunks swizzled (mt_xor) so that the epilogue's stores are
// free of bank conflicts; it is double-buffered, so a step needs one group
// barrier (__syncwarp for a group inside a warp, a named barrier for a group
// of several warps, __syncthreads for one element a block). A, padded with
// zeros to QP x QP, is staged once a block and shared by its elements; the
// product runs over k < q only, and the padded rows and columns carry exact
// zeros (M's columns j >= q are multiplied by e = 0), so nothing branches
// on q inside a step. The epilogue stays in registers: clamp at EPS, times
// e_t, each row summed over the NC = QP / TN threads that share it by xor
// shuffles, one reciprocal a row, log z added to LL by one of those
// threads, the new M written to the other buffer. Padded rows i >= q are
// computed and never stored. The emissions of the next TS steps of each
// element arrive in a two-slot cp.async ring while the current TS are
// worked through. All arithmetic is IEEE float32 on the CUDA cores: no
// TF32, no tensor cores (the TPU version of this kernel lost 0.66 nats of
// log-likelihood to a reduced-precision default, pallas_mxu.py:12-16). The
// sums run in another order than the plain version's matmul, so the two
// agree to rounding, not bit for bit.
//
// What holds it now (H100, q = 29, tune_scans.py and copies of this file):
// the product. Shared memory serves a 16-byte load a quarter-warp at a
// time, 128 bytes a clock per SM whether or not lanes share addresses, so an
// 8 x 8 tile's 16 floats per k take as many clocks of the shared-memory
// pipe as its 64 FMAs take of the FMA pipe; larger tiles would leave
// schedulers idle at 8 elements per SM. The epilogue and barrier take about
// a quarter of the time.
//
// Layouts (float32, contiguous; R = b * P chunk elements, lane r is
// sequence r / P and chunk r % P):
//   A    (m, q, q)     linear transition matrices
//   E_S  (m, c, R, q)  linear emissions, states last
//   C    (m, R, q, q)  log operators
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not cudaSuccess. It launches on the caller's
// stream and never synchronises.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int MIN_Q = 17, MAX_Q = 128;
constexpr float EPS = 1e-16f;
constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

// Tiling: a TM x TN tile of the product a thread (at QP = 96, 12 columns,
// so that QP / TN stays a power of two), TS steps of emissions a ring slot,
// G elements a block at QP = 32 (one at QP >= 64). These may be set with -D
// to try others (hmm_layer_torch/tune_scans.py); the build uses the values
// below.
#ifndef MXU_TM
#define MXU_TM 8
#endif
#ifndef MXU_TN
#define MXU_TN 8
#endif
#ifndef MXU_TS
#define MXU_TS 16
#endif
#ifndef MXU_G
#define MXU_G 8
#endif

template <int QP>
struct Tiling {
  static constexpr int TM = MXU_TM;
  static constexpr int TN = QP == 96 ? 12 : MXU_TN;
  static constexpr int NC = QP / TN;  // threads that share a row
  static constexpr int NT = NC * (QP / TM);  // threads an element
  static constexpr int G = QP == 32 ? MXU_G : 1;
  static constexpr int TS = MXU_TS;
  static constexpr int ELEM = 2 * QP * QP + 2 * TS * QP;  // floats an element: two Mt, two slots
  static constexpr int SMEM = (int)sizeof(float) * (QP * QP + G * ELEM);
  static_assert(TM % 4 == 0 && TN % 4 == 0 && QP % TM == 0 && QP % TN == 0, "tile shape");
  static_assert(NC >= 4 && NC <= 32 && (NC & (NC - 1)) == 0,
                "a row's threads: a power of two in a warp");
  static_assert(NC >= 8 || TM <= 8, "the swizzle of a quarter-warp's two row groups");
  static_assert((G * NT) % 32 == 0 && G * NT <= 1024, "whole warps, at most 1024 threads");
  static_assert(NT % 32 == 0 || 32 % NT == 0, "a group: whole warps or part of one");
  static_assert(G == 1 || NT <= 32 || G <= 15, "named barriers 1 .. 15");
};

// 1 / z within an ulp: an approximate reciprocal and one Newton step. A row
// of s times it is s / z within about an ulp; the IEEE quotient of every
// entry (div_by in sum_product.cu, two more FMAs each) made the kernel 4%
// slower on an H100 at q = 29, and the sums already run in another order
// than the plain version's.
__device__ __forceinline__ float recip(float z) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return fmaf(r, fmaf(-z, r, 1.f), r);
}

// Chunks (16-byte words) of a row in shared memory: chunk
// (base + w * stride) ^ x into d[4w .. 4w + 3], for w < N / 4.
template <int N>
__device__ __forceinline__ void load_chunks(float (&d)[N], const float* row, int base, int stride,
                                            int x = 0) {
#pragma unroll
  for (int w = 0; w < N / 4; ++w) {
    const float4 v = reinterpret_cast<const float4*>(row)[(base + w * stride) ^ x];
    d[4 * w] = v.x;
    d[4 * w + 1] = v.y;
    d[4 * w + 2] = v.z;
    d[4 * w + 3] = v.w;
  }
}

// Row j of Mt keeps its chunk c (rows 4c .. 4c + 3 of M) in slot c ^ mt_xor(j),
// so that the 8 lanes of a quarter-warp, which store one chunk each into the
// rows of their own columns, hit 8 different bank groups (one 16-byte store
// instruction is served a quarter-warp at a time; unswizzled, the lanes of
// one row group all hit the same banks). A quarter-warp holds the column
// groups tc = 0 .. 7 of one row group (NC >= 8), whose rows j have
// j / 4 = tc + NC * cw, or at NC = 4 two row groups, whose chunks differ in
// bit log2(CM) (CM chunks a thread's rows): the column group's two bits then
// go to the other two bits. Reads of row k xor by the same value, a
// permutation of the chunks that all threads share.
template <int NC, int CM>
__device__ __forceinline__ int mt_xor(int j) {
  const int jc = j >> 2;
  if constexpr (NC >= 8) {
    return jc & 7;
  } else if constexpr (CM == 1) {
    return (jc & 3) << 1;
  } else {
    return (jc & 1) | ((jc & 2) << 1);
  }
}

// The barrier of element group g: the block when it holds one element, the
// warp when the group lies inside one (every lane of the warp runs the same
// steps), else named barrier g + 1 over the group's NT threads.
template <int NT, int G>
__device__ __forceinline__ void group_sync(int g) {
  if constexpr (G == 1) {
    __syncthreads();
  } else if constexpr (NT <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(NT) : "memory");
  }
}

template <int QP>
__global__ void __launch_bounds__(Tiling<QP>::G * Tiling<QP>::NT)
    mxu_summary_kernel(const float* __restrict__ A, const float* __restrict__ E_S,
                       float* __restrict__ C, int c, int q, int R, int P) {
  using T = Tiling<QP>;
  constexpr int TM = T::TM, TN = T::TN, NC = T::NC, NT = T::NT, G = T::G, TS = T::TS;
  constexpr int SLOTS = (TM + NC - 1) / NC;  // rows whose LL a thread keeps
  constexpr int CM = TM / 4;  // 16-byte chunks of a thread's rows
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;  // sA[k * QP + j] = A[k, j], 0 past q
  const int g = threadIdx.x / NT;  // the block's element
  const int gt = threadIdx.x % NT;
  const int tc = gt % NC, tr = gt / NC;
  // The thread's rows i0 + u (chunks tr * CM + w) and columns
  // col(v) = 4 * (tc + NC * (v / 4)) + v % 4: chunk tc + NC * cw, so that the
  // column groups of a quarter-warp read neighbouring chunks of a row of A.
  const int i0 = tr * TM;
  auto col = [&](int v) { return 4 * (tc + NC * (v / 4)) + v % 4; };
  const int sw = mt_xor<NC, CM>(4 * tc);  // the swizzle of the rows of Mt this thread writes
  const int mi = blockIdx.y;
  const int r = blockIdx.x * G + g;
  const bool real = r < R;  // groups past R run on zero emissions, store nothing
  float* elem = smem + QP * QP + g * T::ELEM;
  float* Mt = elem;  // two buffers [QP][QP]: row k holds column k of M, its chunks swizzled
  float* ring = elem + 2 * QP * QP;  // two slots [TS][QP], 0 past q

  const float* Am = A + (size_t)mi * q * q;
  for (int idx = threadIdx.x; idx < QP * QP; idx += blockDim.x) {
    const int k = idx / QP, j = idx % QP;
    sA[idx] = (k < q && j < q) ? Am[k * q + j] : 0.f;
  }
  for (int idx = gt; idx < 2 * TS * QP; idx += NT) ring[idx] = 0.f;
  __syncthreads();

  const size_t Rq = (size_t)R * q;
  const float* e = E_S + (size_t)mi * c * Rq + (size_t)r * q;
  const int ntiles = (c + TS - 1) / TS;
  // Emissions of steps [it * TS, it * TS + TS) into slot it % 2, one
  // commit group per thread (empty past the last tile or R).
  auto stage = [&](int it) {
    if (real && it < ntiles) {
      float* dst = ring + (it & 1) * TS * QP;
      const float* src = e + (size_t)it * TS * Rq;
      const int n = min(TS, c - it * TS) * q;
      for (int idx = gt; idx < n; idx += NT) {
        const int tt = idx / q, j = idx - tt * q;
        __pipeline_memcpy_async(dst + tt * QP + j, src + (size_t)tt * Rq + j, 4);
      }
    }
    __pipeline_commit();
  };
  // The thread's emission factors of one step: max(e, EPS), 0 past q.
  auto emission = [&](const float* row, float (&ev)[TN]) {
    load_chunks<TN>(ev, row, tc, NC);
#pragma unroll
    for (int v = 0; v < TN; ++v) ev[v] = col(v) < q ? fmaxf(ev[v], EPS) : 0.f;
  };

  float acc[TM][TN];
  float LL[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) LL[s] = 0.f;
  // acc = s / z row by row (times one reciprocal), LL += log z for the rows this thread keeps
  // (row s * NC + tc of its tile), and the new M into Mt_out.
  auto normalise = [&](float* Mt_out) {
    float z[TM];
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < TN; ++v) part += acc[u][v];
      z[u] = part;
    }
#pragma unroll
    for (int d = NC / 2; d > 0; d /= 2) {
#pragma unroll
      for (int u = 0; u < TM; ++u) z[u] += __shfl_xor_sync(FULL, z[u], d, NC);
    }
#pragma unroll
    for (int u = 0; u < TM; ++u) z[u] = fmaxf(z[u], TINY);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      float zs = 1.f;  // log 1 = 0 for a thread that keeps no row here
#pragma unroll
      for (int u = s * NC; u < TM && u < (s + 1) * NC; ++u) zs = u - s * NC == tc ? z[u] : zs;
      LL[s] += logf(zs);
    }
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const float rz = recip(z[u]);
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] *= rz;
    }
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      float4* dst = reinterpret_cast<float4*>(Mt_out + col(v) * QP);
#pragma unroll
      for (int w = 0; w < CM; ++w)
        dst[(tr * CM + w) ^ sw] =
            make_float4(acc[4 * w][v], acc[4 * w + 1][v], acc[4 * w + 2][v], acc[4 * w + 3][v]);
    }
  };

  const bool first = r % P == 0;
  int cur = 0;  // the buffer of Mt that holds the last step's M
  stage(0);
  for (int it = 0; it < ntiles; ++it) {
    __pipeline_wait_prior(0);
    group_sync<NT, G>(g);  // slot it % 2 landed; slot (it + 1) % 2 is read
    stage(it + 1);
    const float* tile = ring + (it & 1) * TS * QP;
    const int n = min(TS, c - it * TS);
    int tt = 0;
    if (it == 0) {
      float ev[TN];
      emission(tile, ev);
#pragma unroll
      for (int u = 0; u < TM; ++u) {
#pragma unroll
        for (int v = 0; v < TN; ++v) {
          const int i = i0 + u, j = col(v);
          const float r0 = first ? (i == j ? 1.f : 0.f) : sA[i * QP + j];
          acc[u][v] = fmaxf(r0, 0.f) * ev[v];
        }
      }
      normalise(Mt);
      group_sync<NT, G>(g);
      tt = 1;
    }
    for (; tt < n; ++tt) {
      // A and M are read anew each step (a compiler-only memory barrier),
      // as in K1, where hoisting A into registers spilled.
      asm volatile("" ::: "memory");
      const float* Mc = Mt + cur * QP * QP;
#pragma unroll
      for (int u = 0; u < TM; ++u) {
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;
      }
#pragma unroll 4
      for (int k = 0; k < q; ++k) {
        float mk[TM], a[TN];
        load_chunks<TM>(mk, Mc + k * QP, tr * CM, 1, mt_xor<NC, CM>(k));
        load_chunks<TN>(a, sA + k * QP, tc, NC);
#pragma unroll
        for (int u = 0; u < TM; ++u) {
#pragma unroll
          for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(mk[u], a[v], acc[u][v]);
        }
      }
      float ev[TN];
      emission(tile + tt * QP, ev);
#pragma unroll
      for (int u = 0; u < TM; ++u) {
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = fmaxf(acc[u][v], EPS) * ev[v];
      }
      cur ^= 1;
      normalise(Mt + cur * QP * QP);
      group_sync<NT, G>(g);
    }
  }

  float LLr[TM];  // every lane takes part in the shuffles
#pragma unroll
  for (int u = 0; u < TM; ++u) LLr[u] = __shfl_sync(FULL, LL[u / NC], u % NC, NC);
  if (real) {
    float* out = C + ((size_t)mi * R + r) * q * q;
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int i = i0 + u;
      if (i >= q) continue;
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const int j = col(v);
        if (j < q) out[(size_t)i * q + j] = logf(fmaxf(acc[u][v], TINY)) + LLr[u];
      }
    }
  }
}

template <int QP>
cudaError_t launch(const float* A, const float* E_S, float* C, int m, int c, int q, int R,
                   int P, cudaStream_t stream) {
  using T = Tiling<QP>;
  auto kernel = mxu_summary_kernel<QP>;
  if (T::SMEM > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)((R + T::G - 1) / T::G), (unsigned)m);
  kernel<<<grid, T::G * T::NT, T::SMEM, stream>>>(A, E_S, C, c, q, R, P);
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
  if (q <= 32) return (int)launch<32>(A, E_S, C, m, c, q, R, P, s);
  if (q <= 64) return (int)launch<64>(A, E_S, C, m, c, q, R, P, s);
  if (q <= 96) return (int)launch<96>(A, E_S, C, m, c, q, R, P, s);
  return (int)launch<128>(A, E_S, C, m, c, q, R, P, s);
}

}  // extern "C"
