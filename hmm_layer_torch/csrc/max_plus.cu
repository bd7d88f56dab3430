// Max-plus (tropical) kernels of the chunked Viterbi decode, for Hopper
// (sm_90a).
//
// These are the CUDA counterparts of the Pallas TPU kernels in
// hmm_layer_tpu/ops/pallas_viterbi.py: the q <= 16 bodies (K6-K8) and the
// blocked 16 < q <= 64 bodies of the delta pass and the backtrace (K7b,
// K8b, below K8). They compute what those kernels compute, with the TPU
// tiling dropped: q states exactly (no padding to sublanes in memory), R
// chunk elements exactly (the ragged last block is masked), and the model
// axis m as a grid dimension.
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
// (K7b and K8b take these sequence-major instead; see their section.)
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int MAXQ = 16;
constexpr float NEG = -1e30f;
constexpr int LANES = 16;  // a lane group: a half-warp, lane j = state j
constexpr unsigned FULL = 0xffffffffu;

// Tilings of K6 (MPS_), K7 (DELTA_) and K8 (TRACE_): G chunk elements a
// block, TS steps a staged tile, NB tiles in the cp.async ring, the step
// loop unrolled UNROLL times. These may be set with -D to try others
// (hmm_layer_torch/tune_scans.py); the build uses the values below.
#ifndef MPS_G
#define MPS_G 8
#endif
#ifndef MPS_TS
#define MPS_TS 32
#endif
#ifndef MPS_NB
#define MPS_NB 2
#endif
#ifndef MPS_UNROLL
#define MPS_UNROLL 2
#endif
#ifndef DELTA_G
#define DELTA_G 8
#endif
#ifndef DELTA_TS
#define DELTA_TS 16
#endif
#ifndef DELTA_NB
#define DELTA_NB 2
#endif
#ifndef DELTA_UNROLL
#define DELTA_UNROLL 1
#endif
#ifndef TRACE_G
#define TRACE_G 8
#endif
#ifndef TRACE_TS
#define TRACE_TS 16
#endif
#ifndef TRACE_NB
#define TRACE_NB 2
#endif
#ifndef TRACE_UNROLL
#define TRACE_UNROLL 2
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

// Raises the block's limit of dynamic shared memory to smem where smem and
// the kernel's static shared memory together exceed the default 48 KB.
template <class K>
cudaError_t allow_smem(K kernel, int smem, int static_smem = 0) {
  if (smem + static_smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

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

// K6 — replaces maxplus_chunk_summaries
// (hmm_layer_tpu/ops/pallas_viterbi.py:151, body _kernel :103-147).
//
// Each (model, chunk element r, left-border state i) carries column i of the
// transposed operator, v[j] = C_T[r, j, i], in registers: step 0 is the
// identity (0 / NEG) for chunk 0 of a sequence and row i of log A otherwise,
// plus the first emission; every later step is
//   v[p] <- max_k (v[k] + log_A[k, p]) + e_t[p],
// one rounded add per term, an exact max over k in ascending order and one
// rounded add of the emission, as the plain version does (bit-equal).
//
// Bound on an H100: operations. Each step does q*q adds and as many maxes
// per (r, i): 2.15e9 at the flagship shape (q=15, c=303, R=1056) against
// 20 MB of emissions in and operators out.
//
// Design: one thread per (element, border state), G elements a block of 16 G
// threads (K1's body in max-plus, sum_product.cu), so the q border threads
// of an element share a block. log A is in shared memory, padded with NEG,
// and a step reads it as 64 broadcast 16-byte words, k outer and p inner.
// The emissions of TS steps at a time come from a ring of NB cp.async
// tiles, staged once per element and read as broadcast float4 words by its
// 16 threads; no global load sits in the chain. The tiles start zeroed, so
// states p >= q (never staged) add 0 to a padding entry near NEG, which
// never wins a max. For each j the element's q threads write C_T[r, j, 0..q)
// as consecutive words.
template <int G, int TS, int NB, int UNROLL>
__global__ void __launch_bounds__(G * LANES)
    chunk_summaries_kernel(const float* __restrict__ log_A,
                           const float* __restrict__ log_E_T,
                           float* __restrict__ C_T, int c, int q, int R, int P) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "float4 reads need swz_xor % 4 == 0");
  extern __shared__ __align__(16) float tiles_mem[];  // [NB][TS][G * LANES]
  __shared__ __align__(16) float sA[MAXQ][MAXQ];
  constexpr int ROW = G * LANES, TILE = TS * ROW;
  const int i = threadIdx.x % LANES;  // this thread's left-border state
  const int g = threadIdx.x / LANES;  // its element in the block
  const int mi = blockIdx.y;
  const int rb = blockIdx.x * G;      // first element of the block
  const int r = rb + g;
  const int nr = min(G, R - rb);      // elements of the block below R
  const int xq = swz_xor<G>(g) / 4;   // float4 word w of the element's row is at w ^ xq
  // Staging: thread (sg, sp) copies row sp of element sg.
  const int sg = threadIdx.x % G, sp = threadIdx.x / G;
  const bool mover = sg < nr && sp < q;

  for (int idx = threadIdx.x; idx < NB * TILE; idx += blockDim.x) tiles_mem[idx] = 0.f;
  load_log_A(sA, log_A + (size_t)mi * q * q, q);  // its barrier also orders the zeros

  const size_t plane = (size_t)q * R;  // one step of log_E_T
  const float* e = log_E_T + (size_t)mi * c * plane + (size_t)sp * R + rb + sg;
  const int ntiles = (c + TS - 1) / TS;
  auto stage = [&](int it) {  // copy the steps of tile it, one commit group
    if (mover && it < ntiles) {
      float* dst = tiles_mem + (it % NB) * TILE + swz<G>(sg, sp);
      const int t0 = it * TS, n = min(TS, c - t0);
      for (int tt = 0; tt < n; ++tt)
        __pipeline_memcpy_async(dst + tt * ROW, e + (size_t)(t0 + tt) * plane, 4);
    }
    __pipeline_commit();  // empty past the last tile: the count stays uniform
  };

  const bool first = r % P == 0;  // chunk 0 of its sequence
  float v[MAXQ];
  for (int it = 0; it < NB - 1; ++it) stage(it);
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * TS, n = min(TS, c - t0);
    const float* tile = tiles_mem + (it % NB) * TILE + g * LANES;
    __pipeline_wait_prior(NB - 2);  // this thread's copies of tile it are done
    __syncthreads();  // ... and every thread's; tile it-1 is read
    stage(it + NB - 1);  // into the buffer of tile it-1
    int tt = 0;
    if (it == 0) {
      const float4* e4 = reinterpret_cast<const float4*>(tile);
#pragma unroll
      for (int w = 0; w < LANES / 4; ++w) {
        const float4 ev = e4[w ^ xq];
        const float ej[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = 4 * w + x;
          const float start = first ? (i == j ? 0.f : NEG) : sA[i][j];
          v[j] = j < q ? start + ej[x] : NEG;
        }
      }
      tt = 1;
    }
#pragma unroll UNROLL
    for (; tt < n; ++tt) {
      // log A is read anew each step (a compiler-only memory barrier):
      // hoisted out of the loop, its 256 words would take the registers and
      // spill, as they did in K1 (sum_product.cu).
      asm volatile("" ::: "memory");
      float acc[MAXQ];
#pragma unroll
      for (int k = 0; k < MAXQ; ++k) {
        const float4* a4 = reinterpret_cast<const float4*>(sA[k]);
#pragma unroll
        for (int w = 0; w < LANES / 4; ++w) {
          const float4 a = a4[w];
          const float aw[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int p = 4 * w + x;
            acc[p] = k == 0 ? v[0] + aw[x] : fmaxf(acc[p], v[k] + aw[x]);
          }
        }
      }
      const float4* e4 = reinterpret_cast<const float4*>(tile + tt * ROW);
#pragma unroll
      for (int w = 0; w < LANES / 4; ++w) {
        const float4 ev = e4[w ^ xq];
        v[4 * w] = acc[4 * w] + ev.x;
        v[4 * w + 1] = acc[4 * w + 1] + ev.y;
        v[4 * w + 2] = acc[4 * w + 2] + ev.z;
        v[4 * w + 3] = acc[4 * w + 3] + ev.w;
      }
    }
  }
  if (r < R && i < q) {
    float* out = C_T + ((size_t)mi * R + r) * q * q + i;
#pragma unroll
    for (int j = 0; j < MAXQ; ++j)
      if (j < q) out[(size_t)j * q] = v[j];
  }
}

// K7 — replaces maxplus_deltas (hmm_layer_tpu/ops/pallas_viterbi.py:353,
// q <= 16 body _fwd_kernel :214-236).
//
// One lane group per (model, chunk element r): lane j keeps column j of
// log A (log_A[k, j] over k) in registers and delta_j. delta_0 is the given
// start; every later step broadcasts delta with LANES shuffles, takes the
// exact max over k of ONE rounded add delta_k + log_A[k, j] (four running
// maxima combined at the end: max is exact, so the grouping changes
// nothing) and adds log e_t[j]: the plain version's rounded adds, bit-equal
// to it. Lanes j >= q carry NEG and their log A column is NEG, so the terms
// of k >= q are NEG + NEG and never win. No branch surrounds a shuffle, and
// a group past R stays in the loop with its loads and stores masked (a
// full-mask shuffle needs the whole warp).
//
// Bound on an H100: bytes — emissions in and deltas out, 38 MB at the
// flagship shape (q=15, c=303, R=1056), against 0.14 G operations. What
// holds it above the bound is the latency of each group's chain of c
// dependent steps. Design, as the sum-product K2 (sum_product.cu): a step
// is LANES lanes wide instead of one thread's q*q terms; the emissions of
// DELTA_TS steps at a time come from a ring of DELTA_NB cp.async tiles, so
// no global load sits in the chain; the deltas go back through the
// emission tile and each row (t, p) of the block's DELTA_G elements is read
// and written as whole sectors.
template <int G, int TS, int NB, int UNROLL>
__global__ void __launch_bounds__(G * LANES)
    deltas_kernel(const float* __restrict__ log_A,
                  const float* __restrict__ log_E_T,
                  const float* __restrict__ delta0,
                  float* __restrict__ deltas, int c, int q, int R) {
  extern __shared__ __align__(16) float tiles_mem[];  // [NB][TS][G * LANES]
  constexpr int ROW = G * LANES, TILE = TS * ROW;
  const int j = threadIdx.x % LANES;  // this lane's state
  const int g = threadIdx.x / LANES;  // this group's element in the block
  const int mi = blockIdx.y;
  const int rb = blockIdx.x * G;      // first element of the block
  const int r = rb + g;
  const bool real = r < R && j < q;   // other lanes carry NEG, never read the tile
  const int nr = min(G, R - rb);      // elements of the block below R
  // Staging and flush: thread (sg, sp) moves row sp of element sg.
  const int sg = threadIdx.x % G, sp = threadIdx.x / G;
  const bool mover = sg < nr && sp < q;

  const float* Am = log_A + (size_t)mi * q * q;
  float acol[LANES];
#pragma unroll
  for (int k = 0; k < LANES; ++k) acol[k] = (k < q && j < q) ? Am[k * q + j] : NEG;

  const size_t plane = (size_t)q * R;  // one step of log_E_T or deltas
  const size_t at = (size_t)mi * c * plane + (size_t)sp * R + rb + sg;
  const float* e = log_E_T + at;
  float* o = deltas + at;

  const int ntiles = (c + TS - 1) / TS;
  auto stage = [&](int i) {  // copy the steps of tile i, one commit group
    if (mover && i < ntiles) {
      float* dst = tiles_mem + (i % NB) * TILE + swz<G>(sg, sp);
      const int t0 = i * TS, n = min(TS, c - t0);
      for (int tt = 0; tt < n; ++tt)
        __pipeline_memcpy_async(dst + tt * ROW, e + (size_t)(t0 + tt) * plane, 4);
    }
    __pipeline_commit();  // empty past the last tile: the count stays uniform
  };

  float d = real ? delta0[((size_t)mi * q + j) * R + r] : NEG;
  for (int i = 0; i < NB - 1; ++i) stage(i);
  for (int i = 0; i < ntiles; ++i) {
    const int t0 = i * TS, n = min(TS, c - t0);
    float* tile = tiles_mem + (i % NB) * TILE;
    __pipeline_wait_prior(NB - 2);  // this thread's copies of tile i are done
    __syncthreads();  // ... and every thread's; tile i-1 is flushed
    stage(i + NB - 1);  // into the buffer of tile i-1
    int tt = 0;
    if (i == 0) {  // first position: delta0 itself
      tile[swz<G>(g, j)] = d;
      tt = 1;
    }
#pragma unroll UNROLL
    for (; tt < n; ++tt) {
      float* slot = tile + tt * ROW + swz<G>(g, j);
      const float ej = real ? *slot : 0.f;
      float m4[4];
#pragma unroll
      for (int k = 0; k < LANES; ++k) {
        const float term = __shfl_sync(FULL, d, k, LANES) + acol[k];
        m4[k % 4] = k < 4 ? term : fmaxf(m4[k % 4], term);
      }
      const float best = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
      d = real ? best + ej : NEG;
      *slot = d;
    }
    __syncthreads();  // the deltas of tile i are in place
    if (mover) {
      const float* src = tile + swz<G>(sg, sp);
      for (int k = 0; k < n; ++k) o[(size_t)(t0 + k) * plane] = src[k * ROW];
    }
  }
}

// K8 — replaces maxplus_backtrace (hmm_layer_tpu/ops/pallas_viterbi.py:433,
// q <= 16 body _backtrace_kernel :239-266).
//
// Walks t = c-1 ... 0 from the given last state: s_t = the LOWEST k
// maximising deltas[t, k] + log_A[k, s_{t+1}] (as jnp.argmax and
// torch.argmax break ties). No backpointers: each decision is re-derived
// from the stored deltas. A state outside [0, q) selects an all-NEG column,
// as the Pallas select tree does.
//
// Bound on an H100: bytes — deltas in and int32 states out, 21 MB at the
// flagship shape (q=15, c=303, R=1056). What holds it above the bound is
// the chain of c dependent decisions per element.
//
// Design: K7's lane group walked backwards, as K3 walks K2's (one 16-lane
// group per element, lane k = state k, G elements a block). A step forms
// w = delta_t[k] + log_A[k, s] in every lane (the plain version's rounded
// add), maps w + 0 (so that -0 and +0 tie, as they compare) to an integer
// key that orders as the floats do, takes the group maximum and then the
// lowest lane holding it with a ballot: s is uniform in the group. Lanes
// k >= q and groups past R carry the key INT_MIN and stay in every shuffle
// and ballot, their stores masked. The deltas of TS steps at a time come
// from a ring of NB cp.async tiles walked from the chunk's end (step c-1 is
// never read, so never staged); the states go back through the tiles (lane
// 0's slot of each step) and each row (t, G elements) is flushed as
// consecutive words. log_A[k, s] is read from log A transposed in shared
// memory (row s is 16 consecutive words). On an H100 a copy of row k in
// registers, read through a select tree on the bits of s, was as fast (it
// needs 64 registers against 48), and one __reduce_max_sync over the
// half-warp for the four shuffle rounds was 1.3x slower
// (hmm_layer_torch/tune_scans.py); neither was kept.
template <int G, int TS, int NB, int UNROLL>
__global__ void __launch_bounds__(G * LANES)
    backtrace_kernel(const float* __restrict__ log_A,
                     const float* __restrict__ deltas,
                     const int* __restrict__ last_state,
                     int* __restrict__ states, int c, int q, int R) {
  extern __shared__ __align__(16) float tiles_mem[];  // [NB][TS][G * LANES]
  __shared__ float sAT[MAXQ + 1][MAXQ];  // sAT[s][k] = log_A[k, s]; rows s >= q all NEG
  constexpr int ROW = G * LANES, TILE = TS * ROW;
  const int k = threadIdx.x % LANES;  // this lane's state
  const int g = threadIdx.x / LANES;  // this group's element in the block
  const int mi = blockIdx.y;
  const int rb = blockIdx.x * G;      // first element of the block
  const int r = rb + g;
  const bool real = r < R && k < q;   // other lanes carry the key INT_MIN
  const int nr = min(G, R - rb);      // elements of the block below R
  const int base = threadIdx.x & LANES;  // the group's first lane in its warp: 0 or 16
  const unsigned own = 0xffffu << base;  // the group's lanes in a ballot
  // Staging and flush: thread (sg, sp) moves row sp of element sg.
  const int sg = threadIdx.x % G, sp = threadIdx.x / G;
  const bool mover = sg < nr && sp < q;

  const float* Am = log_A + (size_t)mi * q * q;
  for (int idx = threadIdx.x; idx < (MAXQ + 1) * MAXQ; idx += blockDim.x) {
    const int s = idx / MAXQ, kk = idx % MAXQ;
    sAT[s][kk] = (s < q && kk < q) ? Am[kk * q + s] : NEG;
  }

  const size_t plane = (size_t)q * R;  // one step of deltas
  const float* d = deltas + (size_t)mi * c * plane + (size_t)sp * R + rb + sg;
  int* out = states + (size_t)mi * c * R + rb + sg;

  // Tile i holds steps lo_of(i) ... c-1 - i*TS, walked downwards.
  const int ntiles = (c + TS - 1) / TS;
  auto lo_of = [&](int i) { return max(0, c - (i + 1) * TS); };
  auto stage = [&](int i) {  // copy the steps of tile i below c-1, one commit group
    if (mover && i < ntiles) {
      float* dst = tiles_mem + (i % NB) * TILE + swz<G>(sg, sp);
      const int lo = lo_of(i), hi = min(c - 1, c - i * TS);
      for (int t = lo; t < hi; ++t)
        __pipeline_memcpy_async(dst + (t - lo) * ROW, d + (size_t)t * plane, 4);
    }
    __pipeline_commit();  // one group per tile, empty or not: the count stays uniform
  };

  int s = r < R ? last_state[(size_t)mi * R + r] : 0;
  int row = (unsigned)s < (unsigned)q ? s : MAXQ;  // log A column of s; MAXQ: all NEG
  for (int i = 0; i < NB - 1; ++i) stage(i);
  for (int i = 0; i < ntiles; ++i) {
    const int lo = lo_of(i), n = c - i * TS - lo;
    float* tile = tiles_mem + (i % NB) * TILE;
    __pipeline_wait_prior(NB - 2);  // this thread's copies of tile i are done
    __syncthreads();  // ... and every thread's; tile i-1 is flushed (and sAT is in place)
    stage(i + NB - 1);  // into the buffer of tile i-1
    int tt = n - 1;
    if (i == 0) {  // last position: the given last state itself
      if (k == 0) tile[tt * ROW + swz<G>(g, 0)] = __int_as_float(s);
      --tt;
    }
#pragma unroll UNROLL
    for (; tt >= 0; --tt) {
      float* slot = tile + tt * ROW + swz<G>(g, k);
      const float w = *slot + sAT[row][k];
      const int bits = __float_as_int(w + 0.f);
      const int key = real ? bits ^ ((bits >> 31) & 0x7fffffff) : INT_MIN;  // float order as int order
      int best = key;
#pragma unroll
      for (int sh = LANES / 2; sh > 0; sh /= 2) best = max(best, __shfl_xor_sync(FULL, best, sh, LANES));
      s = __ffs(__ballot_sync(FULL, key == best) & own) - 1 - base;
      row = s;
      if (k == 0) *slot = __int_as_float(s);
    }
    __syncthreads();  // the states of tile i are in place
    if (sg < nr) {
      const float* src = tile + swz<G>(sg, 0);
      for (int t = sp; t < n; t += LANES) out[(size_t)(lo + t) * R] = __float_as_int(src[t * ROW]);
    }
  }
}

// ---------------------------------------------------------------------------
// Blocked bodies for 16 < q <= 64 (K7b, K8b)
// ---------------------------------------------------------------------------
//
// The sequential decode of 16 < q <= 64 states runs the delta pass and the
// backtrace over whole sequences with the batch on the lanes: R = b (32 at
// the multi-copy flagship), c = L (9,999). One thread per lane (K7, K8)
// would leave 32 threads for 9,999 dependent steps of q * q work each, so
// these bodies take their parallelism from the states instead: ONE WARP PER
// SEQUENCE, lane l owning output states l and l + 32 (NPER = 1 for q <= 32,
// 2 for q <= 64), one warp per block so that the b warps land on b SMs. No
// TPU blocking is carried over (no time blocks of the grid, no 8-sublane
// groups, no lane padding in memory).
//
// Layouts are SEQUENCE-MAJOR, unlike the rest of this file: log E and
// deltas (m, R, c, q), delta0 (m, R, q), states (m, R, c); the wrappers
// transpose from and to their (m, c, q, R) contract around the launch. A
// warp's inputs for TILE steps are then one contiguous run, which it copies
// into shared memory with cp.async while it works through the previous
// tile (double buffering), so the step loop reads only registers and shared
// memory. A global load in every step, even issued several steps ahead of
// its use, kept the chain waiting on memory.
//
// No branch depends on q inside a step: a branch per k keeps the compiler
// from overlapping the shuffles, and each k then costs a shuffle's full
// latency. States past q are padded with NEG instead, as in K6-K8. (Both
// together took K7b from 9.6 ms to 1.9 ms at q = 29, b = 32, L = 9,999 on
// an H100.)

constexpr int MAX_BLOCKED_Q = 64;
constexpr int TILE = 32;  // steps staged in shared memory per copy

// Copies n floats from global src to shared dst with cp.async (one lane
// per 4 bytes), as one commit group.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int lane) {
  for (int i = lane; i < n; i += 32) __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

// K7b — replaces the 16 < q <= 64 body of maxplus_deltas
// (hmm_layer_tpu/ops/pallas_viterbi.py:353, branch :408-429, body
// _fwd_kernel_blocked :279-314).
//
// Lane l holds column l (and l + 32) of log A in registers and delta_{t-1}
// of its states. Each step broadcasts delta_{t-1}[k] with __shfl_sync and
// takes, per owned state p, the exact max over k of ONE rounded add
// delta[k] + log_A[k, p] (four independent running maxima, combined at the
// end: max is exact, so the grouping changes nothing), then one rounded add
// of log e_t[p]: bit-equal to maxplus_deltas_plain. The terms of k >= q
// are NEG + NEG (delta and log A padded) and never win against a real
// term.
//
// Bound on an H100: bytes (log E in, deltas out: 74 MB at q = 29, b = 32,
// L = 9,999) against 0.5 G operations. What holds it far above that bound
// is the chain of c dependent steps per warp (32 * NPER shuffles and twice
// as many adds and maxes each) on only b warps.
template <int NPER>
__global__ void __launch_bounds__(32)
    deltas_blocked_kernel(const float* __restrict__ log_A,
                          const float* __restrict__ log_E,
                          const float* __restrict__ delta0,
                          float* __restrict__ deltas, int c, int q, int R) {
  constexpr int K = 32 * NPER;
  __shared__ __align__(16) float sE[2][TILE * MAX_BLOCKED_Q];
  const int lane = threadIdx.x;
  const int mi = blockIdx.y;
  const int r = blockIdx.x;

  const float* A = log_A + (size_t)mi * q * q;
  float acol[NPER][K];
#pragma unroll
  for (int u = 0; u < NPER; ++u) {
    const int p = lane + 32 * u;
#pragma unroll
    for (int k = 0; k < K; ++k)
      acol[u][k] = (k < q && p < q) ? A[k * q + p] : NEG;
  }

  const size_t seq = (size_t)mi * R + r;
  const float* e = log_E + seq * c * q;  // e[t * q + p]
  float* out = deltas + seq * c * q;

  float v[NPER];
#pragma unroll
  for (int u = 0; u < NPER; ++u) {
    const int p = lane + 32 * u;
    v[u] = p < q ? delta0[seq * q + p] : NEG;
    if (p < q) out[p] = v[u];
  }

  // Tile i holds steps 1 + i * TILE ... (fewer in the last tile).
  const int tiles = (c - 1 + TILE - 1) / TILE;
  auto steps_of = [&](int i) { return min(TILE, c - 1 - i * TILE); };
  if (tiles > 0) stage(sE[0], e + (size_t)q, steps_of(0) * q, lane);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles)
      stage(sE[(i + 1) % 2], e + (size_t)(1 + (i + 1) * TILE) * q, steps_of(i + 1) * q, lane);
    else
      __pipeline_commit();  // an empty group keeps the count below uniform
    __pipeline_wait_prior(1);  // tile i has landed (this lane's copies)
    __syncwarp();              // ... and every other lane's
    const float* et = sE[i % 2];
    const int n = steps_of(i);
    for (int tt = 0; tt < n; ++tt, et += q) {
      float acc[NPER][4];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dk = __shfl_sync(FULL, v[k / 32], k % 32);
#pragma unroll
        for (int u = 0; u < NPER; ++u) {
          const float term = dk + acol[u][k];
          acc[u][k % 4] = k < 4 ? term : fmaxf(acc[u][k % 4], term);
        }
      }
      const size_t t = 1 + (size_t)i * TILE + tt;
#pragma unroll
      for (int u = 0; u < NPER; ++u) {
        const int p = lane + 32 * u;
        if (p < q) {
          v[u] = fmaxf(fmaxf(acc[u][0], acc[u][1]), fmaxf(acc[u][2], acc[u][3])) + et[p];
          out[t * q + p] = v[u];
        }
      }
    }
    __syncwarp();  // tile i's buffer is read before it is staged again
  }
}

// K8b — replaces the 16 < q <= 64 body of maxplus_backtrace
// (hmm_layer_tpu/ops/pallas_viterbi.py:433, branch :475-500, body
// _backtrace_kernel_blocked :317-349).
//
// One warp per sequence walks t = c-2 ... 0 from the given last state.
// Lane l scores its states k = l, l + 32 as w = deltas[t, k] +
// log_A[k, s_{t+1}] (log A TRANSPOSED in shared memory, so a warp reads one
// row of consecutive words). The argmax is taken on integer keys that
// order as the floats do (w + 0 first, so -0 and +0 tie as they compare):
// one __reduce_max_sync gives the best key, and a ballot per owned-state
// slot (states 0-31 first, then 32-63) the LOWEST state holding it, as
// jnp.argmax, torch.argmax and the Pallas kernel's
// min(where(w >= vmax, idx, qp)) take it. Lanes past q take no part in the
// ballots. A state outside [0, q) selects an all-NEG column, as K8 does.
// The deltas are staged in shared memory TILE steps at a time, walking
// back.
//
// Bound on an H100: bytes (deltas in, states out: 38 MB at q = 29, b = 32,
// L = 9,999). The walk is a chain of c dependent steps (a shared-memory
// read, an add, the reduction and a ballot each) on b warps.
template <int NPER>
__global__ void __launch_bounds__(32)
    backtrace_blocked_kernel(const float* __restrict__ log_A,
                             const float* __restrict__ deltas,
                             const int* __restrict__ last_state,
                             int* __restrict__ states, int c, int q, int R) {
  __shared__ float sAT[MAX_BLOCKED_Q * MAX_BLOCKED_Q];  // sAT[s * q + k] = log_A[k, s]
  __shared__ __align__(16) float sD[2][TILE * MAX_BLOCKED_Q];
  const int lane = threadIdx.x;
  const int mi = blockIdx.y;
  const int r = blockIdx.x;
  const float* A = log_A + (size_t)mi * q * q;
  for (int idx = lane; idx < q * q; idx += 32) {
    const int k = idx / q, s = idx % q;
    sAT[s * q + k] = A[idx];
  }
  __syncwarp();

  const size_t seq = (size_t)mi * R + r;
  const float* d = deltas + seq * c * q;  // d[t * q + p]
  int* out = states + seq * c;
  int s = last_state[seq];
  if (lane == 0) out[c - 1] = s;

  // Tile i holds steps lo(i) ... c - 2 - i * TILE, walked downwards.
  const int tiles = (c - 1 + TILE - 1) / TILE;
  auto lo_of = [&](int i) { return max(0, c - 1 - (i + 1) * TILE); };
  auto steps_of = [&](int i) { return c - 1 - i * TILE - lo_of(i); };
  if (tiles > 0) stage(sD[0], d + (size_t)lo_of(0) * q, steps_of(0) * q, lane);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles)
      stage(sD[(i + 1) % 2], d + (size_t)lo_of(i + 1) * q, steps_of(i + 1) * q, lane);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    const int lo = lo_of(i);
    for (int t = lo + steps_of(i) - 1; t >= lo; --t) {
      const float* dt = sD[i % 2] + (t - lo) * q;
      const bool valid = (unsigned)s < (unsigned)q;
      int key[NPER];
      int best = INT_MIN;
#pragma unroll
      for (int u = 0; u < NPER; ++u) {
        const int p = lane + 32 * u;
        key[u] = INT_MIN;
        if (p < q) {
          const float w = dt[p] + (valid ? sAT[s * q + p] : NEG) + 0.f;
          const int bits = __float_as_int(w);
          key[u] = bits ^ ((bits >> 31) & 0x7fffffff);  // float order as int order
          best = max(best, key[u]);
        }
      }
      best = __reduce_max_sync(FULL, best);
#pragma unroll
      for (int u = 0; u < NPER; ++u) {
        const unsigned hit = __ballot_sync(FULL, lane + 32 * u < q && key[u] == best);
        if (hit) {  // the same in every lane
          s = 32 * u + __ffs(hit) - 1;
          break;
        }
      }
      if (lane == 0) out[t] = s;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

int hmm_maxplus_chunk_summaries(const float* log_A, const float* log_E_T,
                                float* C_T, int m, int c, int q, int R, int P,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int G = MPS_G, TS = MPS_TS, NB = MPS_NB;
  constexpr int smem = NB * TS * G * LANES * (int)sizeof(float);
  constexpr int static_smem = MAXQ * MAXQ * (int)sizeof(float);  // its copy of log A
  auto kernel = chunk_summaries_kernel<G, TS, NB, MPS_UNROLL>;
  if ((err = allow_smem(kernel, smem, static_smem)) != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((R + G - 1) / G), (unsigned)m);
  kernel<<<grid, G * LANES, smem, (cudaStream_t)stream>>>(log_A, log_E_T, C_T, c, q, R, P);
  return (int)cudaGetLastError();
}

int hmm_maxplus_deltas(const float* log_A, const float* log_E_T,
                       const float* delta0, float* deltas, int m, int c, int q,
                       int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int G = DELTA_G, TS = DELTA_TS, NB = DELTA_NB;
  constexpr int smem = NB * TS * G * LANES * (int)sizeof(float);
  auto kernel = deltas_kernel<G, TS, NB, DELTA_UNROLL>;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((R + G - 1) / G), (unsigned)m);
  kernel<<<grid, G * LANES, smem, (cudaStream_t)stream>>>(log_A, log_E_T, delta0, deltas, c, q, R);
  return (int)cudaGetLastError();
}

int hmm_maxplus_backtrace(const float* log_A, const float* deltas,
                          const int* last_state, int* states, int m, int c,
                          int q, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int G = TRACE_G, TS = TRACE_TS, NB = TRACE_NB;
  constexpr int smem = NB * TS * G * LANES * (int)sizeof(float);
  constexpr int static_smem = (MAXQ + 1) * MAXQ * (int)sizeof(float);  // log A transposed
  auto kernel = backtrace_kernel<G, TS, NB, TRACE_UNROLL>;
  if ((err = allow_smem(kernel, smem, static_smem)) != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((R + G - 1) / G), (unsigned)m);
  kernel<<<grid, G * LANES, smem, (cudaStream_t)stream>>>(log_A, deltas, last_state, states, c, q, R);
  return (int)cudaGetLastError();
}

// The blocked entry points take 16 < q <= 64 (the wrapper checks it) and
// the sequence-major layouts above.
int hmm_maxplus_deltas_blocked(const float* log_A, const float* log_E,
                               const float* delta0, float* deltas, int m,
                               int c, int q, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= MAXQ || q > MAX_BLOCKED_Q) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)R, (unsigned)m);
  if (q <= 32)
    deltas_blocked_kernel<1><<<grid, 32, 0, (cudaStream_t)stream>>>(
        log_A, log_E, delta0, deltas, c, q, R);
  else
    deltas_blocked_kernel<2><<<grid, 32, 0, (cudaStream_t)stream>>>(
        log_A, log_E, delta0, deltas, c, q, R);
  return (int)cudaGetLastError();
}

int hmm_maxplus_backtrace_blocked(const float* log_A, const float* deltas,
                                  const int* last_state, int* states, int m,
                                  int c, int q, int R, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= MAXQ || q > MAX_BLOCKED_Q) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)R, (unsigned)m);
  if (q <= 32)
    backtrace_blocked_kernel<1><<<grid, 32, 0, (cudaStream_t)stream>>>(
        log_A, deltas, last_state, states, c, q, R);
  else
    backtrace_blocked_kernel<2><<<grid, 32, 0, (cudaStream_t)stream>>>(
        log_A, deltas, last_state, states, c, q, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
