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
#include <mutex>

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
// would leave 32 threads for 9,999 dependent steps of q * q work each. No
// TPU blocking is carried over (no time blocks of the grid, no 8-sublane
// groups, no lane padding in memory).
//
// Layouts are SEQUENCE-MAJOR, unlike the rest of this file: log E and
// deltas (m, R, c, q), delta0 (m, R, q), states (m, R, c), the layout of
// the emissions (m, b, L, q) themselves. A sequence's inputs for TS steps
// are then one contiguous run.
//
// Both bodies are templated on QP, q rounded up to a multiple of 8 (24 ...
// 64), and sum only those terms: the terms of k in [q, QP) are NEG + NEG
// (delta and log A padded) and never win against a real term, which is at
// least -37 per step (log EPS).

constexpr int MAX_BLOCKED_Q = 64;

// Tilings of K7b (DBLK_) and K8b (TBLK_); tune_scans.py sweeps them with -D.
// K7b: S adjacent lanes share a state's terms (a block of QP * S threads,
// rounded up to whole warps), TS steps of emissions a staged tile. S = 2
// was the fastest of 1, 2 and 4 on an H100 at q = 29 and q = 57.
// K8b: T steps a backpointer tile, G groups of q + 1 threads a tiles block.
#ifndef DBLK_S
#define DBLK_S 2
#endif
#ifndef DBLK_TS
#define DBLK_TS 64
#endif
#ifndef TBLK_T
#define TBLK_T 128
#endif
#ifndef TBLK_G
#define TBLK_G 4
#endif

// Copies n floats from global src to shared dst with cp.async (one thread
// per 4 bytes; the runs are not 16-byte aligned), as one commit group.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int tid, int threads) {
  for (int i = tid; i < n; i += threads) __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

// A barrier over the block: the warp's own where the block is one warp.
template <int THREADS>
__device__ __forceinline__ void block_sync() {
  if constexpr (THREADS == 32) __syncwarp(); else __syncthreads();
}

template <int QP, int S>
__host__ __device__ constexpr int delta_threads() {
  return (QP * S + 31) / 32 * 32;
}

// K7b — replaces the 16 < q <= 64 body of maxplus_deltas
// (hmm_layer_tpu/ops/pallas_viterbi.py:353, branch :408-429, body
// _fwd_kernel_blocked :279-314).
//
// One block per sequence walks its c - 1 dependent steps. delta_{t-1} lives
// in shared memory, padded to QP with NEG and double-buffered: one lane of
// each state writes its new value, ONE barrier follows, and every thread
// reads delta_{t-1} back as float4 broadcasts (the same address in every
// lane), so a step has no shuffle broadcast. A thread holds its state's
// column of log A (its slice of k) in registers and takes the exact max
// over its k of ONE rounded add delta[k] + log_A[k, p] (four running
// maxima, then xor shuffles across the S lanes of a state: max is exact, so
// the grouping changes nothing), then one rounded add of log e_t[p]:
// bit-equal to maxplus_deltas_plain. The emissions come through a
// double-buffered ring of cp.async tiles of TS steps.
//
// Bound on an H100: bytes (log E in, deltas out: 74 MB at q = 29, b = 32,
// L = 9,999) against 0.6 G operations. What holds it above that bound is
// the chain of c dependent steps on b blocks: a step's floor is the
// shared-memory round trip and the barrier, QP / S adds and maxes, log2 S
// shuffles and the emission's add. A step took about 200-250 cycles at
// q = 29 (clock64 on an H100), most of it dispatching those adds and maxes
// on one scheduler and the latency of the loads, shuffle and barrier. A
// step loads its emission and all of delta_{t-1} before the first add.
template <int QP, int S, int TS>
__global__ void __launch_bounds__(delta_threads<QP, S>())
    deltas_blocked_kernel(const float* __restrict__ log_A,
                          const float* __restrict__ log_E,
                          const float* __restrict__ delta0,
                          float* __restrict__ deltas, int c, int q, int R) {
  constexpr int THREADS = delta_threads<QP, S>();
  constexpr int KS = QP / S;  // terms of a state in one thread
  static_assert(KS % 4 == 0, "a thread's terms are read as float4 words");
  static_assert(TS % 2 == 0, "a tile starts on buffer 0");
  __shared__ __align__(16) float sE[2][TS * QP];
  __shared__ __align__(16) float sd[2][QP];
  const int tid = threadIdx.x;
  const int p = tid / S, k0 = (tid % S) * KS;  // state p (>= QP: padding), terms k0 ...
  const bool writer = tid % S == 0 && p < q;
  const int mi = blockIdx.y;
  const size_t seq = (size_t)mi * R + blockIdx.x;

  const float* A = log_A + (size_t)mi * q * q;
  float acol[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) acol[kk] = (k0 + kk < q && p < q) ? A[(k0 + kk) * q + p] : NEG;

  const float* e = log_E + seq * c * q;  // e[t * q + p]
  float* out = deltas + seq * c * q;
  for (int i = tid; i < 2 * QP; i += THREADS) {
    const int k = i % QP;
    const float v = (i < QP && k < q) ? delta0[seq * q + k] : NEG;
    sd[i / QP][k] = v;
    if (i < q) out[k] = v;
  }
  const int pe = min(p, q - 1);  // an emission inside the tile for every thread

  // Tile i holds steps 1 + i * TS ... (fewer in the last tile).
  const int tiles = (c - 1 + TS - 1) / TS;
  auto steps_of = [&](int i) { return min(TS, c - 1 - i * TS); };
  if (tiles > 0) stage(sE[0], e + (size_t)q, steps_of(0) * q, tid, THREADS);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles)
      stage(sE[(i + 1) % 2], e + (size_t)(1 + (i + 1) * TS) * q, steps_of(i + 1) * q, tid, THREADS);
    else
      __pipeline_commit();  // an empty group keeps the count below uniform
    __pipeline_wait_prior(1);  // tile i has landed (this thread's copies)
    block_sync<THREADS>();     // ... and everyone's
    const float* et = sE[i % 2];
    const int n = steps_of(i);
    // TS is even, so step tt of every tile reads buffer tt & 1: unrolled by
    // two, both buffers' addresses are constants.
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt, et += q) {
      const int cur = tt & 1;
      // The step's emission first (staged since the tile began), then all
      // of delta_{t-1}: every load is in flight before the first add.
      const float ev = et[pe];
      float4 dk[KS / 4];
#pragma unroll
      for (int kq = 0; kq < KS / 4; ++kq) dk[kq] = reinterpret_cast<const float4*>(sd[cur] + k0)[kq];
      float acc[4];
#pragma unroll
      for (int kq = 0; kq < KS / 4; ++kq) {
        const float t0 = dk[kq].x + acol[4 * kq], t1 = dk[kq].y + acol[4 * kq + 1];
        const float t2 = dk[kq].z + acol[4 * kq + 2], t3 = dk[kq].w + acol[4 * kq + 3];
        acc[0] = kq == 0 ? t0 : fmaxf(acc[0], t0);
        acc[1] = kq == 0 ? t1 : fmaxf(acc[1], t1);
        acc[2] = kq == 0 ? t2 : fmaxf(acc[2], t2);
        acc[3] = kq == 0 ? t3 : fmaxf(acc[3], t3);
      }
      float best = fmaxf(fmaxf(acc[0], acc[1]), fmaxf(acc[2], acc[3]));
#pragma unroll
      for (int o = 1; o < S; o <<= 1) best = fmaxf(best, __shfl_xor_sync(FULL, best, o));
      if (writer) {  // states past q keep NEG
        const float v = best + ev;
        sd[cur ^ 1][p] = v;
        out[(1 + (size_t)i * TS + tt) * q + p] = v;
      }
      // delta_t is written; delta_{t-1}'s buffer and the tile's slot are read
      block_sync<THREADS>();
    }
  }
}

// K8b — replaces the 16 < q <= 64 body of maxplus_backtrace
// (hmm_layer_tpu/ops/pallas_viterbi.py:433, branch :475-500, body
// _backtrace_kernel_blocked :317-349).
//
// The path is fixed by the backpointers bp[t][j] = lowest argmax_k
// (delta_t[k] + log_A[k, j]), which do not depend on the path: only the
// lookup s_t = bp[t][s_{t+1}] is sequential, and lookups compose. So the
// backtrace runs in three kernels from one entry point, none of which walks
// more than max(T, c / T) dependent steps (T = 128 at c = 9,999, against
// 9,998 for one warp walking the whole sequence):
//   1. tiles: a block per (sequence, tile of T steps) stages its deltas in
//      shared memory, computes bp for every column j <= q as uint8 (column
//      q stands for a last state outside [0, q) and is scored against an
//      all-NEG column of log A), then walks each column through the tile:
//      F_i[j], the state at the tile's first position reached from j after
//      it;
//   2. borders: a block per sequence walks the c / T tile maps from the
//      last state: the state after every tile;
//   3. fill: a warp per tile walks its bp tile from its border state and
//      writes its T states.
// A thread of pass 1 holds column j of log A in registers and scans k
// upwards with a strict >: the lowest k wins a tie, and -0 ties with +0,
// as torch.argmax takes it; one rounded add per term, as
// maxplus_backtrace_plain. bp and the maps (m * R * (c - 1) * BS and
// m * R * ceil((c - 1) / T) * BS bytes, BS = q + 1 rounded up to 16: 10 MB
// at q = 29, b = 32, L = 9,999) are scratch taken stream-ordered from a
// pool of the entry point's own.
//
// Bound on an H100: bytes (deltas in, states out: 38 MB at q = 29, b = 32,
// L = 9,999); pass 1's 3e8 terms take about 0.04 ms at the instruction rate.
template <int QP, int T>
__global__ void __launch_bounds__(TBLK_G * (MAX_BLOCKED_Q + 1))
    backtrace_blocked_tiles_kernel(const float* __restrict__ log_A,
                                   const float* __restrict__ deltas,
                                   unsigned char* __restrict__ bp,
                                   unsigned char* __restrict__ maps, int c,
                                   int q, int R, int tiles, int bs) {
  __shared__ __align__(16) float sD[T][QP];
  __shared__ __align__(16) unsigned char sB[T * 80];  // bs <= 80
  const int qb = q + 1;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int j = tid % qb, g = tid / qb, groups = threads / qb;  // groups = TBLK_G
  const size_t blk = blockIdx.x;  // seq * tiles + i
  const size_t seq = blk / tiles;
  const int i = (int)(blk % tiles);
  const int mi = (int)(seq / R);
  const int lo = i * T, rows = min(T, c - 1 - lo);

  const float* d = deltas + (seq * c + lo) * q;
  for (int idx = tid; idx < rows * QP; idx += threads) {
    const int t = idx / QP, k = idx % QP;
    sD[t][k] = k < q ? d[t * q + k] : NEG;
  }
  const float* A = log_A + (size_t)mi * q * q;
  float acol[QP];
#pragma unroll
  for (int k = 0; k < QP; ++k) acol[k] = (k < q && j < q) ? A[k * q + j] : NEG;
  __syncthreads();

  for (int t = g; t < rows; t += groups) {
    const float4* d4 = reinterpret_cast<const float4*>(sD[t]);
    float best = 0.f;
    int arg = 0;
#pragma unroll
    for (int kq = 0; kq < QP / 4; ++kq) {
      const float4 dv = d4[kq];
      const float w[4] = {dv.x + acol[4 * kq], dv.y + acol[4 * kq + 1],
                          dv.z + acol[4 * kq + 2], dv.w + acol[4 * kq + 3]};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (kq == 0 && u == 0) {
          best = w[0];
        } else if (w[u] > best) {
          best = w[u];
          arg = 4 * kq + u;
        }
      }
    }
    sB[t * bs + j] = (unsigned char)arg;
  }
  __syncthreads();

  // The tile's map (threads j <= q) and its backpointers out to bp.
  if (tid < qb) {
    int s = tid;
    for (int t = rows - 1; t >= 0; --t) s = sB[t * bs + s];
    maps[blk * bs + tid] = (unsigned char)s;
  }
  uint4* dst = reinterpret_cast<uint4*>(bp + (seq * (c - 1) + lo) * bs);
  const uint4* src = reinterpret_cast<const uint4*>(sB);
  for (int w = tid; w < rows * bs / 16; w += threads) dst[w] = src[w];
}

// K8b pass 2: a block per sequence writes the last state (as given) and
// walks the tile maps from it, staged CHUNK maps at a time: border[i] is
// the column at the position after tile i (q for a last state outside
// [0, q)).
constexpr int CHUNK = 128;
__global__ void __launch_bounds__(128)
    backtrace_blocked_borders_kernel(const int* __restrict__ last_state,
                                     const unsigned char* __restrict__ maps,
                                     unsigned char* __restrict__ border,
                                     int* __restrict__ states, int c, int q,
                                     int tiles, int bs) {
  __shared__ __align__(16) unsigned char sF[CHUNK * 80];
  const size_t seq = blockIdx.x;
  const int s = last_state[seq];
  if (threadIdx.x == 0) states[seq * c + c - 1] = s;
  int col = (unsigned)s < (unsigned)q ? s : q;
  for (int hi = tiles; hi > 0; hi -= CHUNK) {
    const int i0 = max(0, hi - CHUNK);
    const uint4* src = reinterpret_cast<const uint4*>(maps + (seq * tiles + i0) * bs);
    for (int w = threadIdx.x; w < (hi - i0) * bs / 16; w += blockDim.x)
      reinterpret_cast<uint4*>(sF)[w] = src[w];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = hi - 1; i >= i0; --i) {
        border[seq * tiles + i] = (unsigned char)col;
        col = sF[(i - i0) * bs + col];
      }
    }
    __syncthreads();
  }
}

// K8b pass 3: a warp per tile stages the tile's backpointers, lane 0 walks
// them from the tile's border state, and the warp writes the T states.
template <int T>
__global__ void __launch_bounds__(32)
    backtrace_blocked_fill_kernel(const unsigned char* __restrict__ bp,
                                  const unsigned char* __restrict__ border,
                                  int* __restrict__ states, int c, int tiles,
                                  int bs) {
  __shared__ __align__(16) unsigned char sB[T * 80];
  __shared__ int sS[T];
  const int lane = threadIdx.x;
  const size_t blk = blockIdx.x;
  const size_t seq = blk / tiles;
  const int lo = (int)(blk % tiles) * T, rows = min(T, c - 1 - lo);
  const uint4* src = reinterpret_cast<const uint4*>(bp + (seq * (c - 1) + lo) * bs);
  for (int w = lane; w < rows * bs / 16; w += 32) reinterpret_cast<uint4*>(sB)[w] = src[w];
  __syncwarp();
  if (lane == 0) {
    int s = border[blk];
    for (int t = rows - 1; t >= 0; --t) sS[t] = s = sB[t * bs + s];
  }
  __syncwarp();
  int* out = states + seq * c + lo;
  for (int t = lane; t < rows; t += 32) out[t] = sS[t];
}

// Scratch of K8b: a memory pool per device that keeps what it is given back
// (release threshold at the maximum), so that the stream-ordered allocation
// of every later call is served from it.
cudaError_t scratch_pool(int device, cudaMemPool_t* pool) {
  static std::mutex mu;
  static cudaMemPool_t pools[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (!pools[device]) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = device;
    cudaError_t err = cudaMemPoolCreate(&pools[device], &props);
    if (err != cudaSuccess) return err;
    unsigned long long keep = ~0ull;
    err = cudaMemPoolSetAttribute(pools[device], cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) return err;
  }
  *pool = pools[device];
  return cudaSuccess;
}

template <int QP>
cudaError_t launch_deltas_blocked(const float* log_A, const float* log_E,
                                  const float* delta0, float* deltas, int m,
                                  int c, int q, int R, cudaStream_t stream) {
  if constexpr (QP % (4 * DBLK_S) != 0) {
    return cudaErrorInvalidValue;
  } else {
    dim3 grid((unsigned)R, (unsigned)m);
    deltas_blocked_kernel<QP, DBLK_S, DBLK_TS><<<grid, delta_threads<QP, DBLK_S>(), 0, stream>>>(
        log_A, log_E, delta0, deltas, c, q, R);
    return cudaGetLastError();
  }
}

template <int QP>
cudaError_t launch_backtrace_tiles(const float* log_A, const float* deltas,
                                   unsigned char* bp, unsigned char* maps,
                                   int blocks, int c, int q, int R, int tiles,
                                   int bs, cudaStream_t stream) {
  backtrace_blocked_tiles_kernel<QP, TBLK_T><<<blocks, TBLK_G * (q + 1), 0, stream>>>(
      log_A, deltas, bp, maps, c, q, R, tiles, bs);
  return cudaGetLastError();
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
  constexpr int step = 4 * DBLK_S > 8 ? 4 * DBLK_S : 8;  // QP: whole float4 words per thread
  cudaStream_t s = (cudaStream_t)stream;
  switch ((q + step - 1) / step * step) {
    case 24: return (int)launch_deltas_blocked<24>(log_A, log_E, delta0, deltas, m, c, q, R, s);
    case 32: return (int)launch_deltas_blocked<32>(log_A, log_E, delta0, deltas, m, c, q, R, s);
    case 40: return (int)launch_deltas_blocked<40>(log_A, log_E, delta0, deltas, m, c, q, R, s);
    case 48: return (int)launch_deltas_blocked<48>(log_A, log_E, delta0, deltas, m, c, q, R, s);
    case 56: return (int)launch_deltas_blocked<56>(log_A, log_E, delta0, deltas, m, c, q, R, s);
    case 64: return (int)launch_deltas_blocked<64>(log_A, log_E, delta0, deltas, m, c, q, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int hmm_maxplus_backtrace_blocked(const float* log_A, const float* deltas,
                                  const int* last_state, int* states, int m,
                                  int c, int q, int R, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= MAXQ || q > MAX_BLOCKED_Q) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (c - 1 + TBLK_T - 1) / TBLK_T;
  const int bs = (q + 1 + 15) / 16 * 16;  // bytes a row of backpointers or a map
  const size_t seqs = (size_t)m * R;
  const size_t bp_bytes = seqs * (c - 1) * bs, map_bytes = seqs * tiles * bs;
  unsigned char* scratch = nullptr;
  if (tiles > 0) {
    cudaMemPool_t pool;
    if ((err = scratch_pool(device, &pool)) != cudaSuccess) return (int)err;
    err = cudaMallocFromPoolAsync(reinterpret_cast<void**>(&scratch),
                                  bp_bytes + map_bytes + seqs * tiles, pool, s);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned char *bp = scratch, *maps = scratch + bp_bytes, *border = maps + map_bytes;
  if (tiles > 0) {
    const int blocks = (int)(seqs * tiles);
    switch ((q + 7) / 8 * 8) {
      case 24: err = launch_backtrace_tiles<24>(log_A, deltas, bp, maps, blocks, c, q, R, tiles, bs, s); break;
      case 32: err = launch_backtrace_tiles<32>(log_A, deltas, bp, maps, blocks, c, q, R, tiles, bs, s); break;
      case 40: err = launch_backtrace_tiles<40>(log_A, deltas, bp, maps, blocks, c, q, R, tiles, bs, s); break;
      case 48: err = launch_backtrace_tiles<48>(log_A, deltas, bp, maps, blocks, c, q, R, tiles, bs, s); break;
      case 56: err = launch_backtrace_tiles<56>(log_A, deltas, bp, maps, blocks, c, q, R, tiles, bs, s); break;
      default: err = launch_backtrace_tiles<64>(log_A, deltas, bp, maps, blocks, c, q, R, tiles, bs, s); break;
    }
  }
  if (err == cudaSuccess) {
    backtrace_blocked_borders_kernel<<<(unsigned)seqs, 128, 0, s>>>(last_state, maps, border, states, c,
                                                                    q, tiles, bs);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && tiles > 0) {
    backtrace_blocked_fill_kernel<TBLK_T><<<(unsigned)(seqs * tiles), 32, 0, s>>>(bp, border, states, c,
                                                                                  tiles, bs);
    err = cudaGetLastError();
  }
  if (scratch) {
    const cudaError_t freed = cudaFreeAsync(scratch, s);
    if (err == cudaSuccess) err = freed;
  }
  return (int)err;
}

}  // extern "C"
