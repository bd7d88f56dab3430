// The sequential max-plus decode for 64 < q <= 512 states (K7c, K8c), for
// Hopper (sm_90a).
//
// K7c and K8c replace no TPU kernel: the JAX package leaves its q > 64
// sequential decode (hmm_layer_tpu/ops/recursion.py, _viterbi_seq) to
// lax.scan and XLA. Their plain versions are that scan's arithmetic
// (maxplus_deltas_wide_plain and maxplus_backtrace_wide_plain in
// ops/cuda_viterbi.py, which recursion._viterbi_seq runs); as eager
// PyTorch they cost ~5 launches a position and write each step's (b, q, q)
// sum (33 MB at q = 505, b = 32) to device memory.
//
// Layouts (contiguous; R = b sequences; the model axis m leads):
//   log_A   (m, q, q)         float32 log(max(A, EPS))
//   log_E   (m, R, c, q)      float32 log(max(E, EPS)), sequence-major
//   delta0  (m, R, q)         float32 the value at position 0
//   bp      (m, R, c - 1, q)  uint16: bp[t][j] = lowest k maximising
//                             delta_t[k] + log_A[k, j] (the state before j)
//   last    (m, R, q)         float32 delta at the last position
//   states  (m, R, c)         int32 decoded path
//
// Exactness: a step is, per destination j, one rounded float add per term
// delta_{t-1}[k] + log_A[k, j], an exact max and one rounded add of the
// emission, as the plain version: deltas, pointers and paths are bit-equal
// to it. Max is exact, so any split of k gives the same value; partial
// (value, index) pairs are combined by the greater value and, at an equal
// value, the lower index, so -0 ties with +0 as torch.argmax takes them.
// Built without --use_fast_math; there is no product to contract. The
// structural zeros of a sparse grammar are log EPS here, not -inf, so no
// term is skipped: every step does all q * q terms.
//
// Each entry point returns cudaGetLastError() after its launches; the
// Python wrapper raises if it is not cudaSuccess. Launches go to the
// caller's stream and never synchronise; scratch comes from the wrapper.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MIN_WIDE_Q = 65;   // q <= 64 is K7b's and K8b's (max_plus.cu)
constexpr int MAX_WIDE_Q = 512;  // log A on chip in a cluster of 8 (below)
constexpr int MAX_COLS = 128;    // columns of a block, at most
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// Distributed shared memory: the 32-bit shared::cluster address of a local
// shared-memory word in block rank's copy, and an asynchronous store there
// that counts its bytes on that block's mbarrier.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void store_counted(unsigned addr, float2 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
               :: "r"(addr), "f"(v.x), "f"(v.y), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"((unsigned)__cvta_generic_to_shared(bar)) : "memory");
}
// The one arrival of a phase, with the bytes the phase waits for.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
               :: "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(bytes) : "memory");
}
// Until the phase of this parity has completed; what the peers stored in it
// is then visible.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// Tilings: TS steps of emissions a staged tile of K7c, T steps a pointer
// tile of K8c, CH tile maps a staged chunk of K8c's border walk. The
// backtrace's T is also the Python wrapper's _TRACE_TILE (it sizes the
// scratch), which the entry point checks.
constexpr int WIDE_TS = 32;
constexpr int WIDE_T = 32;
constexpr int WIDE_CH = 32;

// K7c's shapes: S slices of KS rows a column pair; a block of 16 warps at
// KS = 32, of 8 at KS = 64 (a thread's 2 x KS rows of log A in registers).
__host__ __device__ constexpr int threads_of(int ks) { return ks == 64 ? 256 : 512; }

// ---------------------------------------------------------------------------
// K7c — the delta pass with backpointers
// ---------------------------------------------------------------------------
//
// Bound on an H100: operations. A step does q * q adds and as many maxima
// per sequence: 32 x 9,998 x 2 x 505^2 = 1.63e11 at the multi-copy
// flagship (q = 505, b = 32, L = 9,999), ~2.4 ms at 67 TFLOP/s, against
// 0.65 GB of emissions in and 0.32 GB of pointers out (~0.3 ms). What holds
// it above that bound is the chain of c - 1 dependent steps: every step
// needs all of delta_{t-1}, and a step at q = 505 is 255 k terms a
// sequence, too much for one SM to finish in a few hundred cycles, so a
// sequence is spread over a cluster of SMs that must exchange delta every
// step; and the instructions a step spends per column besides its terms
// (the max across slices, the exchange, the pointer, the loop), as many
// as the terms' own adds and maxima at 32 rows a thread.
//
// Design: one thread-block cluster per sequence; its n blocks split the q
// destination columns (cols a block). log A stays on chip for the whole
// sequence: in registers, where a thread holds KS rows (its slice of k) of
// two adjacent columns, and a copy in the block's shared memory,
// column-major, for the pointers. S lanes of a warp share a column pair,
// one slice each: 4 slices of 32 rows to q = 128 and 8 of 32 to q = 256
// (64 registers a thread, 16 warps a block), 8 of 64 to q = 512 (128
// registers, 8 warps: a block holds 64 columns x 512 rows, a cluster of 8
// q <= 512). A step:
//   1. waits until the block's own mbarrier of delta_{t-1}'s buffer has
//      counted all of its bytes;
//   2. every thread reads its slice of delta_{t-1} from its own block's
//      shared memory as float4 words (slices padded by 4 words, so a
//      quarter-warp's eight 16-byte reads fall in eight bank groups) and
//      takes the max of its KS terms of each column: one add and one max a
//      term, a running max for each quarter of the slice;
//   3. xor shuffles take the exact max over the S slices;
//   4. lane s < n adds the emission (staged TS steps ahead in a cp.async
//      ring) and stores the column pair of delta_t into block s's buffer
//      through distributed shared memory, an asynchronous store that counts
//      its 8 bytes on block s's mbarrier of that buffer (each phase expects
//      8 * ceil(q / 2)): every block then holds all of delta_t, and nothing
//      in the chain waits on device memory or on a barrier over the
//      cluster;
//   5. off the chain, the pointer: a ballot of the slices whose max is the
//      column's gives the lowest (it holds the lowest k), that slice's lane
//      the lowest of its quarters whose running max is the column's, and
//      the S lanes test that quarter's KS / 4 rows of both columns again
//      from delta_{t-1} and the shared copy of log A, with the same rounded
//      add: the lowest equal one is the lowest argmax. Lane 0 stores the
//      pair.
// delta is triple-buffered: a block that holds all of delta_t knows that
// every warp of every block has finished step t - 1, its pointers included
// (each warp stores its part of delta_t after them), so the buffer of
// delta_{t-2} is free for delta_{t+1}.
// Measured on an H100 at q = 505, b = 32, L = 9,999 (3 waves: 15 clusters
// of 8 blocks fit at once): a first version that tracked the argmax in the
// scan (a compare and two selects a term) and ended each step with a
// cluster barrier took 50.8 ms (clock64: the scan 1,641 cycles of a
// 3,350-cycle step, the barrier's release ~900); the mbarrier's counted
// stores in place of the barrier 36.1 ms; the max-only scan with the
// pointer found off the chain 25.7 ms (a step ~1,760 cycles, of which the
// scan ~390: issue-bound on ~310 instructions a warp); the quarter maxima
// that narrow the pointer's search to 8 rows 24.2 ms; 64 rows a thread in
// 8 warps (fewer instructions a step around the same terms) 23.1 ms.
// Several sequences a cluster in one wave (11 clusters of 3) took no less
// time per sequence step, so the step is not bound by the exchange's
// latency.
// The cluster size follows q (the bytes of log A a block can hold), not a
// knob: n = ceil(q / columns a block), so q = 130 takes two blocks of 72
// columns, q = 505 eight of 64, q <= 128 one.
template <int S, int KS>
__global__ void __launch_bounds__(threads_of(KS), 1)
    deltas_wide_kernel(const float* __restrict__ log_A,
                       const float* __restrict__ log_E,
                       const float* __restrict__ delta0,
                       unsigned short* __restrict__ bp,
                       float* __restrict__ last, int c, int q, int R,
                       int cols) {
  constexpr int TS = WIDE_TS;
  constexpr int SLICE = KS + 4;     // words of a slice in the delta buffer
  constexpr int QR = KS / 4;        // rows of a quarter of a slice
  static_assert(KS % 16 == 0 && 2 * QR <= 32, "a slice is whole float4 quarters; a pair's candidates fit a mask");
  constexpr int QP = S * SLICE;     // words of a delta buffer
  constexpr int AROW = S * KS + 4;  // words of a column of log A in shared memory
  constexpr int NBUF = 3;
  __shared__ __align__(16) float sd[NBUF][QP];
  __shared__ __align__(16) float sE[2][TS * MAX_COLS];
  __shared__ __align__(8) unsigned long long full[NBUF];  // delta buffer b holds all of its step
  extern __shared__ __align__(16) float sA[];             // [cols][AROW]: log A[k, col0 + jl] at jl * AROW + k
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane / S, s = lane % S;            // column pair g of the warp, slice s
  const int jl = (warp * (32 / S) + g) * 2;        // the pair's first column in the block
  const int col0 = rank * cols;
  const int j = col0 + jl;                         // ... and in the model
  const int k0 = s * KS;
  const int width = min(cols, q - col0);           // the block's real columns
  const size_t seq = (size_t)blockIdx.y * R + blockIdx.x / n;

  const float* A = log_A + (size_t)blockIdx.y * q * q;
  float a0[KS], a1[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int k = k0 + kk;
    a0[kk] = (k < q && j < q) ? A[(size_t)k * q + j] : NEG;
    a1[kk] = (k < q && j + 1 < q) ? A[(size_t)k * q + j + 1] : NEG;
    sA[jl * AROW + k] = a0[kk];
    sA[(jl + 1) * AROW + k] = a1[kk];
  }
  if (tid == 0) {
    for (int b = 0; b < NBUF; ++b) mbar_init(&full[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Buffer 0 holds delta_0; padding (k >= q, and the 4 words after each
  // slice) is NEG in every buffer and never written again.
  for (int i = tid; i < NBUF * QP; i += threads) {
    const int p = i % QP, k = (p / SLICE) * KS + p % SLICE;
    sd[i / QP][p] = (i < QP && p % SLICE < KS && k < q) ? delta0[seq * q + k] : NEG;
  }
  // Lane s < n stores to block s: the column pair's word in buffer b at
  // dst + b * QP words, counted on that block's mbarrier bar + b (a block's
  // window of the cluster's shared memory is contiguous).
  const bool storer = s < n && j < q;
  const int jw = j + (j / KS) * (SLICE - KS);  // the pair's word in a buffer
  const unsigned dst = storer ? cluster_addr(&sd[0][jw], s) : 0u;
  const unsigned bar = storer ? cluster_addr(&full[0], s) : 0u;
  const unsigned step_bytes = 8u * (unsigned)((q + 1) / 2);

  // Tile i of emissions holds steps 1 + i * TS ... of the block's columns.
  const float* e = log_E + seq * (size_t)c * q + col0;
  const int tiles = (c - 1 + TS - 1) / TS;
  auto steps_of = [&](int i) { return min(TS, c - 1 - i * TS); };
  auto stage = [&](int i) {
    float* to = sE[i & 1];
    const float* from = e + (size_t)(1 + i * TS) * q;
    const int count = steps_of(i) * width;
    for (int x = tid; x < count; x += threads) {
      const int t = x / width, jj = x % width;
      __pipeline_memcpy_async(to + t * cols + jj, from + (size_t)t * q + jj, 4);
    }
    __pipeline_commit();
  };
  if (tiles > 0) stage(0);
  __pipeline_wait_prior(0);
  __syncthreads();
  // Every block's buffers and mbarriers are set before any peer stores.
  cluster.sync();

  unsigned short* row = bp + seq * (size_t)(c - 1) * q + j;  // step t's pointers at row + (t - 1) * q
  const unsigned group = (S == 32 ? FULL : (1u << S) - 1u) << (g * S);
  const float* ac0 = sA + jl * AROW;
  int cur = 1, prev = 0;  // step t's buffer t % 3, delta_{t-1}'s
  unsigned phase = 0;     // bit b: the parity of buffer b's next phase
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) stage(i + 1);
    const int steps = steps_of(i);
    const float* et = sE[i & 1] + jl;
    for (int tt = 0; tt < steps; ++tt, et += cols) {
      const int t = 1 + i * TS + tt;
      // delta_{t-1} is whole (step t - 1 stored it in its buffer's
      // mbarrier's phase); then the arrival of step t's phase.
      if (t > 1) {
        mbar_wait(&full[prev], (phase >> prev) & 1u);
        phase ^= 1u << prev;
      }
      if (tid == 0) mbar_expect(&full[cur], step_bytes);
      const float* dp = sd[prev];
      const float4* d4 = reinterpret_cast<const float4*>(dp + s * SLICE);
      // acc[u]: the max of the slice's quarter u, rows u * QR ... + QR - 1.
      float acc0[4], acc1[4];
#pragma unroll
      for (int h = 0; h < QR / 4; ++h) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kq = u * (QR / 4) + h;
          const float4 dv = d4[kq];
          const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float v0 = d[v] + a0[4 * kq + v], v1 = d[v] + a1[4 * kq + v];
            acc0[u] = h == 0 && v == 0 ? v0 : fmaxf(acc0[u], v0);
            acc1[u] = h == 0 && v == 0 ? v1 : fmaxf(acc1[u], v1);
          }
        }
      }
      const float b0 = fmaxf(fmaxf(acc0[0], acc0[1]), fmaxf(acc0[2], acc0[3]));
      const float b1 = fmaxf(fmaxf(acc1[0], acc1[1]), fmaxf(acc1[2], acc1[3]));
      float m0 = b0, m1 = b1;
#pragma unroll
      for (int o = 1; o < S; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, o));
      }
      if (storer) {
        const float2 ev = *reinterpret_cast<const float2*>(et);
        store_counted(dst + cur * QP * (unsigned)sizeof(float), make_float2(m0 + ev.x, j + 1 < q ? m1 + ev.y : NEG),
                      bar + cur * (unsigned)sizeof(unsigned long long));
      }
      // The pointer: the lowest slice holding the max (a lane), the
      // lowest quarter of it that does (that lane's running maxima), then
      // that quarter's lowest equal row. Candidate x < 2 QR of the S lanes'
      // 2 QR / S rounds is row x % QR of the quarter of column x / QR.
      const int w0 = __ffs(__ballot_sync(FULL, b0 == m0) & group) - 1;
      const int w1 = __ffs(__ballot_sync(FULL, b1 == m1) & group) - 1;
      const int r0 = (w0 - g * S) * KS + QR * __shfl_sync(FULL, acc0[0] == m0 ? 0 : acc0[1] == m0 ? 1 : acc0[2] == m0 ? 2 : 3, w0);
      const int r1 = (w1 - g * S) * KS + QR * __shfl_sync(FULL, acc1[0] == m1 ? 0 : acc1[1] == m1 ? 1 : acc1[2] == m1 ? 2 : 3, w1);
      unsigned hits = 0;  // bit x: candidate x equals its column's max
#pragma unroll
      for (int r = 0; r < 2 * QR / S; ++r) {
        const int x = r * S + s;
        const bool second = x >= QR;
        const int k = (second ? r1 : r0) + x % QR;
        const bool eq = dp[k + (k / KS) * (SLICE - KS)] + ac0[k + (second ? AROW : 0)] == (second ? m1 : m0);
        hits |= ((__ballot_sync(FULL, eq) & group) >> (g * S)) << (r * S);
      }
      if (s == 0 && j < q) {
        row[0] = (unsigned short)(r0 + __ffs(hits & ((1u << QR) - 1u)) - 1);
        if (j + 1 < q) row[1] = (unsigned short)(r1 + __ffs(hits >> QR) - 1);
      }
      row += q;
      prev = cur;
      cur = cur == NBUF - 1 ? 0 : cur + 1;
    }
    // Tile i + 1 has landed (this thread's copies, then everyone's), and no
    // thread reads tile i's slot any more when stage(i + 2) refills it.
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  if (c > 1) mbar_wait(&full[prev], (phase >> prev) & 1u);
  if (rank == 0) {
    const float* fin = sd[prev];
    for (int k = tid; k < q; k += threads) last[seq * q + k] = fin[k + (k / KS) * (SLICE - KS)];
  }
  // No block leaves before every block holds the last delta: its stores
  // into the others have all landed.
  cluster.sync();
}

// ---------------------------------------------------------------------------
// K8c — the pointer walk
// ---------------------------------------------------------------------------
//
// K8b's three passes (max_plus.cu) on K7c's uint16 pointers, taken as
// written and not recomputed. Only the lookup s_t = bp[t][s_{t+1}] is
// sequential, and lookups compose, so no pass walks more than
// max(T, (c - 1) / T) dependent steps (T = 32: 313 at c = 9,999, against
// 9,998 for one thread walking the whole sequence):
//   1. tiles: a block per (sequence, tile of T pointer rows) stages the
//      tile in shared memory and walks every column j through it: the
//      tile's map F[j], the state at the tile's first position reached
//      from state j at the position after it;
//   2. borders: a block per sequence takes the lowest argmax of the last
//      delta (the last state), writes it, and walks the tile maps from it,
//      staged CH maps at a time: the state after every tile;
//   3. fill: a warp per tile walks its pointers from its border state
//      through device memory and writes its T states.
// Bound on an H100: bytes (the pointers read once, the path written:
// 0.33 GB at q = 505, b = 32, L = 9,999, ~0.1 ms); pass 3's reads are
// dependent loads, T of them a tile, all tiles at once.
__global__ void __launch_bounds__(256)
    backtrace_wide_tiles_kernel(const unsigned short* __restrict__ bp,
                                unsigned short* __restrict__ maps, int c,
                                int q, int tiles) {
  __shared__ unsigned short sB[WIDE_T * MAX_WIDE_Q];
  const size_t blk = blockIdx.x;  // seq * tiles + i
  const size_t seq = blk / tiles;
  const int lo = (int)(blk % tiles) * WIDE_T, rows = min(WIDE_T, c - 1 - lo);
  const unsigned short* src = bp + (seq * (c - 1) + lo) * q;
  for (int x = threadIdx.x; x < rows * q; x += blockDim.x) sB[x] = src[x];
  __syncthreads();
  for (int j = threadIdx.x; j < q; j += blockDim.x) {
    int s = j;
    for (int t = rows - 1; t >= 0; --t) s = sB[t * q + s];
    maps[blk * q + j] = (unsigned short)s;
  }
}

__global__ void __launch_bounds__(256)
    backtrace_wide_borders_kernel(const float* __restrict__ last,
                                  const unsigned short* __restrict__ maps,
                                  int* __restrict__ border,
                                  int* __restrict__ states, int c, int q,
                                  int tiles) {
  __shared__ unsigned short sF[WIDE_CH * MAX_WIDE_Q];
  __shared__ float sv[32];
  __shared__ int si[32];
  const size_t seq = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The lowest argmax of the last delta: each thread's states ascending
  // with a strict >, then (value, index) pairs by the greater value, at an
  // equal value the lower index.
  const float* d = last + seq * q;
  float best = -INFINITY;
  int arg = q;
  for (int k = tid; k < q; k += blockDim.x) {
    const float v = d[k];
    if (arg == q || v > best) { best = v; arg = k; }
  }
  auto better = [](float v, int k, float bv, int bk) { return v > bv || (v == bv && k < bk); };
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(FULL, best, o);
    const int k = __shfl_xor_sync(FULL, arg, o);
    if (better(v, k, best, arg)) { best = v; arg = k; }
  }
  if (lane == 0) { sv[warp] = best; si[warp] = arg; }
  __syncthreads();
  int s = 0;
  if (tid == 0) {
    best = sv[0];
    arg = si[0];
    for (int w = 1; w < (int)(blockDim.x + 31) / 32; ++w)
      if (better(sv[w], si[w], best, arg)) { best = sv[w]; arg = si[w]; }
    s = arg;
    states[seq * c + c - 1] = s;
  }
  for (int hi = tiles; hi > 0; hi -= WIDE_CH) {
    const int i0 = max(0, hi - WIDE_CH);
    const unsigned short* src = maps + (seq * tiles + i0) * q;
    for (int x = tid; x < (hi - i0) * q; x += blockDim.x) sF[x] = src[x];
    __syncthreads();
    if (tid == 0) {
      for (int i = hi - 1; i >= i0; --i) {
        border[seq * tiles + i] = s;
        s = sF[(i - i0) * q + s];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(32)
    backtrace_wide_fill_kernel(const unsigned short* __restrict__ bp,
                               const int* __restrict__ border,
                               int* __restrict__ states, int c, int q,
                               int tiles) {
  __shared__ int sS[WIDE_T];
  const int lane = threadIdx.x;
  const size_t blk = blockIdx.x;
  const size_t seq = blk / tiles;
  const int lo = (int)(blk % tiles) * WIDE_T, rows = min(WIDE_T, c - 1 - lo);
  if (lane == 0) {
    const unsigned short* b = bp + (seq * (c - 1) + lo) * q;
    int s = border[blk];
    for (int t = rows - 1; t >= 0; --t) sS[t] = s = b[(size_t)t * q + s];
  }
  __syncwarp();
  int* out = states + seq * c + lo;
  for (int t = lane; t < rows; t += 32) out[t] = sS[t];
}


}  // namespace

extern "C" {

// K7c. 64 < q <= 512; the wrapper checks the shapes.
int hmm_maxplus_deltas_wide(const float* log_A, const float* log_E,
                            const float* delta0, unsigned short* bp,
                            float* last, int m, int c, int q, int R,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q < MIN_WIDE_Q || q > MAX_WIDE_Q || m < 1 || R < 1 || c < 1) return (int)cudaErrorInvalidValue;
  // (S, KS): 4 slices of 32 rows to q = 128, 8 of 32 to 256, 8 of 64 to 512.
  const int KS = q <= 256 ? 32 : 64, S = q <= 128 ? 4 : 8;
  const int per_warp = 2 * (32 / S);            // columns a warp
  const int per_block = threads_of(KS) / 32 * per_warp;
  const int n = (q + per_block - 1) / per_block;
  const int cols = ((q + n - 1) / n + per_warp - 1) / per_warp * per_warp;
  if (n > MAX_CLUSTER || n > S || cols > MAX_COLS) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * n), (unsigned)m, 1);
  cfg.blockDim = dim3((unsigned)(cols / per_warp * 32), 1, 1);
  cfg.dynamicSmemBytes = (size_t)cols * (S * KS + 4) * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
    return e != cudaSuccess ? e : cudaLaunchKernelEx(&cfg, kernel, log_A, log_E, delta0, bp, last, c, q, R, cols);
  };
  if (S == 4) err = launch(deltas_wide_kernel<4, 32>);
  else if (KS == 32) err = launch(deltas_wide_kernel<8, 32>);
  else err = launch(deltas_wide_kernel<8, 64>);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K8c. maps (m * R * tiles * q uint16) and border (m * R * tiles int32) are
// the wrapper's scratch, tiles = ceil((c - 1) / T).
int hmm_maxplus_backtrace_wide(const unsigned short* bp, const float* last,
                               unsigned short* maps, int* border,
                               int* states, int m, int c, int q, int R,
                               int tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q < MIN_WIDE_Q || q > MAX_WIDE_Q || m < 1 || R < 1 || c < 1) return (int)cudaErrorInvalidValue;
  if (tiles != (c - 1 + WIDE_T - 1) / WIDE_T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t seqs = (size_t)m * R;
  if (tiles > 0) {
    backtrace_wide_tiles_kernel<<<(unsigned)(seqs * tiles), 256, 0, s>>>(bp, maps, c, q, tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  backtrace_wide_borders_kernel<<<(unsigned)seqs, 256, 0, s>>>(last, maps, border, states, c, q, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (tiles > 0) {
    backtrace_wide_fill_kernel<<<(unsigned)(seqs * tiles), 32, 0, s>>>(bp, border, states, c, q, tiles);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
