// The sequential sum-product passes for 64 < q <= 704 states (K2c, K3c),
// for Hopper (sm_90a).
//
// K2c and K3c replace no TPU kernel: the JAX package leaves its sequential
// forward and backward passes (hmm_layer_tpu/ops/recursion.py, _forward_seq
// and _backward_seq) to lax.scan and XLA, and has no Pallas kernel above
// q = 16. Their plain versions are that scan's arithmetic
// (sum_forward_wide_plain and sum_backward_wide_plain in
// ops/cuda_forward.py, which recursion._forward_seq and _backward_seq run);
// as eager PyTorch they cost ~10 launches a position, so the log-likelihood
// and its analytic VJP (recursion._LoglikSeq: a forward pass, then a second
// forward pass and a backward pass) issued ~12,000 launches at L = 400
// (a profile MAP step: 16,110 kernels with the loops, 4,112 with K2c/K3c;
// at q = 647, 15,360 and ~4,170).
//
// Layouts (contiguous; b sequences; the model axis m leads; linear space in,
// log space out):
//   init  (m, q)        float32 initial distribution (K2c)
//   A     (m, q, q)     float32 transition matrices
//   E     (m, b, L, q)  float32 emissions
//   out   (m, b, L, q)  float32 log alpha + ll (K2c, when asked) or
//                       log beta (K3c)
//   ll    (m, b)        float32 log-likelihood (K2c)
//
// What a step computes (s is the unnormalised carry, z its scale):
//   K2c: s_t = max(E_t, EPS) * max((s_{t-1} @ A) / z_{t-1}, EPS),
//        z_t = sum(s_t), ll_t = ll_{t-1} + log z_t,
//        out_t = log(s_t / z_t) + ll_t (taken as log s_t + ll_{t-1}),
//        from s_0 = max(E_0, EPS) * max(init, EPS);
//   K3c: s_{t-1} = max((v_t @ A^T) / z_t, EPS) with v_t = max(E_t, EPS) * s_t,
//        z_t = max(s_t), ll as K2c, out_{t-1} = log(s_{t-1} / z_{t-1}) + ll,
//        from s_{L-1} = 1, out_{L-1} = 0.
// This is the plain versions' arithmetic with the division by z moved
// behind the product (alpha @ A = (s @ A) / z), in float32 fused
// multiply-adds, in another order than cuBLAS's: not bit-equal to the plain
// versions, within rounding of them (tests/test_torch_loglik_wide.py).
// Built without --use_fast_math: IEEE division, logf, denormals kept.
//
// Bound on an H100: the chain of L - 1 dependent steps. A pass is
// 2 q^2 operations a position and sequence: 6.2 GFLOP at the profile
// cell's shape (q = 155, m = 5, b = 64, L = 400), ~0.09 ms at 67 TFLOP/s,
// against ~160 MB of E in and log alpha out (~0.05 ms); 107 GFLOP at
// q = 647, ~1.6 ms. Each step needs all of the previous carry, so a step is
// one matrix-vector product of q^2 terms a sequence, a sum over q and a
// division, in a few hundred cycles.
//
// Design: a block (or a cluster of n blocks) holds a group of G = 4
// sequences of one model for the whole pass. A stays on chip: each block
// holds the columns of A it produces (K3c: rows, loaded transposed) for
// every input state, zero-padded to whole 32-column chunks. The cut follows
// q (cut_of):
//   - to q = 512, in shared memory: q <= 160 fits one block (q = 155:
//     97 KB), and above that the columns are split over a cluster of n <= 8
//     blocks (q = 505 and 512: eight blocks of 64);
//   - above 512 (the register cut) a block holds 96 columns, two chunks in
//     shared memory (interleaved: a lane reads its two columns as one
//     8-byte word) and the third in registers: each lane keeps that
//     column's words for its warp's slice of RS = 44 input states (16 warps
//     x 44 = 704, the most this cut holds; rows past q are zeros, so the
//     product runs unguarded), in a cluster of ceil(q / 96) <= 8 blocks
//     (q = 513-576: 6; 577-672: 7, so q = 639 and 647 take seven blocks of
//     92 and 93 columns; 673-704: 8), 230 KB of shared memory a block.
// Every block holds the whole carry of its 4 sequences, one float4 a state.
// A block has a thread for each (column, sequence) pair and 16 warps at
// least (q = 155: 20 warps). A step:
//   1. every warp takes a slice of the input states, each lane a column of
//      every chunk: per state one broadcast float4 of the carry serves
//      4 x chunks FMAs, one word of A each; the slices' partial sums go to
//      shared memory as float4s;
//   2. after one block barrier, each (column, sequence) thread adds the
//      slices in order, takes the previous step's scale z from the partial
//      scales (4 accumulators in a fixed order: every block gets the same
//      bits), writes the previous step's output, divides by z, clamps,
//      multiplies by its emission (loaded a step ahead), and packs its
//      column's 4 sequences into one float4 (shuffles), which goes into
//      every block of the cluster (distributed shared memory); a warp's xor
//      tree reduces its 8 columns to a partial scale (sum or max) for each
//      sequence, one float4 that lane 0 stores beside the carry;
//   3. one cluster barrier (a block barrier when n = 1) ends the step.
// Carry and partial scales are double-buffered: a barrier ends every step,
// so the buffer a step writes was last read a step before. Every block
// holds every partial scale, so normalising needs no second exchange and
// no barrier of its own.
// The register cut changes steps 2 and 3 (the cut to 512 is as above):
// each warp of owners reduces the scale itself (lane l adds the partials
// l / 4 mod 8 of sequence l % 4 in order, then a butterfly: every lane and
// block gets the same bits); a column's 4 lanes gather its float4 and lane
// h stores it into blocks h and h + 4, and lane r < n the warp's partial
// scales into block r, as asynchronous stores that count their bytes on
// that block's mbarrier of the buffer; no cluster barrier: a step begins
// when the block's own mbarrier has counted the whole carry and every
// partial scale of the step before (a block that holds them knows that
// every block has read the buffer they replace), and the output, the
// log-scale and the next emission follow the stores, off the chain. A wait
// that outlasts MAX_POLLS polls traps (mbar_wait): bytes miscounted fail
// the launch instead of hanging the card.
// Measured on an H100 (clock64 and CUDA events; us a step of K2c / K3c at
// q = 155, b = 64, m = 5, L = 400, and at q = 505, b = 32, L = 9,999): a
// first version with a warp a 32-column chunk, 4 warps reducing the scale
// at the head of each step and (sequence, column) owners storing one float
// to each block: 2.40 / 2.48 and 5.13 / 7.93 (4,200 cycles a step at
// q = 155: the scale's loads queued behind the product's in the
// shared-memory pipe, ~1,500 cycles on the chain; at q = 505 the owners'
// 8 remote stores of one word each, twice for K3c's two buffers); every
// chunk a lane: 2.20 / 2.35 and 4.81 / 7.26; the scale from the owners'
// partials, one float4 a column, 8 warps: 2.43 / 2.92 and 3.43 / 3.77
// (too few warps to hide the product's latency at q = 155); this one:
// 2.06 / 2.17 and 3.61 / 3.67. A step at q = 155 does 96 k FMAs a block,
// ~750 cycles at the SM's rate: the barriers, the owners' divisions and
// logs and the latency of a step's chain keep it near 4,000.
// The register cut at q = 647 (ms a pass of K2c with log alpha / K3c at
// m = 5, b = 64, L = 400: 80 groups in 6 waves of the 15 clusters of 7
// that fit at once; us a step of one cluster in brackets): the
// cluster-barrier step above with the product guarded to the slice, 13.25 /
// 13.29 (5.6); unguarded on zero rows, 10.38 / 9.74 (clock64: product
// ~3,300 cycles, owners ~3,500, of it the scale's 84 loads a thread ~1,000
// in the shared-memory pipe, barrier ~1,300); the warps' butterfly scale
// and the barrier split around the output, 8.53 / 9.20 (3.6); the
// mbarriers' counted stores in place of the barrier, 7.36 / 7.62 (3.1:
// the stores, 14 instructions a warp to 7 blocks, ~1,350 cycles); this
// one, 6.73 / 6.88 (2.9: product ~3,250 cycles, owners ~1,250, the wait
// ~500; with the bounded wait, chip_smoke.py phase 12: 6.79 / 6.92). The
// product is bound by issue: 12 FMAs a state and lane on 704 padded rows,
// 2,112 cycles of FMAs a step.
//
// Each entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not cudaSuccess. Launches go to the caller's
// stream and never synchronise; outputs come from the wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr float EPS = 1e-16f;        // the plain versions' clamp (ops/semiring.py)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MIN_WIDE_Q = 65;       // q <= 64 keeps the eager loop
constexpr int MAX_WIDE_Q = 704;      // the register cut's RS x 16 warps (below)
constexpr int G = 4;                 // sequences a block: one float4 a state
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int A_BYTES = 128 * 1024;  // bytes of A a block holds in shared memory, at most (q <= 512)
constexpr int MAX_CC = 5;            // 32-column chunks a block, at most (q <= 160 in one block)
constexpr int RS = 44;               // the register cut: states of a warp's slice, at most

// Warps a block of cc 32-column chunks: one thread a (column, sequence)
// pair, and 16 warps at least (the product's slices of the input states).
__host__ __device__ constexpr int warps_of(int cc) { return G * cc > 16 ? G * cc : 16; }
static_assert(warps_of(3) * RS >= MAX_WIDE_Q, "the register cut's slices cover every state");
// The register cut's stores (publish): lane h of a column stores its carry
// into blocks h and h + 4, lane r < n the partial scales into block r.
static_assert(MAX_CLUSTER <= 2 * G, "two carry stores a lane cover the cluster");

// Distributed shared memory for the register cut: the 32-bit
// shared::cluster address of a local shared-memory word in block rank's
// copy, an asynchronous store there that counts its bytes on that block's
// mbarrier, and the mbarrier's arrival and wait.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void store_counted(unsigned addr, float4 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
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
// is then visible. A phase that has not completed after MAX_POLLS polls
// (seconds; a step waits a few) was armed for bytes that never come: the
// kernel traps, and the launch fails where it would have hung the card.
constexpr unsigned MAX_POLLS = 1u << 26;
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == MAX_POLLS) __trap();
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// How a block's work is cut for q states: n blocks a cluster, each with
// cols output columns in cc chunks of 32, the last rc of them in registers.
struct Cut {
  int n, cols, cc, rc;
};

Cut cut_of(int q) {
  const int cc_max = min(MAX_CC, A_BYTES / (q * 32 * (int)sizeof(float)));
  const int n = (q + 32 * cc_max - 1) / (32 * cc_max);
  if (n <= MAX_CLUSTER) {
    const int cols = (q + n - 1) / n;
    return {n, cols, (cols + 31) / 32, 0};
  }
  // Above q = 512 A's columns outgrow 8 blocks' shared memory: 96 columns
  // a block, two chunks in shared memory and the third in registers.
  const int nr = (q + 95) / 96;
  return {nr, (q + nr - 1) / nr, 3, 1};
}

size_t smem_bytes(int q, const Cut& c) {
  const size_t ld = 32 * (size_t)c.cc, lda = 32 * (size_t)(c.cc - c.rc);
  const size_t rows = c.rc > 0 ? (size_t)warps_of(c.cc) * RS : q;  // A's rows and the carry's (below)
  return sizeof(float) * (rows * lda) + sizeof(float4) * (2 * rows + warps_of(c.cc) * ld + 2 * (size_t)c.n * G * c.cc) +
         (c.rc > 0 ? 2 * sizeof(unsigned long long) : 0);
}

// One pass: K2c (BWD = false) or K3c (BWD = true) with CC chunks of 32
// columns a block in shared memory and RC more in registers. Grid: x = n *
// the groups of G sequences, y = m; a cluster of n along x.
template <bool BWD, int CC, int RC>
__global__ void __launch_bounds__(32 * warps_of(CC + RC), 1)
    sum_wide_kernel(const float* __restrict__ init, const float* __restrict__ A,
                    const float* __restrict__ E, float* __restrict__ out,
                    float* __restrict__ ll_out, int b, int L, int q, int n,
                    int cols) {
  constexpr int LD = 32 * (CC + RC), LDA = 32 * CC;  // the block's columns; A's row in shared memory
  constexpr int S = warps_of(CC + RC), THREADS = 32 * S;
  constexpr int NZB = G * LD / 32;  // partial scales a block: one a warp of owners
  static_assert(RC == 0 || CC == 2, "the register cut keeps two chunks in shared memory");
  // Rows of A and of the carry: the register cut pads them with zeros to
  // S whole slices of RS states, so that its product runs unguarded.
  const int qp = RC > 0 ? S * RS : q;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                                                   // [qp][LDA]: input state i, column jl
  float4* carry = reinterpret_cast<float4*>(sA + (size_t)qp * LDA);  // [2][qp]: what the product reads
  float4* red = carry + 2 * qp;                                      // [S][LD]: the slices' partial sums
  float4* zpart = red + S * LD;                                     // [2][n * NZB]: partial scales
  const int nz = n * NZB;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(zpart + 2 * nz);  // RC > 0: [2] buffer b holds its step
  const unsigned step_bytes = (unsigned)sizeof(float4) * (q + nz);  // a step's carry and partial scales, into every block

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = n > 1 ? (int)cluster.block_rank() : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = rank * cols, width = min(cols, q - col0);
  const int model = blockIdx.y;
  const int seq0 = (blockIdx.x / n) * G;
  const float* Am = A + (size_t)model * q * q;

  // A's part: K2c column col0 + jl of A, K3c row col0 + jl (A^T's column),
  // zero in the padding columns. The register cut interleaves its two
  // chunks (columns jl and jl + 32 side by side: one 8-byte load a lane).
  auto slot = [](int jl) { return RC > 0 ? 2 * (jl & 31) + (jl >> 5) : jl; };
  if (BWD) {
    for (int x = tid; x < LDA * qp; x += THREADS) {
      const int jl = x / qp, i = x % qp;
      sA[i * LDA + slot(jl)] = jl < width && (RC == 0 || i < q) ? Am[(size_t)(col0 + jl) * q + i] : 0.f;
    }
  } else {
    for (int x = tid; x < qp * LDA; x += THREADS) {
      const int i = x / LDA, jl = x % LDA;
      sA[i * LDA + slot(jl)] = jl < width && (RC == 0 || i < q) ? Am[(size_t)i * q + col0 + jl] : 0.f;
    }
  }
  if constexpr (RC > 0) {
    for (int x = tid; x < 2 * (qp - q); x += THREADS) carry[x / (qp - q) * qp + q + x % (qp - q)] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // Warp w: input states i0 ... i1 - 1 of the product. With RC = 1 each
  // lane holds in ar the word of A for column LDA + lane and every state
  // of its warp's slice (zero past the slice and in the padding columns).
  const int rs = RC > 0 ? RS : (q + S - 1) / S, i0 = warp * rs, i1 = min(q, i0 + rs), nr = i1 - i0;
  float ar[RC > 0 ? RS : 1];
  if constexpr (RC > 0) {
    const int jc = LDA + lane;
#pragma unroll
    for (int r = 0; r < RS; ++r)
      ar[r] = r < nr && jc < width ? Am[BWD ? (size_t)(col0 + jc) * q + i0 + r : (size_t)(i0 + r) * q + col0 + jc] : 0.f;
  }

  // Thread tid < G * LD owns column jl = tid / 4 of sequence seq0 + h,
  // h = tid % 4: a warp of owners holds 8 columns of the 4 sequences
  // (whole warps: G * LD is a multiple of 32).
  const bool owner = tid < G * LD;
  const int h = tid & 3, jl = tid >> 2, j = col0 + jl;
  const bool real = owner && jl < width;
  const bool valid = real && seq0 + h < b;
  const size_t row0 = ((size_t)model * b + seq0 + h) * L;  // the sequence's first position
  auto pos = [&](int k) { return BWD ? L - 1 - k : k; };  // the position of step k
  auto emission = [&](int k) { return valid ? E[(row0 + pos(k)) * q + j] : 1.f; };
  auto barrier = [&]() {
    if (n > 1) cluster.sync();
    else __syncthreads();
  };
  // The owners' new carry v, packed with the column's other 3 sequences
  // into one float4, into every block's buffer buf; beside it the warp's
  // partial scale of s over its 8 columns (sum or max), one float4.
  auto publish = [&](int buf, float v, float s) {
    if constexpr (RC > 0) {
      // The register cut's counted stores, few instructions: every lane of
      // a column gathers its float4 and lane h stores it into blocks h and
      // h + 4; lane r < n stores the warp's partial scales into block r.
      float z = real ? s : 0.f;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const float w = __shfl_xor_sync(FULL, z, o);
        z = BWD ? fmaxf(z, w) : z + w;
      }
      const int c0 = lane & ~3;
      const float4 cv4 = make_float4(__shfl_sync(FULL, v, c0), __shfl_sync(FULL, v, c0 + 1),
                                     __shfl_sync(FULL, v, c0 + 2), __shfl_sync(FULL, v, c0 + 3));
      const float4 z4 = make_float4(__shfl_sync(FULL, z, 0), __shfl_sync(FULL, z, 1), __shfl_sync(FULL, z, 2),
                                    __shfl_sync(FULL, z, 3));
      float4* cv = carry + buf * qp + j;
      float4* cz = zpart + buf * nz + rank * NZB + warp;
      if (real) {
        for (int r = h; r < n; r += 4) store_counted(cluster_addr(cv, r), cv4, cluster_addr(full + buf, r));
      }
      if (lane < n) store_counted(cluster_addr(cz, lane), z4, cluster_addr(full + buf, lane));
      return;
    }
    const float v1 = __shfl_down_sync(FULL, v, 1), v2 = __shfl_down_sync(FULL, v, 2),
                v3 = __shfl_down_sync(FULL, v, 3);
    float z = real ? s : 0.f;  // s >= EPS * EPS > 0
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      const float w = __shfl_xor_sync(FULL, z, o);
      z = BWD ? fmaxf(z, w) : z + w;
    }
    const float z1 = __shfl_down_sync(FULL, z, 1), z2 = __shfl_down_sync(FULL, z, 2),
                z3 = __shfl_down_sync(FULL, z, 3);
    const bool store_v = h == 0 && real;
    float4* cv = carry + buf * qp + j;
    float4* cz = zpart + buf * nz + rank * NZB + warp;
    if (n == 1) {
      if (store_v) *cv = make_float4(v, v1, v2, v3);
      if (lane == 0) *cz = make_float4(z, z1, z2, z3);
      return;
    }
    for (int r = 0; r < n; ++r) {
      if (store_v) *cluster.map_shared_rank(cv, r) = make_float4(v, v1, v2, v3);
      if (lane == 0) *cluster.map_shared_rank(cz, r) = make_float4(z, z1, z2, z3);
    }
  };
  // The scale of sequence h in buffer buf, from every partial in a fixed
  // order (every thread of every block gets the same bits).
  auto scale = [&](int buf) {
    const float* zf = reinterpret_cast<const float*>(zpart + buf * nz) + h;
    float t[4] = {zf[0], zf[4], zf[8], zf[12]};
    for (int e = 4; e < nz; e += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) t[u] = BWD ? fmaxf(t[u], zf[4 * (e + u)]) : t[u] + zf[4 * (e + u)];
    }
    return BWD ? fmaxf(fmaxf(t[0], t[1]), fmaxf(t[2], t[3])) : (t[0] + t[1]) + (t[2] + t[3]);
  };
  // The register cut's scale, a warp's work: lane l takes the partials
  // e = l / 4 (mod 8) of sequence h = l % 4 in order, then a butterfly over
  // the 8 lanes of h (every lane of h, and every block, gets the same bits).
  auto scale_tree = [&](int buf) {
    const float* zf = reinterpret_cast<const float*>(zpart + buf * nz) + h;
    const int e0 = lane >> 2;
    float t = zf[4 * e0];
#pragma unroll
    for (int u = 1; u < MAX_CLUSTER * NZB / 8; ++u) {
      const int e = e0 + 8 * u;
      if (e < nz) t = BWD ? fmaxf(t, zf[4 * e]) : t + zf[4 * e];
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      const float w = __shfl_xor_sync(FULL, t, o);
      t = BWD ? fmaxf(t, w) : t + w;
    }
    return t;
  };
  // The register cut's exchange: buffer b's mbarrier completes a phase when
  // its step's carry and partial scales have all landed (buffer 0 waits
  // for step 0's).
  if constexpr (RC > 0) {
    if (tid == 0) {
      mbar_init(full);
      mbar_init(full + 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect(full, step_bytes);
    }
  }
  // Every block has started before any peer stores into it.
  barrier();

  float s_prev = 1.f, e_next = 1.f, ll = 0.f;
  // The output of step k - 1: log(s_prev / z) + ll + log z, taken as
  // log s_prev + ll (the log-scale before z).
  auto finish = [&](int k, float s) {
    if (out != nullptr && valid) out[(row0 + pos(k - 1)) * q + j] = logf(s) + ll;
  };
  if (owner) {
    const float e0 = fmaxf(emission(0), EPS);
    if (!BWD) s_prev = e0 * fmaxf(real ? init[(size_t)model * q + j] : 1.f, EPS);
    publish(0, BWD ? e0 : s_prev, s_prev);
    if (L > 1) e_next = emission(1);
  }
  if constexpr (RC == 0) barrier();

  // Warp w: input states i0 ... i1 - 1, for column lane + 32 c of every
  // chunk c; the slices' sums as float4s over the 4 sequences.
  const float* a = sA + lane;
  const float* redf = reinterpret_cast<const float*>(red) + 4 * jl + h;  // the owner's word of slice 0
  for (int k = 1; k < L; ++k) {
    const int cur = (k - 1) & 1;
    if constexpr (RC > 0) {
      // Step k - 1's carry has landed in every block; step k's phase is
      // armed (its buffer's last phase, step k - 2's, completed a step ago).
      mbar_wait(full + cur, ((k - 1) >> 1) & 1);
      if (tid == 0) mbar_expect(full + (k & 1), step_bytes);
    }
    {
      const float4* v4 = carry + cur * qp;
      float acc[CC + RC][G];
#pragma unroll
      for (int c = 0; c < CC + RC; ++c) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[c][g] = 0.f;
      }
      auto terms = [&](float (&y)[G], const float4 v, const float x) {
        y[0] = fmaf(v.x, x, y[0]);
        y[1] = fmaf(v.y, x, y[1]);
        y[2] = fmaf(v.z, x, y[2]);
        y[3] = fmaf(v.w, x, y[3]);
      };
      if constexpr (RC == 0) {
#pragma unroll 2
        for (int i = i0; i < i1; ++i) {
          const float4 v = v4[i];
          const float* ai = a + i * LDA;
#pragma unroll
          for (int c = 0; c < CC; ++c) terms(acc[c], v, ai[32 * c]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          const float4 v = v4[i0 + r];
          const float2 x = reinterpret_cast<const float2*>(sA + (i0 + r) * LDA)[lane];
          terms(acc[0], v, x.x);
          terms(acc[1], v, x.y);
          terms(acc[2], v, ar[r]);
        }
      }
#pragma unroll
      for (int c = 0; c < CC + RC; ++c)
        red[warp * LD + 32 * c + lane] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    }
    __syncthreads();
    float z = 1.f, s_old = s_prev;
    if (owner) {
      z = RC > 0 ? scale_tree(cur) : scale(cur);
      if constexpr (RC == 0) {
        finish(k, s_prev);
        ll += logf(z);
      }
      float sum = redf[0];
#pragma unroll
      for (int w = 1; w < S; ++w) sum += redf[4 * w * LD];
      const float x = fmaxf(sum / z, EPS), e = fmaxf(e_next, EPS);
      s_prev = BWD ? x : e * x;
      publish(k & 1, BWD ? e * x : s_prev, s_prev);
      // The next step's emission, while the other warps wait at the
      // barrier and the load pipe is free.
      if (RC == 0 && k + 1 < L) e_next = emission(k + 1);
    }
    if constexpr (RC == 0) {
      barrier();
    } else if (owner) {
      // The register cut has no barrier: what the next step's product does
      // not read (the output, the log-scale, the next emission) follows
      // the stores while the peers finish theirs.
      finish(k, s_old);
      ll += logf(z);
      if (k + 1 < L) e_next = emission(k + 1);
    }
  }
  if constexpr (RC > 0) mbar_wait(full + ((L - 1) & 1), ((L - 1) >> 1) & 1);
  // The last step's output; K2c's log-likelihood.
  if (owner) {
    const float z = RC > 0 ? scale_tree((L - 1) & 1) : scale((L - 1) & 1);
    finish(L, s_prev);
    ll += logf(z);
    if (!BWD && rank == 0 && jl == 0 && seq0 + h < b) ll_out[(size_t)model * b + seq0 + h] = ll;
  }
  // No block leaves before every block holds the last step: its stores
  // into the others have all landed.
  if constexpr (RC > 0) cluster.sync();
}

template <bool BWD>
int launch(const float* init, const float* A, const float* E, float* out,
           float* ll, int m, int b, int L, int q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q < MIN_WIDE_Q || q > MAX_WIDE_Q || m < 1 || b < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const Cut c = cut_of(q);
  if (c.n > MAX_CLUSTER || c.cc < 2 || c.cc > MAX_CC) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(c.n * ((b + G - 1) / G)), (unsigned)m, 1);
  cfg.blockDim = dim3(32 * warps_of(c.cc), 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(q, c);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c.n > 1 ? 1 : 0;
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
    return e != cudaSuccess ? e : cudaLaunchKernelEx(&cfg, kernel, init, A, E, out, ll, b, L, q, c.n, c.cols);
  };
  if (c.rc > 0) {
    err = run(sum_wide_kernel<BWD, 2, 1>);
  } else {
    switch (c.cc) {
      case 2: err = run(sum_wide_kernel<BWD, 2, 0>); break;
      case 3: err = run(sum_wide_kernel<BWD, 3, 0>); break;
      case 4: err = run(sum_wide_kernel<BWD, 4, 0>); break;
      default: err = run(sum_wide_kernel<BWD, 5, 0>); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2c. out may be null (the log-likelihood alone); the wrapper checks the
// shapes.
int hmm_sum_forward_wide(const float* init, const float* A, const float* E,
                         float* out, float* ll, int m, int b, int L, int q,
                         int device, void* stream) {
  return launch<false>(init, A, E, out, ll, m, b, L, q, device, stream);
}

// K3c.
int hmm_sum_backward_wide(const float* A, const float* E, float* out, int m,
                          int b, int L, int q, int device, void* stream) {
  return launch<true>(nullptr, A, E, out, nullptr, m, b, L, q, device, stream);
}

}  // extern "C"
