// The sequential sum-product passes for 64 < q <= 512 states (K2c, K3c),
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
// (a profile MAP step: 16,110 kernels with the loops, 4,112 with K2c/K3c).
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
// against ~160 MB of E in and log alpha out (~0.05 ms). Each step needs all
// of the previous carry, so a step is one matrix-vector product of q^2
// terms a sequence, a sum over q and a division, in a few hundred cycles.
//
// Design: a block (or a cluster of n blocks) holds a group of G = 4
// sequences of one model for the whole pass. A stays on chip: each block
// holds the columns of A it produces (K3c: rows, loaded transposed) for
// every input state in shared memory, zero-padded to whole 32-column chunks;
// q <= 160 fits one block (q = 155: 97 KB), and above that the columns are
// split over a cluster of n <= 8 blocks (q = 505 and 512: eight blocks of 64).
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
constexpr int MAX_WIDE_Q = 512;      // A on chip in a cluster of 8 (below)
constexpr int G = 4;                 // sequences a block: one float4 a state
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int A_BYTES = 128 * 1024;  // bytes of A a block holds, at most
constexpr int MAX_CC = 5;            // 32-column chunks a block, at most (q <= 160 in one block)

// Warps a block of cc 32-column chunks: one thread a (column, sequence)
// pair, and 16 warps at least (the product's slices of the input states).
__host__ __device__ constexpr int warps_of(int cc) { return G * cc > 16 ? G * cc : 16; }

// How a block's work is cut for q states: n blocks a cluster, each with
// cols output columns in cc chunks of 32.
struct Cut {
  int n, cols, cc;
};

Cut cut_of(int q) {
  const int cc_max = min(MAX_CC, A_BYTES / (q * 32 * (int)sizeof(float)));
  const int n = (q + 32 * cc_max - 1) / (32 * cc_max);
  const int cols = (q + n - 1) / n;
  return {n, cols, (cols + 31) / 32};
}

size_t smem_bytes(int q, const Cut& c) {
  const size_t ld = 32 * (size_t)c.cc;
  return sizeof(float) * (q * ld) + sizeof(float4) * (2 * (size_t)q + warps_of(c.cc) * ld + 2 * (size_t)c.n * G * c.cc);
}

// One pass: K2c (BWD = false) or K3c (BWD = true) with CC chunks of 32
// columns a block. Grid: x = n * the groups of G sequences, y = m; a cluster
// of n along x.
template <bool BWD, int CC>
__global__ void __launch_bounds__(32 * warps_of(CC), 1)
    sum_wide_kernel(const float* __restrict__ init, const float* __restrict__ A,
                    const float* __restrict__ E, float* __restrict__ out,
                    float* __restrict__ ll_out, int b, int L, int q, int n,
                    int cols) {
  constexpr int LD = 32 * CC;
  constexpr int S = warps_of(CC), THREADS = 32 * S;
  constexpr int NZB = G * LD / 32;  // partial scales a block: one a warp of owners
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                                                 // [q][LD]: input state i, column jl
  float4* carry = reinterpret_cast<float4*>(sA + (size_t)q * LD);  // [2][q]: what the product reads
  float4* red = carry + 2 * q;                                      // [S][LD]: the slices' partial sums
  float4* zpart = red + S * LD;                                     // [2][n * NZB]: partial scales
  const int nz = n * NZB;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = n > 1 ? (int)cluster.block_rank() : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = rank * cols, width = min(cols, q - col0);
  const int model = blockIdx.y;
  const int seq0 = (blockIdx.x / n) * G;
  const float* Am = A + (size_t)model * q * q;

  // A's part: K2c column col0 + jl of A, K3c row col0 + jl (A^T's column),
  // zero in the padding columns.
  if (BWD) {
    for (int x = tid; x < LD * q; x += THREADS) {
      const int jl = x / q, i = x % q;
      sA[i * LD + jl] = jl < width ? Am[(size_t)(col0 + jl) * q + i] : 0.f;
    }
  } else {
    for (int x = tid; x < q * LD; x += THREADS) {
      const int i = x / LD, jl = x % LD;
      sA[x] = jl < width ? Am[(size_t)i * q + col0 + jl] : 0.f;
    }
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
    float4* cv = carry + buf * q + j;
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
  // Every block has started before any peer stores into it.
  barrier();

  float s_prev = 1.f, e_next = 1.f, ll = 0.f;
  // The output of step k - 1: log(s_prev / z) + ll + log z, taken as
  // log s_prev + ll (the log-scale before z).
  auto finish = [&](int k) {
    if (out != nullptr && valid) out[(row0 + pos(k - 1)) * q + j] = logf(s_prev) + ll;
  };
  if (owner) {
    const float e0 = fmaxf(emission(0), EPS);
    if (!BWD) s_prev = e0 * fmaxf(real ? init[(size_t)model * q + j] : 1.f, EPS);
    publish(0, BWD ? e0 : s_prev, s_prev);
    if (L > 1) e_next = emission(1);
  }
  barrier();

  // Warp w: input states i0 ... i1 - 1, for column lane + 32 c of every
  // chunk c; the slices' sums as float4s over the 4 sequences.
  const int rs = (q + S - 1) / S, i0 = warp * rs, i1 = min(q, i0 + rs);
  const float* a = sA + lane;
  const float* redf = reinterpret_cast<const float*>(red) + 4 * jl + h;  // the owner's word of slice 0
  for (int k = 1; k < L; ++k) {
    const int cur = (k - 1) & 1;
    {
      const float4* v4 = carry + cur * q;
      float acc[CC][G];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[c][g] = 0.f;
      }
#pragma unroll 2
      for (int i = i0; i < i1; ++i) {
        const float4 v = v4[i];
        const float* ai = a + i * LD;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const float x = ai[32 * c];
          acc[c][0] = fmaf(v.x, x, acc[c][0]);
          acc[c][1] = fmaf(v.y, x, acc[c][1]);
          acc[c][2] = fmaf(v.z, x, acc[c][2]);
          acc[c][3] = fmaf(v.w, x, acc[c][3]);
        }
      }
#pragma unroll
      for (int c = 0; c < CC; ++c)
        red[warp * LD + 32 * c + lane] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    }
    __syncthreads();
    if (owner) {
      const float z = scale(cur);
      finish(k);
      ll += logf(z);
      float sum = redf[0];
#pragma unroll
      for (int w = 1; w < S; ++w) sum += redf[4 * w * LD];
      const float x = fmaxf(sum / z, EPS), e = fmaxf(e_next, EPS);
      s_prev = BWD ? x : e * x;
      publish(k & 1, BWD ? e * x : s_prev, s_prev);
      // The next step's emission, while the other warps wait at the
      // barrier and the load pipe is free.
      if (k + 1 < L) e_next = emission(k + 1);
    }
    barrier();
  }
  // The last step's output; K2c's log-likelihood.
  if (owner) {
    const float z = scale((L - 1) & 1);
    finish(L);
    ll += logf(z);
    if (!BWD && rank == 0 && jl == 0 && seq0 + h < b) ll_out[(size_t)model * b + seq0 + h] = ll;
  }
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
  switch (c.cc) {
    case 2: err = run(sum_wide_kernel<BWD, 2>); break;
    case 3: err = run(sum_wide_kernel<BWD, 3>); break;
    case 4: err = run(sum_wide_kernel<BWD, 4>); break;
    default: err = run(sum_wide_kernel<BWD, 5>); break;
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
