// Kernel M5 mcl_group_stats for Hopper (sm_90a): the grouping statistics
// of ops/grouped.py::group_stats (its plain version, group_stats_plain)
// on the card, with no host read, so that the step's graph A holds it.
//
// It replaces no Pallas kernel: the JAX package leaves
// mcl_3dl_tpu/ops/grouped.py:140 group_stats to XLA.  It was written
// because the plain version held most of graph A: [N, G] one-hot masks
// and matmuls for the per-bin moments, and two scatter_reduce calls
// ("amin"/"amax") whose N x 12 writers contend for G x 12 addresses, a
// float compare-and-swap loop each on the card (PERF.md, section 6).
//
// The same steps in float32 as the plain version:
//   1. yaw, pitch and roll from the quaternion;
//   2. the active yaw range, the pitch and roll means, the count;
//   3. g0 (the content bin), A (written once, elementwise) and the active
//      centre a_ctr of A;
//   4. pass 1: each bin's count, mean and two-pass std of Ac = A - a_ctr
//      over its active members;
//   5. sigma_med, the column median of the std over non-empty bins (the
//      two middle values averaged, 0.5 a + 0.5 b);
//   6. the ENV_SIGMA_TRIM inlier test;
//   7. pass 2: the mean and std over the inliers;
//   8. the inliers' per-bin min and max;
//   9. the envelope, a_min/a_max, the outliers, g and n_over.
// Each operation is spelled with __fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn and __fsqrt_rn (and the file is built with -fmad=false), in
// the plain version's order, so A is bit-equal to it.  The sums are taken
// in another order than PyTorch's reductions and matmuls, so the means,
// stds and bounds agree to rounding, and g on all but the particles
// within an ulp of a bin or envelope edge.
//
// Launches, all on the caller's stream (14 a call; inside a CUDA graph
// they replay without the host):
//   frame     grid  steps 1-3: A, and per-block yaw min/max, sums
//   totals    1     the step's constants (ylo, yspan, pitch and roll
//                   means, a_ctr)
//   bins      grid  g0 into g; pass-1 count and sums      -> totals
//   moments   grid  pass-1 squared deviations            -> totals
//   envelope1 1     mean1, the std, sigma_med, the trim width h1
//   moments   grid  inliers: count, sums, min, max        -> totals
//   moments   grid  pass-2 squared deviations            -> totals
//   envelope2 1     the envelope, a_min, a_max, any_active
//   route     grid  g, and the outliers a block          -> n_over
// Separate launches rather than one cooperative kernel: the device-wide
// steps between passes are the launch boundaries, a replayed graph makes
// the launches cheap, and no block has to stay resident.
//
// Reproducible.  There are no float atomics: the sums and their order
// depend only on N and the bin grid, never on scheduling, so two calls on
// the same inputs give the same bits (a graphed and an eager step agree).
//   * A pass streams the particles in a grid-stride loop, one particle a
//     thread, over min(ceil(N / 256), 264) blocks of 256 threads.
//   * Each warp owns its own per-bin accumulators in shared memory
//     ([G, 13] f32, a stride of 13 words so that distinct bins fall in
//     distinct banks).  The lanes of a warp that share a bin
//     (__match_any_sync) add in lane order, one lane a bin per round, so
//     the adds of a round never collide; a round is as long as the
//     largest group of equal bins in the warp.
//   * The block adds its warps' rows in warp order and writes one partial
//     row a block; `totals` adds the blocks' partials in a fixed order,
//     a warp an entry (a lane's blocks in order, then a butterfly).
//   * Minima and maxima go through shared-memory integer atomics on an
//     order-preserving encoding of the float: exact in any order.
//
// What bounds it on this card.  It is bound by bytes.  The least it must
// move is the inputs once (pos 12 B, rot 16 B, the rotation matrix 36 B,
// the mask 1 B a particle) and the outputs once (g 4 B, A 48 B): 117 B a
// particle, 123 MB and 37 us at 1,048,576 particles at 3.35 TB/s.  The
// passes re-read A (48 B), g and the mask about five times, ~400 B a
// particle, much of it from the 50 MB L2; the per-block partials
// (264 x 37 x G floats at most) and the one-block steps are small beside
// that.  The work a particle is a few dozen f32 operations and one
// shared-memory add of 13 values a pass, far under the f32 rate; the
// warp's rounds cost most where a warp's particles share one bin.
//
// Shared memory a block: 8 warps x G x 13 words of accumulators plus up
// to four [G, 12] tables, 608 G bytes (58 KB at the flagship's 96 bins).
// A bin grid past the device's per-block opt-in maximum (382 bins on an
// H100) is refused by the operator (csrc/ops.cpp) before any launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 264;        // two a multiprocessor of an H100
constexpr int NC = 12;                 // coefficients a particle
constexpr int QS = 13;                 // a bin's row: 12 sums and the count
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;            // the plain version's `big`

// frame partials a block: yaw min, yaw max, pitch sum, roll sum, active
// count, the 12 sums of A over active particles
constexpr int P0Q = 5 + NC;
// the step's constants (`glob`): ylo, yspan, pitch mean, roll mean, a_ctr
constexpr int YLO = 0, YSPAN = 1, PMID = 2, RMID = 3, ACTR = 4;
constexpr int GLOB = ACTR + NC;

struct Consts {
  int gy, gp, gr, groups;      // the bin grid, groups = gy * gp * gr
  float w[3];                  // the field's axis weights, as f32
  float inv_cell;              // f32(1 / cell)
  float floors[NC];            // the envelope's absolute floors
  float trim;                  // ENV_SIGMA_TRIM
  float sigma;                 // ENV_SIGMA
  float eps;                   // f32(_ENV_EPS)
};

int64_t part_q(int groups) {
  const int64_t q = (int64_t)groups * (QS + 2 * NC);
  return q > P0Q ? q : P0Q;
}

int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

// The scratch buffer's parts, as offsets in floats (`end`: its length):
// the per-block partials [blocks, part_q] at 0, the step's constants,
// pass 1's sums and counts [G, 13] and squared deviations [G, 12], mean1
// and the trim width h1 [G, 12], the inliers' sums and counts [G, 13]
// then their min and max [G, 12] each, pass 2's squared deviations
// [G, 12], and the centred envelope lo, hi [G, 12].
struct Offsets {
  int64_t glob, tot1, tot2, mean1, h1, tot3, tot4, lo, hi, end;
};

Offsets offsets(int64_t n, int groups) {
  const int64_t gq = (int64_t)groups * NC;
  Offsets o;
  o.glob = blocks_for(n) * part_q(groups);
  o.tot1 = o.glob + GLOB;
  o.tot2 = o.tot1 + (int64_t)groups * QS;
  o.mean1 = o.tot2 + gq;
  o.h1 = o.mean1 + gq;
  o.tot3 = o.h1 + gq;
  o.tot4 = o.tot3 + (int64_t)groups * (QS + 2 * NC);
  o.lo = o.tot4 + gq;
  o.hi = o.lo + gq;
  o.end = o.hi + gq;
  return o;
}

// shared memory of the accumulating passes: the warps' rows and up to
// four [G, 12] tables
int64_t acc_smem(int groups, int tables) {
  return ((int64_t)WARPS * groups * QS + (int64_t)tables * groups * NC) * 4;
}

// ---- device helpers

// torch.clamp(x, -1, 1)
__device__ __forceinline__ float clamp1(float x) {
  return fminf(fmaxf(x, -1.0f), 1.0f);
}

// _ypr_from_quat, rot = (x, y, z, w)
__device__ __forceinline__ void ypr(const float* __restrict__ rot, int64_t i,
                                    float& yaw, float& pitch, float& roll) {
  const float x = rot[4 * i], y = rot[4 * i + 1], z = rot[4 * i + 2],
              w = rot[4 * i + 3];
  yaw = atan2f(
      __fmul_rn(2.0f, __fadd_rn(__fmul_rn(w, z), __fmul_rn(x, y))),
      __fsub_rn(1.0f,
                __fmul_rn(2.0f, __fadd_rn(__fmul_rn(y, y), __fmul_rn(z, z)))));
  pitch = asinf(clamp1(
      __fmul_rn(2.0f, __fsub_rn(__fmul_rn(w, y), __fmul_rn(z, x)))));
  roll = atan2f(
      __fmul_rn(2.0f, __fadd_rn(__fmul_rn(w, x), __fmul_rn(y, z))),
      __fsub_rn(1.0f,
                __fmul_rn(2.0f, __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)))));
}

// the content bin g0 of particle i
__device__ __forceinline__ int bin_of(const float* __restrict__ rot, int64_t i,
                                      const Consts& k,
                                      const float* __restrict__ glob) {
  float yaw, pitch, roll;
  ypr(rot, i, yaw, pitch, roll);
  int yb = __float2int_rz(__fmul_rn(
      __fdiv_rn(__fsub_rn(yaw, glob[YLO]), glob[YSPAN]), (float)k.gy));
  yb = min(max(yb, 0), k.gy - 1);
  const int pb = k.gp > 1 && pitch > glob[PMID];
  const int rb = k.gr > 1 && roll > glob[RMID];
  return (yb * k.gp + pb) * k.gr + rb;
}

// Ac = A - a_ctr of particle i
__device__ __forceinline__ void centred(const float* __restrict__ A, int64_t i,
                                        const float* __restrict__ glob,
                                        float (&v)[QS]) {
  const float4* a4 = reinterpret_cast<const float4*>(A + NC * i);
  const float4 p = a4[0], q = a4[1], r = a4[2];
  const float a[NC] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w,
                       r.x, r.y, r.z, r.w};
#pragma unroll
  for (int c = 0; c < NC; ++c) v[c] = __fsub_rn(a[c], glob[ACTR + c]);
}

// Adds the first nq of v to row b of the warp's accumulators, for the
// lanes where `member`: lanes that share a bin add in lane order, one a
// round, so no two adds of a round touch one row.
__device__ __forceinline__ void warp_add(float* acc, bool member, int b,
                                         const float (&v)[QS], int nq) {
  const unsigned peers = __match_any_sync(FULL, member ? b : -1);
  const unsigned lane = threadIdx.x & 31u;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int rounds = (int)__reduce_max_sync(
      FULL, member ? (unsigned)__popc(peers) : 0u);
  for (int r = 0; r < rounds; ++r) {
    if (member && rank == r) {
      float* row = acc + b * QS;
      for (int q = 0; q < nq; ++q) row[q] = __fadd_rn(row[q], v[q]);
    }
    __syncwarp();
  }
}

// the block's warps' rows added in warp order, one partial row a block
__device__ __forceinline__ void write_rows(const float* acc, int entries,
                                           float* __restrict__ out) {
  __syncthreads();
  for (int e = threadIdx.x; e < entries; e += THREADS) {
    float s = acc[e];
    for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, acc[w * entries + e]);
    out[e] = s;
  }
}

// an order-preserving integer code of a float, and back
__device__ __forceinline__ int key_of(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float float_of(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// op 0: sum, 1: min, 2: max
__device__ __forceinline__ float combine(int op, float a, float b) {
  return op == 0 ? __fadd_rn(a, b) : op == 1 ? fminf(a, b) : fmaxf(a, b);
}

// the per-block partials of P0Q frame quantities, reduced in `red`
// ([P0Q][THREADS]) by a fixed tree; thread 0 holds the result
__device__ __forceinline__ void tree(float (*red)[THREADS]) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int q = 0; q < P0Q; ++q)
        red[q][t] = combine(q == 0 ? 1 : q == 1 ? 2 : 0, red[q][t],
                            red[q][t + s]);
    }
    __syncthreads();
  }
}

// ---- kernels

// steps 1-3: A, and the block's yaw range and sums over active particles
__global__ void __launch_bounds__(THREADS)
frame_kernel(const float* __restrict__ pos, const float* __restrict__ rmat,
             const float* __restrict__ rot, const bool* __restrict__ active,
             const float* __restrict__ origin, Consts k, float* __restrict__ A,
             float* __restrict__ part, int64_t n) {
  __shared__ float red[P0Q][THREADS];
  float acc[P0Q];
  acc[0] = BIG;
  acc[1] = -BIG;
#pragma unroll
  for (int q = 2; q < P0Q; ++q) acc[q] = 0.0f;
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float org[3] = {ox, oy, oz};
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    float a[NC];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        a[3 * r + c] =
            __fmul_rn(__fmul_rn(rmat[9 * i + 3 * r + c], k.w[r]), k.inv_cell);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a[9 + c] = __fmul_rn(
          __fsub_rn(__fmul_rn(pos[3 * i + c], k.w[c]), org[c]), k.inv_cell);
    float4* a4 = reinterpret_cast<float4*>(A + NC * i);
    a4[0] = make_float4(a[0], a[1], a[2], a[3]);
    a4[1] = make_float4(a[4], a[5], a[6], a[7]);
    a4[2] = make_float4(a[8], a[9], a[10], a[11]);
    if (active[i]) {
      float yaw, pitch, roll;
      ypr(rot, i, yaw, pitch, roll);
      acc[0] = fminf(acc[0], yaw);
      acc[1] = fmaxf(acc[1], yaw);
      acc[2] = __fadd_rn(acc[2], pitch);
      acc[3] = __fadd_rn(acc[3], roll);
      acc[4] = __fadd_rn(acc[4], 1.0f);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[5 + c] = __fadd_rn(acc[5 + c], a[c]);
    }
  }
#pragma unroll
  for (int q = 0; q < P0Q; ++q) red[q][threadIdx.x] = acc[q];
  tree(red);
  if (threadIdx.x < P0Q)
    part[(int64_t)blockIdx.x * P0Q + threadIdx.x] = red[threadIdx.x][0];
}

// the step's constants from the blocks' frame partials
__global__ void __launch_bounds__(THREADS)
frame_totals_kernel(const float* __restrict__ part, int nb,
                    float* __restrict__ glob) {
  __shared__ float red[P0Q][THREADS];
  const int t = threadIdx.x;
  for (int q = 0; q < P0Q; ++q) {
    const int op = q == 0 ? 1 : q == 1 ? 2 : 0;
    float v = q == 0 ? BIG : q == 1 ? -BIG : 0.0f;
    for (int b = t; b < nb; b += THREADS)
      v = combine(op, v, part[(int64_t)b * P0Q + q]);
    red[q][t] = v;
  }
  tree(red);
  if (t == 0) {
    const float nact = fmaxf(red[4][0], 1.0f);
    glob[YLO] = red[0][0];
    glob[YSPAN] = fmaxf(__fsub_rn(red[1][0], red[0][0]), 1e-6f);
    glob[PMID] = __fdiv_rn(red[2][0], nact);
    glob[RMID] = __fdiv_rn(red[3][0], nact);
    for (int c = 0; c < NC; ++c)
      glob[ACTR + c] = __fdiv_rn(red[5 + c][0], nact);
  }
}

// g0 into g; pass 1's per-bin count and sums of Ac over active members
__global__ void __launch_bounds__(THREADS)
bins_kernel(const float* __restrict__ rot, const bool* __restrict__ active,
            const float* __restrict__ A, const float* __restrict__ glob,
            Consts k, int32_t* __restrict__ g, float* __restrict__ part,
            int64_t n) {
  extern __shared__ float smem[];
  const int entries = k.groups * QS;
  for (int e = threadIdx.x; e < WARPS * entries; e += THREADS) smem[e] = 0.0f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  float* acc = smem + warp * entries;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t base = (int64_t)blockIdx.x * THREADS + warp * 32; base < n;
       base += stride) {
    const int64_t i = base + (threadIdx.x & 31);
    bool member = false;
    int b = 0;
    float v[QS];
    if (i < n) {
      b = bin_of(rot, i, k, glob);
      g[i] = b;
      member = active[i];
      if (member) {
        centred(A, i, glob, v);
        v[NC] = 1.0f;
      }
    }
    warp_add(acc, member, b, v, QS);
  }
  write_rows(smem, entries, part + (int64_t)blockIdx.x * entries);
}

// The accumulating passes over g0's bins.  INLIERS: the members are the
// particles that pass the trim test (mean1, h1), else the active ones.
// SQUARES: add (Ac - mean)^2 with mean = sums / max(count, 1) of `tot`
// ([G, 13] rows), else Ac, the count, and the members' min and max.
template <bool INLIERS, bool SQUARES>
__global__ void __launch_bounds__(THREADS)
moments_kernel(const bool* __restrict__ active, const float* __restrict__ A,
               const int32_t* __restrict__ g, const float* __restrict__ glob,
               const float* __restrict__ tot, const float* __restrict__ mean1,
               const float* __restrict__ h1, Consts k,
               float* __restrict__ part, int64_t n) {
  extern __shared__ float smem[];
  const int groups = k.groups, gq = groups * NC;
  const int entries = groups * QS;
  float* tab = smem + WARPS * entries;
  float* s_mean1 = tab;                 // INLIERS
  float* s_h1 = tab + gq;               // INLIERS
  float* s_mean = tab + (INLIERS ? 2 * gq : 0);                   // SQUARES
  int* s_min = reinterpret_cast<int*>(tab + (INLIERS ? 2 * gq : 0));  // !SQUARES
  int* s_max = s_min + gq;
  for (int e = threadIdx.x; e < WARPS * entries; e += THREADS) smem[e] = 0.0f;
  for (int e = threadIdx.x; e < gq; e += THREADS) {
    if (INLIERS) {
      s_mean1[e] = mean1[e];
      s_h1[e] = h1[e];
    }
    if (SQUARES) {
      const int b = e / NC, c = e % NC;
      s_mean[e] = __fdiv_rn(tot[b * QS + c], fmaxf(tot[b * QS + NC], 1.0f));
    } else {
      s_min[e] = key_of(BIG);
      s_max[e] = key_of(-BIG);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  float* acc = smem + warp * entries;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t base = (int64_t)blockIdx.x * THREADS + warp * 32; base < n;
       base += stride) {
    const int64_t i = base + (threadIdx.x & 31);
    bool member = false;
    int b = 0;
    float v[QS];
    if (i < n && active[i]) {
      b = g[i];
      centred(A, i, glob, v);
      member = true;
      if (INLIERS) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          member = member && fabsf(__fsub_rn(v[c], s_mean1[b * NC + c])) <=
                                 s_h1[b * NC + c];
      }
      if (member) {
        if (SQUARES) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float d = __fsub_rn(v[c], s_mean[b * NC + c]);
            v[c] = __fmul_rn(d, d);
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            atomicMin(&s_min[b * NC + c], key_of(v[c]));
            atomicMax(&s_max[b * NC + c], key_of(v[c]));
          }
          v[NC] = 1.0f;
        }
      }
    }
    warp_add(acc, member, b, v, SQUARES ? NC : QS);
  }
  // SQUARES rows are [G, 12] partials; the others [G, 13], then min, max
  float* out = part + (int64_t)blockIdx.x * (SQUARES ? gq : entries + 2 * gq);
  if (SQUARES) {
    __syncthreads();
    for (int e = threadIdx.x; e < gq; e += THREADS) {
      const int row = (e / NC) * QS + e % NC;
      float s = smem[row];
      for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, smem[w * entries + row]);
      out[e] = s;
    }
  } else {
    write_rows(smem, entries, out);
    for (int e = threadIdx.x; e < gq; e += THREADS) {
      out[entries + e] = float_of(s_min[e]);
      out[entries + gq + e] = float_of(s_max[e]);
    }
  }
}

// Adds the blocks' partials of every entry in block order, a warp an
// entry: entries [0, n_sum) are sums, then n_min minima, then maxima.
__global__ void __launch_bounds__(THREADS)
totals_kernel(const float* __restrict__ part, int nb, int entries, int n_sum,
              int n_min, float* __restrict__ out) {
  const int e = (int)(((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5);
  if (e >= entries) return;
  const int lane = threadIdx.x & 31;
  const int op = e < n_sum ? 0 : e < n_sum + n_min ? 1 : 2;
  float s = op == 0 ? 0.0f : op == 1 ? INFINITY : -INFINITY;
  for (int b = lane; b < nb; b += 32)
    s = combine(op, s, part[(int64_t)b * entries + e]);
  for (int off = 16; off > 0; off >>= 1)
    s = combine(op, s, __shfl_xor_sync(FULL, s, off));
  if (lane == 0) out[e] = s;
}

// mean1, the pass-1 std, sigma_med (the column median over non-empty
// bins, 0 where none) and the trim width h1 = max(trim * s1, floor) + eps
// with s1 = max(sigma_med, min(std, 3 sigma_med))
__global__ void __launch_bounds__(THREADS)
envelope1_kernel(const float* __restrict__ tot1, const float* __restrict__ tot2,
                 Consts k, float* __restrict__ mean1, float* __restrict__ h1) {
  extern __shared__ float smem[];
  const int groups = k.groups, gq = groups * NC;
  float* sd = smem;                                   // [G, 12]
  float* mid = sd + gq;                               // [2, 12]
  int* full = reinterpret_cast<int*>(mid + 2 * NC);   // [G] non-empty
  int* n_full = full + groups;
  const int t = threadIdx.x;
  for (int e = t; e < gq; e += THREADS) {
    const int b = e / NC, c = e % NC;
    const float cnt = fmaxf(tot1[b * QS + NC], 1.0f);
    mean1[e] = __fdiv_rn(tot1[b * QS + c], cnt);
    sd[e] = __fsqrt_rn(__fdiv_rn(tot2[e], cnt));
  }
  for (int b = t; b < groups; b += THREADS) full[b] = tot1[b * QS + NC] > 0.0f;
  __syncthreads();
  if (t == 0) {
    int m = 0;
    for (int b = 0; b < groups; ++b) m += full[b];
    *n_full = m;
  }
  __syncthreads();
  const int m = *n_full;
  const int lo = max((m - 1) / 2, 0), hi = m / 2;
  // the rank of each non-empty bin's std in its column (ties by bin)
  for (int e = t; e < gq; e += THREADS) {
    const int b = e / NC, c = e % NC;
    if (!full[b]) continue;
    const float v = sd[e];
    int rank = 0;
    for (int j = 0; j < groups; ++j) {
      const float u = sd[j * NC + c];
      rank += full[j] && (u < v || (u == v && j < b));
    }
    if (rank == lo) mid[c] = v;
    if (rank == hi) mid[NC + c] = v;
  }
  __syncthreads();
  for (int e = t; e < gq; e += THREADS) {
    const int c = e % NC;
    const float med = m > 0 ? __fadd_rn(__fmul_rn(0.5f, mid[c]),
                                        __fmul_rn(0.5f, mid[NC + c]))
                            : 0.0f;
    const float s1 = fmaxf(med, fminf(sd[e], __fmul_rn(3.0f, med)));
    h1[e] = __fadd_rn(fmaxf(__fmul_rn(k.trim, s1), k.floors[c]), k.eps);
  }
}

// the envelope over the inliers' moments, min and max; a_min/a_max with
// the zero row of the outlier bin; any_active
__global__ void __launch_bounds__(THREADS)
envelope2_kernel(const float* __restrict__ tot1, const float* __restrict__ tot3,
                 const float* __restrict__ tot4, const float* __restrict__ glob,
                 Consts k, float* __restrict__ lo, float* __restrict__ hi,
                 float* __restrict__ a_min, float* __restrict__ a_max,
                 bool* __restrict__ any_active) {
  const int groups = k.groups, gq = groups * NC, entries = groups * QS;
  for (int e = threadIdx.x; e < gq; e += THREADS) {
    const int b = e / NC, c = e % NC;
    const float cnt = fmaxf(tot3[b * QS + NC], 1.0f);
    const float mean2 = __fdiv_rn(tot3[b * QS + c], cnt);
    const float sd2 = __fsqrt_rn(__fdiv_rn(tot4[e], cnt));
    const float fl = k.floors[c];
    const float half = __fadd_rn(fmaxf(__fmul_rn(k.sigma, sd2), fl), k.eps);
    const float gmin = tot3[entries + e], gmax = tot3[entries + gq + e];
    const float l = fmaxf(__fsub_rn(mean2, half),
                          fminf(gmin, __fsub_rn(mean2, fl)));
    const float h = fminf(__fadd_rn(mean2, half),
                          fmaxf(gmax, __fadd_rn(mean2, fl)));
    lo[e] = l;
    hi[e] = h;
    a_min[e] = __fadd_rn(l, glob[ACTR + c]);
    a_max[e] = __fadd_rn(h, glob[ACTR + c]);
  }
  for (int c = threadIdx.x; c < NC; c += THREADS) {
    a_min[gq + c] = 0.0f;
    a_max[gq + c] = 0.0f;
  }
  for (int b = threadIdx.x; b <= groups; b += THREADS)
    any_active[b] = b < groups && tot1[b * QS + NC] > 0.0f;
}

// g: g0 for active particles inside their bin's envelope, else the last
// bin; the block's count of active particles outside it
__global__ void __launch_bounds__(THREADS)
route_kernel(const bool* __restrict__ active, const float* __restrict__ A,
             const float* __restrict__ glob, const float* __restrict__ lo,
             const float* __restrict__ hi, Consts k, int32_t* __restrict__ g,
             int* __restrict__ part, int64_t n) {
  extern __shared__ float smem[];
  const int gq = k.groups * NC;
  float* s_lo = smem;
  float* s_hi = smem + gq;
  __shared__ int warp_n[WARPS];
  for (int e = threadIdx.x; e < gq; e += THREADS) {
    s_lo[e] = lo[e];
    s_hi[e] = hi[e];
  }
  __syncthreads();
  int outliers = 0;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    int gf = k.groups;
    if (active[i]) {
      const int b = g[i];
      float v[QS];
      centred(A, i, glob, v);
      bool out = false;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        out = out || v[c] < s_lo[b * NC + c] || v[c] > s_hi[b * NC + c];
      outliers += out;
      if (!out) gf = b;
    }
    g[i] = gf;
  }
  outliers = (int)__reduce_add_sync(FULL, (unsigned)outliers);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = outliers;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) s += warp_n[w];
    part[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const int* __restrict__ part, int nb, int32_t* __restrict__ n_over) {
  __shared__ int warp_n[WARPS];
  int s = 0;
  for (int b = threadIdx.x; b < nb; b += THREADS) s += part[b];
  s = (int)__reduce_add_sync(FULL, (unsigned)s);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_n[w];
    *n_over = total;
  }
}

int totals(const float* part, int nb, int entries, int n_sum, int n_min,
           float* out, cudaStream_t stream) {
  const int blocks = (int)(((int64_t)entries * 32 + THREADS - 1) / THREADS);
  totals_kernel<<<blocks, THREADS, 0, stream>>>(part, nb, entries, n_sum,
                                                n_min, out);
  return (int)cudaGetLastError();
}

template <typename K>
int allow_smem(K kernel, int64_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// shared memory a block of the largest pass needs for `groups` bins
extern "C" int64_t mcl_group_stats_smem(int groups) {
  return acc_smem(groups, 4);
}

// the current device's per-block opt-in maximum of shared memory
extern "C" int mcl_group_stats_smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return limit;
}

// floats of scratch a call needs
extern "C" int64_t mcl_group_stats_scratch(int64_t n, int groups) {
  return offsets(n, groups).end;
}

extern "C" int mcl_group_stats(
    const float* pos, const float* rmat, const float* rot, const bool* active,
    const float* origin, int32_t* g, float* A, float* a_min, float* a_max,
    bool* any_active, int32_t* n_over, float* scratch, int64_t n, int gy,
    int gp, int gr, float wx, float wy, float wz, float inv_cell,
    float floor_ang, float floor_pos, float trim, float sigma, float eps,
    cudaStream_t stream) {
  if (n <= 0 || gy < 1 || gp < 1 || gr < 1) return (int)cudaErrorInvalidValue;
  Consts k;
  k.gy = gy;
  k.gp = gp;
  k.gr = gr;
  k.groups = gy * gp * gr;
  k.w[0] = wx;
  k.w[1] = wy;
  k.w[2] = wz;
  k.inv_cell = inv_cell;
  // repeat_interleave(w * inv_cell, 3) * floor_ang, then floor_pos
  for (int r = 0; r < 3; ++r) {
    const float wc = k.w[r] * inv_cell;
    for (int c = 0; c < 3; ++c) k.floors[3 * r + c] = wc * floor_ang;
  }
  for (int c = 9; c < NC; ++c) k.floors[c] = floor_pos;
  k.trim = trim;
  k.sigma = sigma;
  k.eps = eps;
  const int G = k.groups, gq = G * NC, entries = G * QS;
  const int nb = blocks_for(n);
  const Offsets o = offsets(n, G);
  float *part = scratch, *glob = scratch + o.glob, *tot1 = scratch + o.tot1,
        *tot2 = scratch + o.tot2, *mean1 = scratch + o.mean1,
        *h1 = scratch + o.h1, *tot3 = scratch + o.tot3,
        *tot4 = scratch + o.tot4, *lo = scratch + o.lo, *hi = scratch + o.hi;
  const int64_t sm_bins = acc_smem(G, 0), sm_var1 = acc_smem(G, 1),
                sm_inl = acc_smem(G, 4), sm_var2 = acc_smem(G, 3);
  int err;
  if ((err = allow_smem(bins_kernel, sm_bins)) ||
      (err = allow_smem(moments_kernel<false, true>, sm_var1)) ||
      (err = allow_smem(moments_kernel<true, false>, sm_inl)) ||
      (err = allow_smem(moments_kernel<true, true>, sm_var2)))
    return err;

  frame_kernel<<<nb, THREADS, 0, stream>>>(pos, rmat, rot, active, origin, k,
                                           A, part, n);
  frame_totals_kernel<<<1, THREADS, 0, stream>>>(part, nb, glob);
  bins_kernel<<<nb, THREADS, sm_bins, stream>>>(rot, active, A, glob, k, g,
                                                 part, n);
  if ((err = totals(part, nb, entries, entries, 0, tot1, stream))) return err;
  moments_kernel<false, true><<<nb, THREADS, sm_var1, stream>>>(
      active, A, g, glob, tot1, nullptr, nullptr, k, part, n);
  if ((err = totals(part, nb, gq, gq, 0, tot2, stream))) return err;
  envelope1_kernel<<<1, THREADS, (gq + 2 * NC + G + 1) * 4, stream>>>(
      tot1, tot2, k, mean1, h1);
  moments_kernel<true, false><<<nb, THREADS, sm_inl, stream>>>(
      active, A, g, glob, nullptr, mean1, h1, k, part, n);
  if ((err = totals(part, nb, entries + 2 * gq, entries, gq, tot3, stream)))
    return err;
  moments_kernel<true, true><<<nb, THREADS, sm_var2, stream>>>(
      active, A, g, glob, tot3, mean1, h1, k, part, n);
  if ((err = totals(part, nb, gq, gq, 0, tot4, stream))) return err;
  envelope2_kernel<<<1, THREADS, 0, stream>>>(tot1, tot3, tot4, glob, k, lo,
                                              hi, a_min, a_max, any_active);
  route_kernel<<<nb, THREADS, 2 * gq * 4, stream>>>(
      active, A, glob, lo, hi, k, g, reinterpret_cast<int*>(part), n);
  count_kernel<<<1, THREADS, 0, stream>>>(reinterpret_cast<const int*>(part),
                                          nb, n_over);
  return (int)cudaGetLastError();
}
