// Lookup microbenchmark kernels for Hopper (sm_90a).
//
// They replace the Pallas kernels of the JAX package's gather experiments
// (tools/exp_gather.py, tools/exp_gather2.py, tools/exp_rowsel_shape.py):
// ten kernel bodies, covered here by four families of templated kernels.
//
//   (a) mcl_row_gather         out[r, l] = tab[r, (idx[r, l] + off) mod W]
//       G1 lane_kernel      tools/exp_gather.py:95  (call :100), f32, W 128
//       G2 wide_kernel      tools/exp_gather.py:128 (call :133), f32, W 512
//       G4 lane_kernel_u8   tools/exp_gather.py:200 (call :205), u8,  W 128
//   (b) mcl_flat_gather        out[q] = tab_flat[(idx[q] + off) mod n]
//       G3 twostage_kernel  tools/exp_gather.py:159 (call :173), n 1024
//       G6 k_fancy          tools/exp_gather2.py:50 (call :56),  n 16384
//       G9 k_rowloop        tools/exp_gather2.py:92 (call :56),  n 16384
//   (c) mcl_col_gather         out[i, j] = tab[g(idx[i, j]), j] or, in the
//       transposed form, tab[g(idx[i, j]), i mod 128]
//       G5 sub_kernel       tools/exp_gather.py:229 (call :234), g = (q + off) mod 128
//       G7 k_sublane        tools/exp_gather2.py:67 (call :56),  g = q >> 7
//       G8 k_transpose      tools/exp_gather2.py:75 (call :56),  g = q >> 7, transposed
//   (d) mcl_rowsel_accumulate  out[t] = sum over 16 passes of tab[row[t], lane[t]]
//       G10 kern            tools/exp_rowsel_shape.py:44 (call :64)
//
// The TPU scripts asked how fast its vector unit retires lookups in each
// formulation.  On Hopper every one of them is an indexed load, so what
// bounds them is device-memory bytes: the indices read once (4 B a query),
// the outputs written once and the table read once.  The designs keep the
// traffic at that:
//
//   * Indices are read as int4 and outputs written as float4 (uchar4 for
//     u8): 16 B a thread, neighbouring threads on neighbouring addresses.
//     The wrappers check 16-byte alignment, except for (d)'s queries: its
//     entry takes the vector path when they are aligned and a scalar one
//     when they are not.
//   * A thread of (b) and the transposed (c) starts its int4 index loads
//     (8 in G6 and G8, 2 in G3, 1 in G9) before it uses any, a thread of
//     G3 its 2 and of G4 its 4 before its share of the table copy, a
//     thread of (d)
//     loads its next group of rows and lanes before it looks up the
//     current one, and the table copies of (a), (b), (d) and the
//     transposed (c) start BATCH 16-byte loads before their stores.  With
//     one load at a time the few resident blocks wait on one memory
//     latency per 16 bytes and cannot keep enough bytes in flight to reach
//     the card's bandwidth.
//   * (a) stages the block's 16 table rows in shared memory with 16-byte
//     loads, so each table byte crosses from device memory once, and
//     gathers from there.  G4's u8 rows are 128 bytes, so its blocks take
//     32 rows (MCL_U8_ROWS; 64 and 128 measured slower), eight threads a
//     row, each thread on four consecutive int4 groups whose 16 u8
//     outputs leave as one 16-byte store (16 rows a block and one int4
//     group at a time kept few bytes in flight and stored 4 bytes at a
//     time; index rows and table rows by two bulk copies on an mbarrier
//     measured no faster).  At W 512 the whole 256 MiB table is read,
//     though the queries touch a quarter of it: a 128-query row touches
//     nearly every 32-byte sector of its 2 KB table row anyway.
//   * (b)'s shared form (G6), (d) and the transposed (c) share one
//     small table among all blocks and copy it into shared memory once per
//     block: up to 72 KB, above the static 48 KB, so the kernel's dynamic
//     shared-memory limit is raised first.  G6 and G10 run one block of
//     768 threads on each SM (the MCL_*_THREADS and MCL_*_PER_SM macros),
//     so the table crosses from L2 132 times, not once per query tile,
//     and a thread starts its first index loads before the copy, so
//     device-memory latency runs under it.  Measured against three blocks
//     of 256 threads an SM (396 copies), one of 1024 and two of 512, this
//     shape was the fastest for both.  G6's blocks walk rounds of 768 * 8
//     int4 groups; equal rounds (no part-full last round) and one
//     contiguous share a block measured no faster.  G9 is G6's function with
//     the table read through L1/L2 by __ldg: with no table to copy it takes
//     (c)'s direct form, one int4 group a thread on a grid sized to the
//     work, so the pair measures each memory in its fastest schedule.  The
//     transposed (c) stays a grid-stride loop over all resident blocks.
//   * G3 (a 4 KB table) is all stream: 4 bytes of index in and 4 of
//     output out a lookup.  It takes (b)'s direct form: one round a block
//     of 256 threads on a grid sized to the work, each thread's 2 int4
//     index groups (MCL_G3_GROUPS; 4 and 8 measured slower) loaded before
//     the block copies the table (16 bytes a thread), so every resident
//     block has its indices in flight at once and no block waits out a
//     ragged last round.  It runs at the speed of a plain device-to-device
//     copy of the same bytes (2.9 TB/s on an H100 SXM at 700 W).
//     A persistent grid-stride form (loads after the copy) measured 7-8%
//     slower, and so did a ring of bulk-copied index tiles on mbarriers
//     (one block an SM of 512 consumers and a producer warp, 4 stages of
//     32 KB, with 16-byte or bulk stores), which stays as a variant
//     (MCL_G3_RING; gather_pairs.py --variants g3_ring g3_ring_bulk).
//   * Shared-memory banks: in (a), (b) and (d) the 32 lanes of a read
//     take random entries, so they fall on random banks and a read costs
//     as many passes as the most distinct words on one bank (3.5 for 32
//     uniform lanes).  The transposed (c), G8: all 32 lanes of a warp read
//     column i mod 128, which in a row-major table is one bank; the table
//     is staged transposed with a padded stride (129), so the lanes'
//     random rows fall on random banks and the stores of the staging copy
//     on distinct ones.
//   * (c), G5 and G7, reads the table through L1 with __ldg, one int4
//     index group a thread on a grid sized to the work: no shared memory,
//     so no table copy, no attribute call and no ragged last round of
//     resident blocks.  A warp's read of 32 random rows touches up to 32
//     128-byte lines, each an L1 hit once the 64 KB table is in L1.  A
//     staged form (the table in shared memory by one bulk copy on an
//     mbarrier, lanes on columns l + 32c so each read hits the 32 banks
//     once, equal shares of rows over the resident blocks) lost or tied
//     at every size from 2^14 to 2^24 lookups; a grid-stride staged form
//     led only near 2^20, where the cold L1 fills of this one cost ~1.5
//     us, a size no caller runs.
//   * (d) keeps the script's tile of S*128 queries (S its tile height) as
//     the unit of work: block b stages the 72 KB table once and walks the
//     tiles b, b + gridDim.x, ..., its threads on the block's groups of
//     four queries in order, so the copy no longer grows as S shrinks.
//     The 16 passes read the table through a volatile pointer, so each
//     pass is a real shared-memory lookup, and add in order from 0.0f
//     with __fadd_rn, as the plain version's loop does: the sum is
//     bit-equal.  A thread keeps its four queries' lookups of a pass in
//     flight together.  What bounds (d) is the lookup rate, not bytes:
//     2^24 lookups at 32 words a clock on each of 132 SMs take ~2 us
//     without bank conflicts and ~3.5 times that with random lanes,
//     against 3.8 us for its 12.7 MB of device memory.
//
// Launch path: what a launch needs from the runtime besides the launch
// itself (the raised shared-memory limit, the blocks that fit on the card)
// is found at a kernel's first launch on a device at one shared-memory
// size and kept (resident_blocks), so a launch is cudaGetDevice, the
// launch and cudaGetLastError.
//
// The block shapes of G3, G4, G6 and G10 and G3's ring are macros, so
// that a copy of this file with other definitions in front builds a
// variant of them (mcl_3dl_tpu_torch/tools/gather_pairs.py --variants).
//
// Index arithmetic wraps like the JAX int32 (and torch int32) arithmetic:
// (idx + off) is computed modulo 2^32 and reduced modulo the power-of-two
// extent with a mask, which equals the floor modulo the plain versions
// use.  (b) and (c) apply the same reduction where the JAX body has none
// (G6, G7, G8, G9); for indices inside the table it changes nothing and
// it keeps every load inside the table.  (d) gives 0.0f for a row outside
// the table, as the JAX body's select does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <mutex>
#include <vector>

#ifndef MCL_FLAT_THREADS
#define MCL_FLAT_THREADS 768    // threads a block of (b)'s shared form
#endif
#ifndef MCL_FLAT_PER_SM
#define MCL_FLAT_PER_SM 1       // most blocks of (b)'s shared form on an SM
#endif
#ifndef MCL_ROWSEL_THREADS
#define MCL_ROWSEL_THREADS 768  // threads a block of (d)
#endif
#ifndef MCL_ROWSEL_PER_SM
#define MCL_ROWSEL_PER_SM 1     // most blocks of (d) on an SM
#endif
#ifndef MCL_G3_GROUPS
#define MCL_G3_GROUPS 2         // int4 index groups a thread of G3
#endif
#ifndef MCL_U8_ROWS
#define MCL_U8_ROWS 32          // table rows a block of G4
#endif
#ifndef MCL_G3_RING
#define MCL_G3_RING 0           // G3 through the ring: 1 16-byte stores, 2 bulk
#endif

namespace {

constexpr int THREADS = 256;    // threads a block of (a), (c), G3 and G9
constexpr int ROWSEL_THREADS = MCL_ROWSEL_THREADS;
constexpr int LANES = 128;
constexpr int GROUPS_PER_ROW = LANES / 4;  // int4 index groups per 128-lane row
constexpr int RG_ROWS = 16;                // table rows staged per block in (a)
constexpr int STATIC_SMEM = 48 * 1024;
constexpr int BATCH = 8;     // loads a thread has in flight before it uses them
constexpr int SMALL_TAB = 16 * 1024;  // (b)'s tables up to this size: G3's shape

__device__ __forceinline__ int wrap(int q, int off, int mask) {
  return (int)(((unsigned)q + (unsigned)off) & (unsigned)mask);
}

// Copy `bytes` from device memory (16-byte aligned) to shared memory.  A
// thread issues BATCH 16-byte loads before it stores any of them, so it
// waits on one memory latency per BATCH loads, not per load; a tail of
// less than 16 bytes goes byte by byte.
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const int n = bytes / 16;
  for (int v0 = threadIdx.x; v0 < n; v0 += BATCH * blockDim.x) {
    uint4 r[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (v0 + k * (int)blockDim.x < n) r[k] = __ldg(s + v0 + k * blockDim.x);
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (v0 + k * (int)blockDim.x < n) d[v0 + k * blockDim.x] = r[k];
  }
  for (int b = n * 16 + (int)threadIdx.x; b < bytes; b += blockDim.x)
    static_cast<unsigned char*>(dst)[b] =
        static_cast<const unsigned char*>(src)[b];
}

// Grid-stride loop over the int4 index groups in rounds of T * B: in each
// round, thread t of block b takes the groups b * T * B + t + k * T
// (k < B) and loads all B before it hands any to f(g, q), for the same
// reason.  `first()` runs once before the loop.  With EARLY the first
// round's loads are issued before it, so that their latency runs under
// what it does (G6's table copy); they then hold B int4 registers through
// it, which only a large table repays.
template <int T, int B, bool EARLY, typename First, typename F>
__device__ __forceinline__ void for_groups(const int* idx, int n_groups,
                                           First&& first, F&& f) {
  const int4* q4 = reinterpret_cast<const int4*>(idx);
  const int step = (int)gridDim.x * T * B;
  int g0 = (int)blockIdx.x * T * B + (int)threadIdx.x;
  int4 q[B];
  auto load = [&](int c) {
#pragma unroll
    for (int k = 0; k < B; ++k)
      if (c + k * T < n_groups) q[k] = __ldg(q4 + c + k * T);
  };
  if (EARLY) load(g0);
  first();
  for (; g0 < n_groups; g0 += step) {
    if (!EARLY) load(g0);
#pragma unroll
    for (int k = 0; k < B; ++k)
      if (g0 + k * T < n_groups) f(g0 + k * T, q[k]);
    if (EARLY) load(g0 + step);
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// ---- (a) row gather: G1, G2
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const T* __restrict__ tab, const int* __restrict__ idx,
                  T* __restrict__ out, int rows, int off) {
  __shared__ __align__(16) T rows_s[RG_ROWS * W];
  const int r0 = blockIdx.x * RG_ROWS;
  const int nr = min(RG_ROWS, rows - r0);
  stage(rows_s, tab + (size_t)r0 * W, nr * W * (int)sizeof(T));
  __syncthreads();
  const int4* q4 = reinterpret_cast<const int4*>(idx + (size_t)r0 * LANES);
  T* o = out + (size_t)r0 * LANES;
  for (int g = threadIdx.x; g < nr * GROUPS_PER_ROW; g += THREADS) {
    const int4 q = __ldg(q4 + g);
    const T* row = rows_s + (g / GROUPS_PER_ROW) * W;
    store4(o + 4 * g, row[wrap(q.x, off, W - 1)], row[wrap(q.y, off, W - 1)],
           row[wrap(q.z, off, W - 1)], row[wrap(q.w, off, W - 1)]);
  }
}

// ---- (a) for u8 tables of 128 lanes: G4
// Eight threads a row, each on four consecutive int4 index groups (16
// lanes), ROWS rows a block.  A thread issues all its index loads, then
// its share of the block's table copy, before it waits on any of them;
// it packs its 16 u8 lookups into one 16-byte store.
template <int ROWS>
__global__ void __launch_bounds__(THREADS)
u8_row_gather_kernel(const uint8_t* __restrict__ tab,
                     const int* __restrict__ idx, uint8_t* __restrict__ out,
                     int rows, int off) {
  constexpr int PASS = THREADS / 8;   // rows a pass of the block
  constexpr int P = ROWS / PASS;      // passes
  static_assert(ROWS % PASS == 0, "MCL_U8_ROWS must be a multiple of 32");
  __shared__ __align__(16) uint8_t rows_s[ROWS * LANES];
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, rows - r0);
  const int sub = threadIdx.x & 7, rr = threadIdx.x >> 3;
  int4 q[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int r = rr + p * PASS;
    if (r < nr) {
      const int4* q4 = reinterpret_cast<const int4*>(
                           idx + (size_t)(r0 + r) * LANES) + 4 * sub;
#pragma unroll
      for (int k = 0; k < 4; ++k) q[p][k] = __ldg(q4 + k);
    }
  }
  stage(rows_s, tab + (size_t)r0 * LANES, nr * LANES);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int r = rr + p * PASS;
    if (r >= nr) continue;
    const uint8_t* row = rows_s + r * LANES;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 g = q[p][k];
      w[k] = (uint32_t)row[wrap(g.x, off, LANES - 1)] |
             (uint32_t)row[wrap(g.y, off, LANES - 1)] << 8 |
             (uint32_t)row[wrap(g.z, off, LANES - 1)] << 16 |
             (uint32_t)row[wrap(g.w, off, LANES - 1)] << 24;
    }
    *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * LANES + 16 * sub) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---- (b) flat gather: G3, G6 (table in shared memory), G9 (through L2)
template <bool SHARED>
__device__ __forceinline__ float flat_load(const float* t, int i) {
  return SHARED ? t[i] : __ldg(t + i);
}

// G3 and G6 copy the table into shared memory under their first index
// loads, G9 reads it through L1/L2; G3 and G9 run one round a block (a
// grid sized to the work), G6 as many as its resident blocks need.
template <bool SHARED, int T, int B, bool EARLY>
__global__ void __launch_bounds__(T)
flat_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                   float* __restrict__ out, int n_tab, int n_groups, int off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* t = SHARED ? reinterpret_cast<const float*>(smem) : tab;
  const int m = n_tab - 1;
  for_groups<T, B, EARLY>(
      idx, n_groups,
      [&] {
        if (SHARED) {
          stage(smem, tab, n_tab * 4);
          __syncthreads();
        }
      },
      [&](int g, int4 q) {
        store4(out + 4 * (size_t)g, flat_load<SHARED>(t, wrap(q.x, off, m)),
               flat_load<SHARED>(t, wrap(q.y, off, m)),
               flat_load<SHARED>(t, wrap(q.z, off, m)),
               flat_load<SHARED>(t, wrap(q.w, off, m)));
      });
}

#if MCL_G3_RING
// ---- (b) G3 through a ring of bulk-copied index tiles (a variant kept to
// re-measure the design; the direct form above is faster)
// One block an SM: RING_THREADS consumers and a producer warp.  Lane 0 of
// the producer copies the block's index tiles (tile b, b + gridDim.x, ...)
// into a ring of RING_STAGES stages of shared memory, each by one
// cp.async.bulk that completes on the stage's `full` mbarrier, and waits on
// the stage's `empty` mbarrier before it fills a stage again.  The
// consumers copy the table while the first tiles are in flight, then look
// up each tile's indices from shared memory.  STORE 1: each consumer
// writes its four outputs as one 16-byte store and arrives on `empty`;
// STORE 2: the outputs overwrite their indices in the stage and one
// consumer writes the tile out by a bulk copy, waits until the copy has
// read the stage, and arrives.  A last tile shorter than RING_GROUPS is
// copied at its own length.
constexpr int RING_THREADS = 512;   // consumer threads a block
constexpr int RING_STAGES = 4;
constexpr int RING_GROUPS = 2048;   // int4 index groups a stage (32 KB)
constexpr int RING_HEAD = 128;      // bytes in front of the stages: barriers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(smem_u32(b))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of barrier `b` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
}

template <int STORE>
__global__ void __launch_bounds__(RING_THREADS + 32)
ring_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                   float* __restrict__ out, int n_tab, int n_groups, int off) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + RING_STAGES;
  int4* ring = reinterpret_cast<int4*>(smem + RING_HEAD);
  float* t = reinterpret_cast<float*>(ring + RING_STAGES * RING_GROUPS);
  const int n_tiles = (n_groups + RING_GROUPS - 1) / RING_GROUPS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, STORE == 1 ? RING_THREADS : 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= RING_THREADS) {  // the producer warp
    if (threadIdx.x == RING_THREADS) {
      int k = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
        const int s = k % RING_STAGES;
        if (k >= RING_STAGES) mbar_wait(empty + s, (k / RING_STAGES - 1) & 1);
        const int g0 = tile * RING_GROUPS;
        const unsigned bytes = 16u * (unsigned)min(RING_GROUPS, n_groups - g0);
        mbar_expect_tx(full + s, bytes);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_u32(ring + s * RING_GROUPS)),
            "l"(idx + 4 * (size_t)g0), "r"(bytes), "r"(smem_u32(full + s))
            : "memory");
      }
    }
    return;
  }
  // the table, while the first tiles are in flight (consumers only)
  const int nv = n_tab / 4;
  for (int v = threadIdx.x; v < nv; v += RING_THREADS)
    reinterpret_cast<float4*>(t)[v] =
        __ldg(reinterpret_cast<const float4*>(tab) + v);
  for (int i = 4 * nv + threadIdx.x; i < n_tab; i += RING_THREADS)
    t[i] = __ldg(tab + i);
  asm volatile("bar.sync 1, %0;" ::"n"(RING_THREADS) : "memory");
  const int m = n_tab - 1;
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int s = k % RING_STAGES;
    mbar_wait(full + s, (k / RING_STAGES) & 1);
    const int g0 = tile * RING_GROUPS;
    const int n = min(RING_GROUPS, n_groups - g0);
    int4* q4 = ring + s * RING_GROUPS;
    for (int j = threadIdx.x; j < n; j += RING_THREADS) {
      const int4 q = q4[j];
      const float4 v = make_float4(t[wrap(q.x, off, m)], t[wrap(q.y, off, m)],
                                   t[wrap(q.z, off, m)], t[wrap(q.w, off, m)]);
      if (STORE == 1)
        *reinterpret_cast<float4*>(out + 4 * (size_t)(g0 + j)) = v;
      else
        reinterpret_cast<float4*>(q4)[j] = v;
    }
    if (STORE == 1) {
      mbar_arrive(empty + s);
      continue;
    }
    // the stage's generic writes, visible to the bulk copy's async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(RING_THREADS) : "memory");
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              out + 4 * (size_t)g0),
          "r"(smem_u32(q4)), "r"(16u * (unsigned)n)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      mbar_arrive(empty + s);
    }
  }
}
#endif  // MCL_G3_RING

// ---- (c) column gather: G5 (MODE 0), G7 (MODE 1)
template <int MODE>
__device__ __forceinline__ int col_row(int q, int off, int m) {
  return MODE == 0 ? wrap(q, off, m) : ((q >> 7) & m);
}

// One int4 index group a thread on a grid sized to the work, the table
// read through L1.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
col_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                  float* __restrict__ out, int tab_rows, int n_groups,
                  int off) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_groups) return;
  const int4 q = __ldg(reinterpret_cast<const int4*>(idx) + g);
  const float* t = tab + 4 * (g % GROUPS_PER_ROW);
  const int m = tab_rows - 1;
  store4(out + 4 * (size_t)g, __ldg(t + col_row<MODE>(q.x, off, m) * LANES),
         __ldg(t + col_row<MODE>(q.y, off, m) * LANES + 1),
         __ldg(t + col_row<MODE>(q.z, off, m) * LANES + 2),
         __ldg(t + col_row<MODE>(q.w, off, m) * LANES + 3));
}

// ---- (c) transposed: G8
__global__ void __launch_bounds__(THREADS)
transpose_gather_kernel(const float* __restrict__ tab,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int tab_rows, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* t = reinterpret_cast<float*>(smem);
  const int stride = tab_rows + 1;           // transposed, padded
  const int n = tab_rows * LANES;
  for (int e0 = threadIdx.x; e0 < n; e0 += BATCH * THREADS) {
    float r[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (e0 + k * THREADS < n) r[k] = __ldg(tab + e0 + k * THREADS);
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * THREADS;
      if (e < n) t[(e % LANES) * stride + e / LANES] = r[k];
    }
  }
  __syncthreads();
  const int m = tab_rows - 1;
  for_groups<THREADS, BATCH, false>(idx, n_groups, [] {}, [&](int g, int4 q) {
    float v[4];
    const int qs[4] = {q.x, q.y, q.z, q.w};
    const float* col = t + (g / GROUPS_PER_ROW % LANES) * stride;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = col[col_row<1>(qs[k], 0, m)];
    store4(out + 4 * (size_t)g, v[0], v[1], v[2], v[3]);
  });
}

// ---- (d) row-select accumulate: G10

// The block's j-th group of four queries: the block takes the tiles
// blockIdx.x, + gridDim.x, ... of `per_block` queries, each `gpt` groups.
// Returns how many of the group's queries exist (0 past the block's work)
// and sets *q to the first.
__device__ __forceinline__ int rowsel_group(int j, int gpt, long long n_tiles,
                                            int per_block, int nq,
                                            long long* q) {
  const int i = j / gpt;
  const long long tile = blockIdx.x + (long long)i * gridDim.x;
  if (tile >= n_tiles) return 0;
  *q = tile * per_block + 4LL * (j - i * gpt);
  const long long left = ((tile + 1) * per_block < nq ? (tile + 1) * per_block
                                                      : (long long)nq) - *q;
  return left <= 0 ? 0 : left >= 4 ? 4 : (int)left;
}

// The `n` values p[q], ... as one int4 where VEC allows it (the group is
// whole and, as the entry checked, 16-byte aligned), else one by one.
template <bool VEC>
__device__ __forceinline__ int4 load_group(const int* p, long long q, int n) {
  if (VEC && n == 4) return __ldg(reinterpret_cast<const int4*>(p + q));
  int4 v = make_int4(0, 0, 0, 0);
  if (n > 0) v.x = __ldg(p + q);
  if (n > 1) v.y = __ldg(p + q + 1);
  if (n > 2) v.z = __ldg(p + q + 2);
  if (n > 3) v.w = __ldg(p + q + 3);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(ROWSEL_THREADS)
rowsel_kernel(const float* __restrict__ tab, const int* __restrict__ rows,
              const int* __restrict__ lanes, float* __restrict__ out,
              int tab_rows, int nq, int passes, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gpt = (per_block + 3) / 4;
  const long long n_tiles = ((long long)nq + per_block - 1) / per_block;
  int j = threadIdx.x;
  long long q = 0;
  int n = rowsel_group(j, gpt, n_tiles, per_block, nq, &q);
  int4 r = load_group<VEC>(rows, q, n), l = load_group<VEC>(lanes, q, n);
  stage(smem, tab, tab_rows * LANES * 4);
  __syncthreads();
  const volatile float* t = reinterpret_cast<const volatile float*>(smem);
  // groups come in order, so the first empty one ends the thread's work
  while (n > 0) {
    long long qn = 0;
    const int nn = rowsel_group(j + ROWSEL_THREADS, gpt, n_tiles, per_block,
                                nq, &qn);
    const int4 rn = load_group<VEC>(rows, qn, nn);
    const int4 ln = load_group<VEC>(lanes, qn, nn);
    const int rr[4] = {r.x, r.y, r.z, r.w}, ll[4] = {l.x, l.y, l.z, l.w};
    int a[4];
    bool hit[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      hit[k] = k < n && (unsigned)rr[k] < (unsigned)tab_rows;
      a[k] = rr[k] * LANES + (ll[k] & (LANES - 1));
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = 0; p < passes; ++p) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = hit[k] ? t[a[k]] : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
    }
    if (VEC && n == 4) {
      store4(out + q, acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) out[q + k] = acc[k];
    }
    r = rn;
    l = ln;
    q = qn;
    n = nn;
    j += ROWSEL_THREADS;
  }
}

// What a launch of one kernel needs on one device at one dynamic
// shared-memory size: how many of its blocks fit on the card at once.
struct LaunchFact {
  const void* fn;
  int dev, smem, resident;
};
std::mutex facts_mu;
std::vector<LaunchFact> facts;

// Blocks of `fn` (`threads` a block, `smem` bytes of dynamic shared memory)
// that fit on the current device at once, at most `per_sm_max` on an SM.
// The first call for a (kernel, device, size) raises the kernel's dynamic
// shared-memory limit where the size needs it (the limit only grows) and
// asks the runtime; later calls find the answer kept (`per_sm_max` is a
// constant of each kernel).  A refused request leaves no error behind for
// the next launch's cudaGetLastError().
cudaError_t resident_blocks(const void* fn, int threads, int smem,
                            int per_sm_max, int* resident) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(facts_mu);
  int limit = STATIC_SMEM;
  for (const LaunchFact& f : facts) {
    if (f.fn != fn || f.dev != dev) continue;
    if (f.smem == smem) {
      *resident = f.resident;
      return cudaSuccess;
    }
    limit = std::max(limit, f.smem);
  }
  int sms = 0, per_sm = 0;
  if (smem > limit)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  *resident = sms * std::min(per_sm, per_sm_max);
  facts.push_back({fn, dev, smem, *resident});
  return cudaSuccess;
}

// Blocks of a kernel that loops over its work: as many as fit on the card
// at once (at most `per_sm_max` on an SM), no more than `want`.
cudaError_t grid_for(const void* fn, int threads, int smem, int per_sm_max,
                     long long want, int* blocks) {
  int resident = 0;
  const cudaError_t e =
      resident_blocks(fn, threads, smem, per_sm_max, &resident);
  *blocks = (int)std::max(1LL, std::min(want, (long long)resident));
  return e;
}

}  // namespace

extern "C" int mcl_row_gather(const void* tab, const int* idx, void* out,
                              int rows, int width, int elem_bytes, int off,
                              cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  const int blocks = (rows + RG_ROWS - 1) / RG_ROWS;
#define MCL_ROW_GATHER(T, W)                                              \
  row_gather_kernel<T, W><<<blocks, THREADS, 0, stream>>>(                \
      static_cast<const T*>(tab), idx, static_cast<T*>(out), rows, off)
  if (elem_bytes == 4 && width == 128) MCL_ROW_GATHER(float, 128);
  else if (elem_bytes == 4 && width == 512) MCL_ROW_GATHER(float, 512);
  else if (elem_bytes == 1 && width == 128) {
    const int u8_blocks = (rows + MCL_U8_ROWS - 1) / MCL_U8_ROWS;
    const uint8_t* t8 = static_cast<const uint8_t*>(tab);
    uint8_t* o8 = static_cast<uint8_t*>(out);
    u8_row_gather_kernel<MCL_U8_ROWS>
        <<<u8_blocks, THREADS, 0, stream>>>(t8, idx, o8, rows, off);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef MCL_ROW_GATHER
  return (int)cudaGetLastError();
}

extern "C" int mcl_flat_gather(const float* tab, const int* idx, float* out,
                               int n_tab, int n_out, int off, int shared,
                               cudaStream_t stream) {
  const int n = n_out / 4;
  if (n == 0) return (int)cudaSuccess;
  if (!shared) {             // G9: a group a thread, a grid sized to the work
    flat_gather_kernel<false, THREADS, 1, false>
        <<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
            tab, idx, out, n_tab, n, off);
    return (int)cudaGetLastError();
  }
  const int smem = n_tab * 4;
  int blocks = 0;
  cudaError_t e;
  if (smem <= SMALL_TAB) {
#if MCL_G3_RING
    const int rsmem = RING_HEAD + RING_STAGES * RING_GROUPS * 16 +
                      ((smem + 15) & ~15);
    e = grid_for((const void*)ring_gather_kernel<MCL_G3_RING>,
                 RING_THREADS + 32, rsmem, 1,
                 (n + RING_GROUPS - 1) / RING_GROUPS, &blocks);
    if (e != cudaSuccess) return (int)e;
    ring_gather_kernel<MCL_G3_RING><<<blocks, RING_THREADS + 32, rsmem,
                                      stream>>>(tab, idx, out, n_tab, n, off);
#else
    // G3: a table too small to repay a persistent block its copy; one
    // round a block on a grid sized to the work, each thread's index
    // loads issued before the block copies the table
    constexpr int B = MCL_G3_GROUPS;
    flat_gather_kernel<true, THREADS, B, true>
        <<<(n + THREADS * B - 1) / (THREADS * B), THREADS, smem, stream>>>(
            tab, idx, out, n_tab, n, off);
#endif
  } else {
    constexpr int T = MCL_FLAT_THREADS, B = BATCH;
    e = grid_for((const void*)flat_gather_kernel<true, T, B, true>, T, smem,
                 MCL_FLAT_PER_SM, (n + T * B - 1) / (T * B), &blocks);
    if (e != cudaSuccess) return (int)e;
    flat_gather_kernel<true, T, B, true><<<blocks, T, smem, stream>>>(
        tab, idx, out, n_tab, n, off);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcl_col_gather(const float* tab, const int* idx, float* out,
                              int tab_rows, int n_out, int off, int mode,
                              cudaStream_t stream) {
  const int n_groups = n_out / 4;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  cudaError_t e;
  if (mode == 2) {
    const int smem = (tab_rows + 1) * LANES * 4;
    int blocks = 0;
    e = grid_for((const void*)transpose_gather_kernel, THREADS, smem, INT_MAX,
                 (n_groups + THREADS * BATCH - 1) / (THREADS * BATCH), &blocks);
    if (e != cudaSuccess) return (int)e;
    transpose_gather_kernel<<<blocks, THREADS, smem, stream>>>(
        tab, idx, out, tab_rows, n_groups);
  } else {
    const int blocks = (n_groups + THREADS - 1) / THREADS;
    if (mode == 0)
      col_gather_kernel<0><<<blocks, THREADS, 0, stream>>>(
          tab, idx, out, tab_rows, n_groups, off);
    else
      col_gather_kernel<1><<<blocks, THREADS, 0, stream>>>(
          tab, idx, out, tab_rows, n_groups, off);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcl_rowsel_accumulate(const float* tab, const int* rows,
                                     const int* lanes, float* out,
                                     int tab_rows, int nq, int passes,
                                     int per_block, cudaStream_t stream) {
  if (nq < 0 || per_block < 1) return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  const int smem = tab_rows * LANES * 4;
  const long long tiles = ((long long)nq + per_block - 1) / per_block;
  // whole groups of four queries start on 16-byte boundaries
  const bool vec = per_block % 4 == 0 &&
                   (((uintptr_t)rows | (uintptr_t)lanes | (uintptr_t)out) &
                    15) == 0;
  const void* fn = vec ? (const void*)rowsel_kernel<true>
                       : (const void*)rowsel_kernel<false>;
  int blocks = 0;
  const cudaError_t e = grid_for(fn, ROWSEL_THREADS, smem, MCL_ROWSEL_PER_SM,
                                 tiles, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (vec)
    rowsel_kernel<true><<<blocks, ROWSEL_THREADS, smem, stream>>>(
        tab, rows, lanes, out, tab_rows, nq, passes, per_block);
  else
    rowsel_kernel<false><<<blocks, ROWSEL_THREADS, smem, stream>>>(
        tab, rows, lanes, out, tab_rows, nq, passes, per_block);
  return (int)cudaGetLastError();
}
