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
//     (8 in G3, G6 and G8, 1 in G9) before it uses any, a thread of (d)
//     loads its next group of rows and lanes before it looks up the
//     current one, and the table copies of (a), (b), (d) and the
//     transposed (c) start BATCH 16-byte loads before their stores.  With
//     one load at a time the few resident blocks wait on one memory
//     latency per 16 bytes and cannot keep enough bytes in flight to reach
//     the card's bandwidth.
//   * (a) stages the block's 16 table rows in shared memory with 16-byte
//     loads, so each table byte crosses from device memory once, and
//     gathers from there.  At W 512 the whole 256 MiB table is read,
//     though the queries touch a quarter of it: a 128-query row touches
//     nearly every 32-byte sector of its 2 KB table row anyway.
//   * (b)'s shared form (G3, G6), (d) and the transposed (c) share one
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
//     contiguous share a block measured no faster.  G3's 4 KB table costs
//     nothing to copy, so it keeps blocks of 256 threads, as many as fit,
//     and loads after the copy (early loads would hold 8 int4 registers
//     through it and cut the resident blocks).  G9 is G6's function with
//     the table read through L1/L2 by __ldg: with no table to copy it takes
//     (c)'s direct form, one int4 group a thread on a grid sized to the
//     work, so the pair measures each memory in its fastest schedule.  The
//     transposed (c) stays a grid-stride loop over all resident blocks.
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
// The block shapes of G6 and G10 are macros, so that a copy of this file
// with other definitions in front builds a variant of them
// (mcl_3dl_tpu_torch/tools/gather_pairs.py --variants).
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

// Copy `bytes` (a multiple of 16) from device memory to shared memory.  A
// thread issues BATCH 16-byte loads before it stores any of them, so it
// waits on one memory latency per BATCH loads, not per load.
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

__device__ __forceinline__ void store4(uint8_t* p, uint8_t a, uint8_t b,
                                       uint8_t c, uint8_t d) {
  *reinterpret_cast<uchar4*>(p) = make_uchar4(a, b, c, d);
}

// ---- (a) row gather: G1, G2, G4
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

// ---- (b) flat gather: G3, G6 (table in shared memory), G9 (through L2)
template <bool SHARED>
__device__ __forceinline__ float flat_load(const float* t, int i) {
  return SHARED ? t[i] : __ldg(t + i);
}

// G3 and G6 copy the table into shared memory first (G6 under its first
// index loads), G9 reads it through L1/L2; G9 runs one round a block (a
// grid sized to the work), G3 and G6 as many as their resident blocks need.
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
  const int blocks = (rows + RG_ROWS - 1) / RG_ROWS;
#define MCL_ROW_GATHER(T, W)                                              \
  row_gather_kernel<T, W><<<blocks, THREADS, 0, stream>>>(                \
      static_cast<const T*>(tab), idx, static_cast<T*>(out), rows, off)
  if (elem_bytes == 4 && width == 128) MCL_ROW_GATHER(float, 128);
  else if (elem_bytes == 4 && width == 512) MCL_ROW_GATHER(float, 512);
  else if (elem_bytes == 1 && width == 128) MCL_ROW_GATHER(uint8_t, 128);
  else return (int)cudaErrorInvalidValue;
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
    // G3: a table too small to repay one block an SM; as many blocks of
    // THREADS as fit, BATCH groups a thread
    constexpr int B = BATCH;
    e = grid_for((const void*)flat_gather_kernel<true, THREADS, B, false>,
                 THREADS, smem, INT_MAX, (n + THREADS * B - 1) / (THREADS * B),
                 &blocks);
    if (e != cudaSuccess) return (int)e;
    flat_gather_kernel<true, THREADS, B, false>
        <<<blocks, THREADS, smem, stream>>>(tab, idx, out, n_tab, n, off);
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
