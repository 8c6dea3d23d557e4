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
//     The wrappers check 16-byte alignment.
//   * A thread of a grid-stride loop ((b), (d), the transposed (c))
//     issues BATCH 8 index loads before it uses any, and the table copies
//     of (a), (b), (d) and the transposed (c) issue BATCH 16-byte loads
//     before their stores.  With one load at a time the few resident
//     blocks wait on one memory latency per 16 bytes and cannot keep
//     enough bytes in flight to reach the card's bandwidth.
//   * (a) stages the block's 16 table rows in shared memory with 16-byte
//     loads, so each table byte crosses from device memory once, and
//     gathers from there.  At W 512 the whole 256 MiB table is read,
//     though the queries touch a quarter of it: a 128-query row touches
//     nearly every 32-byte sector of its 2 KB table row anyway.
//   * (b), (d) and the transposed (c) share one small table among all
//     blocks and copy it into shared memory once per block: up to 72 KB,
//     above the static 48 KB, so the kernel's dynamic shared-memory limit
//     is raised first.  (b) and the transposed (c) are grid-stride loops
//     over as many blocks as fit on the card at once, so the copy is paid
//     ~400 times, not once per query tile.  G9 is the same function as
//     G6; its kernel reads the table through L1/L2 with __ldg instead, so
//     the pair measures shared memory against the cache for a 64 KB table.
//   * Shared-memory banks: in (a), (b) and (d) the 32 lanes of a read
//     take random entries, so they fall on random banks and a read costs
//     as many passes as the most lanes on one bank (about 3.5 for 32
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
//   * (d) runs S*128 queries per block (the script's tile height S); each
//     block stages the whole 72 KB table, so small S pays the copy many
//     times: that is what the S sweep measures on this card.  The 16
//     passes read the table through a volatile pointer, so each pass is a
//     real shared-memory lookup, and add in order from 0.0f with
//     __fadd_rn, as the plain version's loop does: the sum is bit-equal.
//
// Launch path: what a launch needs from the runtime besides the launch
// itself (the raised shared-memory limit, the blocks that fit on the card)
// is found at a kernel's first launch on a device at one shared-memory
// size and kept (resident_blocks), so a launch is cudaGetDevice, the
// launch and cudaGetLastError.
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
#include <mutex>
#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 128;
constexpr int GROUPS_PER_ROW = LANES / 4;  // int4 index groups per 128-lane row
constexpr int RG_ROWS = 16;                // table rows staged per block in (a)
constexpr int STATIC_SMEM = 48 * 1024;
constexpr int BATCH = 8;     // loads a thread has in flight before it uses them

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

// Grid-stride loop over the int4 index groups; each thread loads BATCH
// groups before it hands any to f(g, q), for the same reason.
template <typename F>
__device__ __forceinline__ void for_groups(const int* idx, int n_groups,
                                           F&& f) {
  const int4* q4 = reinterpret_cast<const int4*>(idx);
  for (int g0 = blockIdx.x * THREADS * BATCH + threadIdx.x; g0 < n_groups;
       g0 += gridDim.x * THREADS * BATCH) {
    int4 q[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (g0 + k * THREADS < n_groups) q[k] = __ldg(q4 + g0 + k * THREADS);
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (g0 + k * THREADS < n_groups) f(g0 + k * THREADS, q[k]);
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

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
flat_gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                   float* __restrict__ out, int n_tab, int n_groups, int off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* t = tab;
  if (SHARED) {
    stage(smem, tab, n_tab * 4);
    __syncthreads();
    t = reinterpret_cast<const float*>(smem);
  }
  const int m = n_tab - 1;
  for_groups(idx, n_groups, [&](int g, int4 q) {
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
  for_groups(idx, n_groups, [&](int g, int4 q) {
    float v[4];
    const int qs[4] = {q.x, q.y, q.z, q.w};
    const float* col = t + (g / GROUPS_PER_ROW % LANES) * stride;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = col[col_row<1>(qs[k], 0, m)];
    store4(out + 4 * (size_t)g, v[0], v[1], v[2], v[3]);
  });
}

// ---- (d) row-select accumulate: G10
__global__ void __launch_bounds__(THREADS)
rowsel_kernel(const float* __restrict__ tab, const int* __restrict__ rows,
              const int* __restrict__ lanes, float* __restrict__ out,
              int tab_rows, int nq, int passes, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  stage(smem, tab, tab_rows * LANES * 4);
  __syncthreads();
  const volatile float* t = reinterpret_cast<const volatile float*>(smem);
  const int q1 = min(nq, ((int)blockIdx.x + 1) * per_block);
  for (int q0 = (int)blockIdx.x * per_block + threadIdx.x; q0 < q1;
       q0 += BATCH * THREADS) {
    int a[BATCH];
    bool hit[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int q = q0 + k * THREADS;
      if (q < q1) {
        const int r = __ldg(rows + q);
        hit[k] = (unsigned)r < (unsigned)tab_rows;
        a[k] = r * LANES + (__ldg(lanes + q) & (LANES - 1));
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int q = q0 + k * THREADS;
      if (q < q1) {
        float acc = 0.0f;
        for (int p = 0; p < passes; ++p)
          acc = __fadd_rn(acc, hit[k] ? t[a[k]] : 0.0f);
        out[q] = acc;
      }
    }
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
// that fit on the current device at once.  The first call for a (kernel,
// device, size) raises the kernel's dynamic shared-memory limit where the
// size needs it (the limit only grows) and asks the runtime; later calls
// find the answer kept.  A refused request leaves no error behind for the
// next launch's cudaGetLastError().
cudaError_t resident_blocks(const void* fn, int threads, int smem,
                            int* resident) {
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
  facts.push_back({fn, dev, smem, sms * per_sm});
  *resident = sms * per_sm;
  return cudaSuccess;
}

// Blocks of a grid-stride kernel: as many as fit on the card at once, no
// more than the work needs.
cudaError_t grid_for(const void* fn, int smem, int n_groups, int* blocks) {
  int resident = 0;
  const cudaError_t e = resident_blocks(fn, THREADS, smem, &resident);
  const int per_block = THREADS * BATCH;
  *blocks = std::max(1, std::min((n_groups + per_block - 1) / per_block,
                                 resident));
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
  const int n_groups = n_out / 4;
  int blocks = 0;
  cudaError_t e;
  if (shared) {
    const int smem = n_tab * 4;
    e = grid_for((const void*)flat_gather_kernel<true>, smem, n_groups,
                 &blocks);
    if (e != cudaSuccess) return (int)e;
    flat_gather_kernel<true><<<blocks, THREADS, smem, stream>>>(
        tab, idx, out, n_tab, n_groups, off);
  } else {
    e = grid_for((const void*)flat_gather_kernel<false>, 0, n_groups,
                 &blocks);
    if (e != cudaSuccess) return (int)e;
    flat_gather_kernel<false><<<blocks, THREADS, 0, stream>>>(
        tab, idx, out, n_tab, n_groups, off);
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
    e = grid_for((const void*)transpose_gather_kernel, smem, n_groups,
                 &blocks);
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
  const int smem = tab_rows * LANES * 4;
  int resident = 0;
  const cudaError_t e =
      resident_blocks((const void*)rowsel_kernel, THREADS, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (nq + per_block - 1) / per_block;
  rowsel_kernel<<<blocks, THREADS, smem, stream>>>(
      tab, rows, lanes, out, tab_rows, nq, passes, per_block);
  return (int)cudaGetLastError();
}
