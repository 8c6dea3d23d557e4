// Per-point box scorer for Hopper (sm_90a).
//
// K3 mcl_local_score replaces mcl_3dl_tpu/ops/local_gather.py::_score_kernel,
// the likelihood model's tier-1 fallback: per scan point k a 32x32x16-cell
// f32 distance table (tables [K, 128*128]) and per particle one flat cell
// index (lidx [K, N]).  Per (k, n): d = tables[k][lidx[k, n]], then the
// reference's clamp, flat floor and match count, summed over k in order
// for each particle, so the f32 sums are bit-equal to the plain version.
//
// Bound on the H100: device-memory bytes, the 4 B index per (k, n)
// (403 MB of 417 at 1M x 96); the 6.3 MB of tables stay in L2.  The entry
// picks one of three forms by shape and alignment:
//   * vec4 (N >= SMALL_N, lidx 16-byte aligned, N % 4 == 0): a thread
//     scores 4 particles, one 16-byte streaming load (evict-first) of
//     lidx[k, 4i:4i+4] a point; K unrolled by UNROLL with the index loads
//     issued before their table loads, so each thread keeps UNROLL * 16 B
//     of the stream in flight; one round of blocks over the grid;
//   * scalar (N >= SMALL_N otherwise): the same with one particle a
//     thread and 4-byte loads;
//   * tiled (N < SMALL_N, where a block of 256 or 1024 particles leaves
//     most SMs idle): a block takes TILE_P particles and spreads their
//     (k, n) loads over its 256 threads into a shared tile of up to
//     TILE_K points, then one thread a particle sums the tile in k order,
//     so the latency is one index load and one table load, not K of each.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;
constexpr int SMALL_N = 1 << 17;
constexpr int TILE_P = 32;                  // particles of a tiled block
constexpr int TILE_K = 128;                 // points a tiled block stages
constexpr int TILE_ROWS = THREADS / TILE_P; // point rows loaded at once

struct Score {
  float mdm, mdf, mw;
};

// one point's term: the clamp, flat floor and match count
__device__ __forceinline__ void add(float d, const Score& s, float& acc,
                                    float& mac) {
  if (d <= s.mdm) {
    const float contrib =
        fmaxf(__fmul_rn(s.mw, __fsub_rn(s.mdm, fmaxf(d, s.mdf))), 0.0f);
    acc = __fadd_rn(acc, contrib);
    mac = __fadd_rn(mac, 1.0f);
  }
}

__global__ void __launch_bounds__(THREADS)
local_score_vec4(const float* __restrict__ tables,
                 const int4* __restrict__ lidx4, float4* __restrict__ score4,
                 float4* __restrict__ match4, int n4, int kk, int tab_len,
                 Score s) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  const int4* col = lidx4 + i;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, mac[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int k = 0;
  for (; k + UNROLL <= kk; k += UNROLL) {
    int4 li[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      li[u] = __ldcs(col + (size_t)(k + u) * n4);
    float d[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float* t = tables + (size_t)(k + u) * tab_len;
      d[u][0] = __ldg(t + li[u].x);
      d[u][1] = __ldg(t + li[u].y);
      d[u][2] = __ldg(t + li[u].z);
      d[u][3] = __ldg(t + li[u].w);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) add(d[u][j], s, acc[j], mac[j]);
  }
  for (; k < kk; ++k) {
    const int4 li = __ldcs(col + (size_t)k * n4);
    const float* t = tables + (size_t)k * tab_len;
    add(__ldg(t + li.x), s, acc[0], mac[0]);
    add(__ldg(t + li.y), s, acc[1], mac[1]);
    add(__ldg(t + li.z), s, acc[2], mac[2]);
    add(__ldg(t + li.w), s, acc[3], mac[3]);
  }
  score4[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  match4[i] = make_float4(mac[0], mac[1], mac[2], mac[3]);
}

__global__ void __launch_bounds__(THREADS)
local_score_scalar(const float* __restrict__ tables,
                   const int* __restrict__ lidx, float* __restrict__ score,
                   float* __restrict__ match, int n, int kk, int tab_len,
                   Score s) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int* col = lidx + i;
  float acc = 0.0f, mac = 0.0f;
  int k = 0;
  for (; k + UNROLL <= kk; k += UNROLL) {
    int li[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) li[u] = __ldcs(col + (size_t)(k + u) * n);
    float d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      d[u] = __ldg(tables + (size_t)(k + u) * tab_len + li[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add(d[u], s, acc, mac);
  }
  for (; k < kk; ++k)
    add(__ldg(tables + (size_t)k * tab_len + __ldcs(col + (size_t)k * n)), s,
        acc, mac);
  score[i] = acc;
  match[i] = mac;
}

__global__ void __launch_bounds__(THREADS)
local_score_tiled(const float* __restrict__ tables,
                  const int* __restrict__ lidx, float* __restrict__ score,
                  float* __restrict__ match, int n, int kk, int tab_len,
                  Score s) {
  __shared__ float tile[TILE_K][TILE_P];
  const int p = threadIdx.x % TILE_P;      // this thread's particle column
  const int row = threadIdx.x / TILE_P;    // its first point row
  const int np = blockIdx.x * TILE_P + p;
  const bool live = np < n;
  float acc = 0.0f, mac = 0.0f;
  for (int k0 = 0; k0 < kk; k0 += TILE_K) {
    const int kt = min(TILE_K, kk - k0);
    int li[TILE_K / TILE_ROWS];
#pragma unroll
    for (int j = 0; j < TILE_K / TILE_ROWS; ++j) {
      const int k = row + j * TILE_ROWS;
      li[j] = (live && k < kt) ? __ldcs(lidx + (size_t)(k0 + k) * n + np) : 0;
    }
#pragma unroll
    for (int j = 0; j < TILE_K / TILE_ROWS; ++j) {
      const int k = row + j * TILE_ROWS;
      if (live && k < kt)
        tile[k][p] = __ldg(tables + (size_t)(k0 + k) * tab_len + li[j]);
    }
    __syncthreads();
    if (threadIdx.x < TILE_P && live) {
#pragma unroll 8
      for (int k = 0; k < kt; ++k) add(tile[k][p], s, acc, mac);
    }
    __syncthreads();
  }
  if (threadIdx.x < TILE_P && live) {
    score[np] = acc;
    match[np] = mac;
  }
}

}  // namespace

// score and match: n floats each, 16-byte aligned (the operator allocates
// them); lidx [kk, n] contiguous, any alignment.
extern "C" int mcl_local_score(const float* tables, const int* lidx,
                               float* score, float* match, int n, int kk,
                               int tab_len, float mdm, float mdf, float mw,
                               cudaStream_t stream) {
  if (n == 0) return 0;
  const Score s{mdm, mdf, mw};
  if (n < SMALL_N) {
    local_score_tiled<<<(n + TILE_P - 1) / TILE_P, THREADS, 0, stream>>>(
        tables, lidx, score, match, n, kk, tab_len, s);
  } else if (n % 4 == 0 && reinterpret_cast<size_t>(lidx) % 16 == 0) {
    const int n4 = n / 4;
    local_score_vec4<<<(n4 + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        tables, reinterpret_cast<const int4*>(lidx),
        reinterpret_cast<float4*>(score), reinterpret_cast<float4*>(match),
        n4, kk, tab_len, s);
  } else {
    local_score_scalar<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        tables, lidx, score, match, n, kk, tab_len, s);
  }
  return (int)cudaGetLastError();
}
