// Per-point box scorer for Hopper (sm_90a).
//
// K3 mcl_local_score replaces mcl_3dl_tpu/ops/local_gather.py::_score_kernel,
// the likelihood model's tier-1 fallback: per scan point k a 32x32x16-cell
// f32 distance table (tables [K, 128*128]) and per particle one flat cell
// index (lidx [K, N]).  Per (k, n): d = tables[k][lidx[k, n]], then the
// reference's clamp, flat floor and match count, summed over k in order
// inside the thread, so the f32 sums are bit-equal to the plain version.
//
// One thread per particle; lidx reads are coalesced along n; the 6.3 MB
// of tables stay in L2.  Bound on the H100: device-memory bytes, the
// 4 B index per (k, n) dominates.  Left for later: several particles per
// thread and vector loads of lidx.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
local_score_kernel(const float* __restrict__ tables,
                   const int* __restrict__ lidx, float* __restrict__ score,
                   float* __restrict__ match, int n, int kk, int tab_len,
                   float mdm, float mdf, float mw) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f, mac = 0.0f;
  for (int k = 0; k < kk; ++k) {
    const int li = __ldg(lidx + (size_t)k * n + i);
    const float d = __ldg(tables + (size_t)k * tab_len + li);
    if (d <= mdm) {
      const float contrib =
          fmaxf(__fmul_rn(mw, __fsub_rn(mdm, fmaxf(d, mdf))), 0.0f);
      acc = __fadd_rn(acc, contrib);
      mac = __fadd_rn(mac, 1.0f);
    }
  }
  score[i] = acc;
  match[i] = mac;
}

}  // namespace

extern "C" int mcl_local_score(const float* tables, const int* lidx,
                               float* score, float* match, int n, int kk,
                               int tab_len, float mdm, float mdf, float mw,
                               cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  local_score_kernel<<<blocks, THREADS, 0, stream>>>(
      tables, lidx, score, match, n, kk, tab_len, mdm, mdf, mw);
  return (int)cudaGetLastError();
}
