// The kernels' binding to PyTorch: one operator a C entry point of
// grouped.cu, local_gather.cu, beam_march.cu, tier2.cu, group_stats.cu and
// gather_bench.cu, registered with torch's dispatcher for CUDA tensors.
//
// Host-only C++: built with the host compiler against torch's headers and
// libraries (ops/build.py), never with <torch/extension.h>, which would
// cost minutes a build.  Each operator checks its tensors as the kernels
// need them (device, dtype, shape, contiguity, 16-byte alignment of the
// vector loads and stores), with the messages the Python wrappers gave,
// as ValueError; allocates its outputs on the inputs' device; launches on
// torch's current stream of that device; and raises RuntimeError when the
// C entry point reports a launch error.  Scalars the kernels take as
// float come in as the f32 values the wrappers computed and are cast
// back exactly.
//
// The operators' namespace is MCL_OPS_NS, which ops/build.py sets to
// mcl3dl_<hash of the build>, so two builds (an older copy of the package
// and this one) can be loaded into one process side by side.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>
#include <string>
#include <tuple>
#include <vector>

#ifndef MCL_OPS_NS
#error "MCL_OPS_NS must name the operators' namespace"
#endif

extern "C" {
int mcl_like_score(const float*, const int*, const int*, const int*,
                   const int*, const uint8_t*, float*, float*, int, int, int,
                   int, float, float, float, float, float, float,
                   cudaStream_t);
int mcl_beam_pen(const float*, const int*, const int*, const int*,
                 const int*, const int*, const uint8_t*, float*, int, int,
                 int, int, int, int, float, float, float, float, float, float,
                 float, float, float, cudaStream_t);
int mcl_local_score(const float*, const int*, float*, float*, int, int, int,
                    float, float, float, cudaStream_t);
int mcl_march_fixed(const float*, const float*, const float*, const uint8_t*,
                    const float*, bool*, float*, float*, int, int, int, int,
                    int, float, float, float, float, float, float, float,
                    float, float, cudaStream_t);
int mcl_sample_field(const float*, const uint8_t*, const int32_t*,
                     const float*, float*, int64_t, int, int, int, float,
                     float, float, float, float, float, int, cudaStream_t);
int mcl_march_sphere(const float*, const float*, const float*, const float*,
                     const uint8_t*, const float*, bool*, float*, float*,
                     float*, float*, int64_t, int, int, int, int, float, float,
                     float, float, float, float, float, float, float,
                     cudaStream_t);
int mcl_march_dda(const float*, const float*, const float*, const bool*,
                  const int*, const bool*, const int64_t*, const uint8_t*,
                  const float*, bool*, float*, int64_t, int, int, int, int,
                  int, float, float, int64_t, float, float, int,
                  cudaStream_t);
int mcl_group_stats(const float*, const float*, const float*, const bool*,
                    const float*, int32_t*, float*, float*, float*, bool*,
                    int32_t*, float*, int64_t, int, int, int, float, float,
                    float, float, float, float, float, float, float,
                    cudaStream_t);
int64_t mcl_group_stats_smem(int);
int mcl_group_stats_smem_limit();
int64_t mcl_group_stats_scratch(int64_t, int);
int mcl_row_gather(const void*, const int*, void*, int, int, int, int,
                   cudaStream_t);
int mcl_flat_gather(const float*, const int*, float*, int, int, int, int,
                    cudaStream_t);
int mcl_col_gather(const float*, const int*, float*, int, int, int, int,
                   cudaStream_t);
int mcl_rowsel_accumulate(const float*, const int*, const int*, float*, int,
                          int, int, int, cudaStream_t);
}

namespace {

using at::Tensor;
using Shape = std::vector<int64_t>;

constexpr int64_t LANES = 128;
constexpr int64_t TILE = 1024;     // slots a tile of K1/K2 (grouped.cu)
constexpr int64_t R_ROWS = 144;    // rows of a local table, 12 x 12
constexpr int64_t ZW = 128;        // z lanes of a local table

// Python's repr of a shape tuple: (3,), (2, 4), ()
std::string shape_str(c10::IntArrayRef s) {
  std::string out = "(";
  for (size_t i = 0; i < s.size(); ++i)
    out += (i ? ", " : "") + std::to_string(s[i]);
  return out + (s.size() == 1 ? ",)" : ")");
}

// torch's name of a dtype, as Python prints it
std::string dtype_str(c10::ScalarType t) {
  switch (t) {
    case c10::ScalarType::Float: return "torch.float32";
    case c10::ScalarType::Double: return "torch.float64";
    case c10::ScalarType::Half: return "torch.float16";
    case c10::ScalarType::BFloat16: return "torch.bfloat16";
    case c10::ScalarType::Int: return "torch.int32";
    case c10::ScalarType::Long: return "torch.int64";
    case c10::ScalarType::Short: return "torch.int16";
    case c10::ScalarType::Char: return "torch.int8";
    case c10::ScalarType::Byte: return "torch.uint8";
    case c10::ScalarType::Bool: return "torch.bool";
    default: return std::string("torch.") + c10::toString(t);
  }
}

int64_t dim0(const Tensor& t, int64_t d) { return t.dim() > d ? t.size(d) : 0; }

// A kernel argument: a CUDA tensor of `dtype`, contiguous, on `dev` and
// of `shape` where they are given; with `align`, 16-byte aligned.
void check(const Tensor& t, const char* name, c10::ScalarType dtype,
           const Shape* shape = nullptr, const c10::Device* dev = nullptr,
           bool align = false) {
  TORCH_CHECK_VALUE(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK_VALUE(dev == nullptr || t.device() == *dev, name, " is on ",
                    t.device().str(), ", expected ", dev->str());
  TORCH_CHECK_VALUE(t.scalar_type() == dtype, name, " has dtype ",
                    dtype_str(t.scalar_type()), ", expected ",
                    dtype_str(dtype));
  TORCH_CHECK_VALUE(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK_VALUE(shape == nullptr || t.sizes() == c10::IntArrayRef(*shape),
                    name, " has shape ", shape_str(t.sizes()), ", expected ",
                    shape_str(*shape));
  TORCH_CHECK_VALUE(
      !align || reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, name,
      " must be 16-byte aligned");
}

int i32(int64_t v, const char* name) {
  TORCH_CHECK_VALUE(v >= INT32_MIN && v <= INT32_MAX, name, "=", v,
                    " does not fit int32");
  return static_cast<int>(v);
}

int pow2(int64_t n, const char* name) {
  TORCH_CHECK_VALUE(n > 0 && (n & (n - 1)) == 0, name,
                    " must be a power of two, got ", n);
  return i32(n, name);
}

void lanes_last(const Tensor& t, const char* name) {
  TORCH_CHECK_VALUE(t.dim() > 0 && t.size(-1) == LANES, name, " must end in ",
                    LANES, " lanes, got ", shape_str(t.sizes()));
}

void table_rows(const Tensor& t) {
  TORCH_CHECK_VALUE(t.dim() == 2 && t.size(1) == LANES, "tab must be [R, ",
                    LANES, "], got ", shape_str(t.sizes()));
}

void launched(int err, const char* entry) {
  TORCH_CHECK(err == 0, entry, ": CUDA launch failed with error ", err);
}

cudaStream_t stream_of(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

template <typename T>
T* ptr(const Tensor& t) {
  return static_cast<T*>(t.data_ptr());
}

constexpr auto I32 = c10::ScalarType::Int;
constexpr auto I64 = c10::ScalarType::Long;
constexpr auto F32 = c10::ScalarType::Float;
constexpr auto U8 = c10::ScalarType::Byte;
constexpr auto BOOL = c10::ScalarType::Bool;

// ---- K1, K2 (grouped.cu)

std::tuple<Tensor, Tensor> like_score(
    const Tensor& gp_A, const Tensor& tile_group, const Tensor& meta,
    const Tensor& pts_fp, const Tensor& skipw, const Tensor& tables,
    int64_t skip_all, double code_scale, double pt_scale, double trunc,
    double mdm, double mdf, double mw) {
  const int64_t nt = dim0(gp_A, 0), kk = dim0(tables, 0),
                gg = dim0(tables, 1);
  const c10::Device dev = gp_A.device();
  const Shape s_a{nt, 12, TILE}, s_tg{nt}, s_meta{kk, gg, 4}, s_pts{kk, 4},
      s_skip{kk, gg}, s_tab{kk, gg, R_ROWS, ZW};
  check(gp_A, "gp_A", F32, &s_a, &dev);
  check(tile_group, "tile_group", I32, &s_tg, &dev);
  check(meta, "meta", I32, &s_meta, &dev);
  check(pts_fp, "pts_fp", I32, &s_pts, &dev);
  check(skipw, "skipw", I32, &s_skip, &dev);
  check(tables, "tables", U8, &s_tab, &dev);
  c10::cuda::CUDAGuard guard(dev);
  Tensor score = at::empty({nt * TILE}, gp_A.options());
  Tensor match = at::empty({nt * TILE}, gp_A.options());
  launched(mcl_like_score(ptr<const float>(gp_A), ptr<const int>(tile_group),
                          ptr<const int>(meta), ptr<const int>(pts_fp),
                          ptr<const int>(skipw), ptr<const uint8_t>(tables),
                          ptr<float>(score), ptr<float>(match),
                          i32(nt * TILE, "slots"), i32(kk, "points"),
                          i32(gg, "groups"), i32(skip_all, "skip_all"),
                          (float)code_scale, (float)pt_scale, (float)trunc,
                          (float)mdm, (float)mdf, (float)mw,
                          stream_of(gp_A)),
           "mcl_like_score");
  return {score, match};
}

Tensor beam_pen(const Tensor& gp_A, const Tensor& tile_group,
                const Tensor& meta, const Tensor& pts_fp, const Tensor& aux,
                const Tensor& skip, const Tensor& tables, int64_t nprobe,
                int64_t skip_all, int64_t long_pen, double code_scale,
                double pt_scale, double trunc, double grid_min, double radius,
                double hr2, double sin_total_ref, double d_entry_thr,
                double tol) {
  const int64_t nt = dim0(gp_A, 0), bb = dim0(tables, 0),
                gg = dim0(tables, 2), kk = bb * nprobe;
  const c10::Device dev = gp_A.device();
  const Shape s_a{nt, 12, TILE}, s_tg{nt}, s_meta{kk, gg, 4}, s_pts{kk, 4},
      s_aux{bb, 2}, s_skip{kk, gg}, s_tab{bb, nprobe, gg, R_ROWS, ZW};
  check(gp_A, "gp_A", F32, &s_a, &dev);
  check(tile_group, "tile_group", I32, &s_tg, &dev);
  check(meta, "meta", I32, &s_meta, &dev);
  check(pts_fp, "pts_fp", I32, &s_pts, &dev);
  check(aux, "aux", I32, &s_aux, &dev);
  check(skip, "skip", I32, &s_skip, &dev);
  check(tables, "tables", U8, &s_tab, &dev);
  c10::cuda::CUDAGuard guard(dev);
  // the entry point zeroes npen, then the kernel adds each penalty
  Tensor npen = at::empty({nt * TILE}, gp_A.options());
  launched(mcl_beam_pen(ptr<const float>(gp_A), ptr<const int>(tile_group),
                        ptr<const int>(meta), ptr<const int>(pts_fp),
                        ptr<const int>(aux), ptr<const int>(skip),
                        ptr<const uint8_t>(tables), ptr<float>(npen),
                        i32(nt * TILE, "slots"), i32(bb, "beams"),
                        i32(nprobe, "nprobe"), i32(gg, "groups"),
                        i32(skip_all, "skip_all"), long_pen ? 1 : 0,
                        (float)code_scale, (float)pt_scale, (float)trunc,
                        (float)grid_min, (float)radius, (float)hr2,
                        (float)sin_total_ref, (float)d_entry_thr, (float)tol,
                        stream_of(gp_A)),
           "mcl_beam_pen");
  return npen;
}

// ---- K3 (local_gather.cu)

// score and match are the two rows of one allocation, so each is 16-byte
// aligned where n % 4 == 0 (the kernel's vector stores); mdm, mdf and mw
// come in as the caller's doubles and round to float here, as np.float32
// rounds them
std::tuple<Tensor, Tensor> local_score(const Tensor& tables,
                                       const Tensor& lidx, double mdm,
                                       double mdf, double mw) {
  const int64_t kk = dim0(tables, 0), n = dim0(lidx, 1);
  const c10::Device dev = tables.device();
  const Shape s_idx{kk, n};
  check(tables, "tables", F32, nullptr, &dev);
  check(lidx, "lidx", I32, &s_idx, &dev);
  c10::cuda::CUDAGuard guard(dev);
  Tensor out = at::empty({2, n}, tables.options());
  const int64_t tab_len = kk ? tables.numel() / kk : 0;
  float* score = ptr<float>(out);
  launched(mcl_local_score(ptr<const float>(tables), ptr<const int>(lidx),
                           score, score + n, i32(n, "particles"),
                           i32(kk, "points"), i32(tab_len, "table length"),
                           (float)mdm, (float)mdf, (float)mw,
                           stream_of(tables)),
           "mcl_local_score");
  return {out.select(0, 0), out.select(0, 1)};
}

// ---- M1 (beam_march.cu)

// begin and direction [R, 3] f32, l_b [R] f32, field [nx, ny, nz] u8,
// origin [3] f32 (read on the device, never copied to the host), all on
// one device; the floats come in as the f32 values the wrapper computed
std::tuple<Tensor, Tensor, Tensor> march_fixed(
    const Tensor& begin, const Tensor& direction, const Tensor& l_b,
    const Tensor& field, const Tensor& origin, int64_t num_steps, double wx,
    double wy, double wz, double cell, double scale, double trunc,
    double grid, double radius, double d_entry_thr) {
  const int64_t r = dim0(begin, 0);
  const c10::Device dev = begin.device();
  const Shape s_ray{r, 3}, s_lb{r}, s_org{3};
  TORCH_CHECK_VALUE(field.dim() == 3, "field must be [nx, ny, nz], got ",
                    shape_str(field.sizes()));
  check(begin, "begin", F32, &s_ray, &dev);
  check(direction, "direction", F32, &s_ray, &dev);
  check(l_b, "l_b", F32, &s_lb, &dev);
  check(field, "field", U8, nullptr, &dev);
  check(origin, "origin", F32, &s_org, &dev);
  c10::cuda::CUDAGuard guard(dev);
  Tensor found = at::empty({r}, begin.options().dtype(c10::ScalarType::Bool));
  Tensor cpos = at::empty({r, 3}, begin.options());
  Tensor sin_ang = at::empty({r}, begin.options());
  launched(mcl_march_fixed(ptr<const float>(begin), ptr<const float>(direction),
                           ptr<const float>(l_b), ptr<const uint8_t>(field),
                           ptr<const float>(origin), ptr<bool>(found),
                           ptr<float>(cpos), ptr<float>(sin_ang),
                           i32(r, "rays"), i32(field.size(0), "nx"),
                           i32(field.size(1), "ny"), i32(field.size(2), "nz"),
                           i32(num_steps, "num_steps"), (float)wx, (float)wy,
                           (float)wz, (float)cell, (float)scale, (float)trunc,
                           (float)grid, (float)radius, (float)d_entry_thr,
                           stream_of(begin)),
           "mcl_march_fixed");
  return {found, cpos, sin_ang};
}

// ---- M2, M3, M4 (tier2.cu)

void field3(const Tensor& field, const char* name) {
  TORCH_CHECK_VALUE(field.dim() == 3, name, " must be [nx, ny, nz], got ",
                    shape_str(field.sizes()));
}

// q [Q, 3] f32, field [nx, ny, nz] u8, packed [nx * ny * nz, 2] i32 or
// None (read with trilinear only), origin [3] f32
Tensor sample_field(const Tensor& q, const Tensor& field,
                    const std::optional<Tensor>& packed, const Tensor& origin,
                    double wx, double wy, double wz, double cell,
                    double scale, double trunc, bool trilinear) {
  const int64_t n = dim0(q, 0);
  const c10::Device dev = q.device();
  const Shape s_q{n, 3}, s_org{3};
  field3(field, "field");
  check(q, "q", F32, &s_q, &dev);
  check(field, "field", U8, nullptr, &dev);
  check(origin, "origin", F32, &s_org, &dev);
  const int32_t* pk = nullptr;
  if (trilinear && packed.has_value()) {
    const Shape s_pk{field.numel(), 2};
    check(*packed, "packed", I32, &s_pk, &dev);
    pk = ptr<const int32_t>(*packed);
  }
  c10::cuda::CUDAGuard guard(dev);
  Tensor out = at::empty({n}, q.options());
  launched(mcl_sample_field(ptr<const float>(q), ptr<const uint8_t>(field), pk,
                            ptr<const float>(origin), ptr<float>(out), n,
                            i32(field.size(0), "nx"), i32(field.size(1), "ny"),
                            i32(field.size(2), "nz"), (float)wx, (float)wy,
                            (float)wz, (float)cell, (float)scale,
                            (float)trunc, trilinear ? 1 : 0, stream_of(q)),
           "mcl_sample_field");
  return out;
}

// begin, direction [R, 3], max_t, wu [R] f32, field and origin as M1's
std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor> march_sphere(
    const Tensor& begin, const Tensor& direction, const Tensor& max_t,
    const Tensor& wu, const Tensor& field, const Tensor& origin,
    int64_t num_steps, double wx, double wy, double wz, double cell,
    double scale, double trunc, double grid, double radius,
    double d_entry_thr) {
  const int64_t r = dim0(begin, 0);
  const c10::Device dev = begin.device();
  const Shape s_ray{r, 3}, s_r{r}, s_org{3};
  field3(field, "field");
  check(begin, "begin", F32, &s_ray, &dev);
  check(direction, "direction", F32, &s_ray, &dev);
  check(max_t, "max_t", F32, &s_r, &dev);
  check(wu, "wu", F32, &s_r, &dev);
  check(field, "field", U8, nullptr, &dev);
  check(origin, "origin", F32, &s_org, &dev);
  c10::cuda::CUDAGuard guard(dev);
  Tensor found = at::empty({r}, begin.options().dtype(BOOL));
  Tensor cpos = at::empty({r, 3}, begin.options());
  Tensor carry = at::empty({3, r}, begin.options());   // d0_hit, t_entry, d_entry
  float* c = ptr<float>(carry);
  launched(mcl_march_sphere(ptr<const float>(begin), ptr<const float>(direction),
                            ptr<const float>(max_t), ptr<const float>(wu),
                            ptr<const uint8_t>(field), ptr<const float>(origin),
                            ptr<bool>(found), ptr<float>(cpos), c, c + r,
                            c + 2 * r, r, i32(field.size(0), "nx"),
                            i32(field.size(1), "ny"), i32(field.size(2), "nz"),
                            i32(num_steps, "num_steps"), (float)wx, (float)wy,
                            (float)wz, (float)cell, (float)scale,
                            (float)trunc, (float)grid, (float)radius,
                            (float)d_entry_thr, stream_of(begin)),
           "mcl_march_sphere");
  return {found, cpos, carry.select(0, 0), carry.select(0, 1),
          carry.select(0, 2)};
}

// begin, direction [R, 3] f32, max_t [R] f32, begin_inside [R] bool,
// begin_voxel [R, 3] i32; occupied [nx, ny, nz] bool, min_label int64 of
// that shape, rep_point [nx, ny, nz, reps, 3] u8, origin [3] f32
std::tuple<Tensor, Tensor> march_dda(
    const Tensor& begin, const Tensor& direction, const Tensor& max_t,
    const Tensor& begin_inside, const Tensor& begin_voxel,
    const Tensor& occupied, const Tensor& min_label, const Tensor& rep_point,
    const Tensor& origin, int64_t num_steps, double step, double cell,
    int64_t label_max, double ray_angle_half, double min_dist_thr_sq,
    bool refine) {
  const int64_t r = dim0(begin, 0);
  const c10::Device dev = begin.device();
  const Shape s_ray{r, 3}, s_r{r}, s_org{3};
  field3(occupied, "occupied");
  const Shape s_grid(occupied.sizes().begin(), occupied.sizes().end());
  TORCH_CHECK_VALUE(rep_point.dim() == 5 && rep_point.size(4) == 3 &&
                        rep_point.sizes().slice(0, 3) == occupied.sizes(),
                    "rep_point must be [nx, ny, nz, reps, 3], got ",
                    shape_str(rep_point.sizes()));
  check(begin, "begin", F32, &s_ray, &dev);
  check(direction, "direction", F32, &s_ray, &dev);
  check(max_t, "max_t", F32, &s_r, &dev);
  check(begin_inside, "begin_inside", BOOL, &s_r, &dev);
  check(begin_voxel, "begin_voxel", I32, &s_ray, &dev);
  check(occupied, "occupied", BOOL, nullptr, &dev);
  check(min_label, "min_label", I64, &s_grid, &dev);
  check(rep_point, "rep_point", U8, nullptr, &dev);
  check(origin, "origin", F32, &s_org, &dev);
  c10::cuda::CUDAGuard guard(dev);
  Tensor found = at::empty({r}, begin.options().dtype(BOOL));
  Tensor cpos = at::empty({r, 3}, begin.options());
  launched(mcl_march_dda(ptr<const float>(begin), ptr<const float>(direction),
                         ptr<const float>(max_t), ptr<const bool>(begin_inside),
                         ptr<const int>(begin_voxel), ptr<const bool>(occupied),
                         ptr<const int64_t>(min_label),
                         ptr<const uint8_t>(rep_point),
                         ptr<const float>(origin), ptr<bool>(found),
                         ptr<float>(cpos), r, i32(occupied.size(0), "nx"),
                         i32(occupied.size(1), "ny"),
                         i32(occupied.size(2), "nz"),
                         i32(rep_point.size(3), "reps"),
                         i32(num_steps, "num_steps"), (float)step,
                         (float)cell, label_max, (float)ray_angle_half,
                         (float)min_dist_thr_sq, refine ? 1 : 0,
                         stream_of(begin)),
           "mcl_march_dda");
  return {found, cpos};
}

// ---- M5 (group_stats.cu)

// pos [N, 3], rot_mat [N, 3, 3], rot [N, 4] f32, active [N] bool, origin
// [3] f32 (read on the device); the bin grid g_yaw x g_pitch x g_roll.
// Returns g [N] i32, A [N, 12] f32, a_min and a_max [G + 1, 12] f32,
// any_active [G + 1] bool and n_over [] i32; the scratch is the call's own
std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor> group_stats(
    const Tensor& pos, const Tensor& rot_mat, const Tensor& rot,
    const Tensor& active, const Tensor& origin, int64_t g_yaw,
    int64_t g_pitch, int64_t g_roll, double wx, double wy, double wz,
    double inv_cell, double floor_ang, double floor_pos, double trim,
    double sigma, double eps) {
  const int64_t n = dim0(pos, 0);
  const c10::Device dev = pos.device();
  const Shape s_pos{n, 3}, s_rm{n, 3, 3}, s_rot{n, 4}, s_n{n}, s_org{3};
  check(pos, "pos", F32, &s_pos, &dev);
  check(rot_mat, "rot_mat", F32, &s_rm, &dev);
  check(rot, "rot", F32, &s_rot, &dev);
  check(active, "active", BOOL, &s_n, &dev);
  check(origin, "origin", F32, &s_org, &dev);
  TORCH_CHECK_VALUE(n > 0, "group_stats needs at least one particle");
  TORCH_CHECK_VALUE(g_yaw >= 1 && (g_pitch == 1 || g_pitch == 2) &&
                        (g_roll == 1 || g_roll == 2),
                    "the bin grid must be >= 1 x (1 or 2) x (1 or 2), got ",
                    g_yaw, "x", g_pitch, "x", g_roll);
  const int groups = i32(g_yaw * g_pitch * g_roll, "bins");
  c10::cuda::CUDAGuard guard(dev);
  const int64_t need = mcl_group_stats_smem(groups);
  const int limit = mcl_group_stats_smem_limit();
  TORCH_CHECK_VALUE(need <= limit, "group_stats: the ", g_yaw, "x", g_pitch,
                    "x", g_roll, " bin grid's accumulators need ", need,
                    " bytes of shared memory a block, more than the "
                    "device's ", limit);
  Tensor g = at::empty({n}, pos.options().dtype(I32));
  Tensor A = at::empty({n, 12}, pos.options());
  Tensor a_min = at::empty({groups + 1, 12}, pos.options());
  Tensor a_max = at::empty({groups + 1, 12}, pos.options());
  Tensor any_active = at::empty({groups + 1}, pos.options().dtype(BOOL));
  Tensor n_over = at::empty({}, pos.options().dtype(I32));
  Tensor scratch =
      at::empty({mcl_group_stats_scratch(n, groups)}, pos.options());
  launched(mcl_group_stats(ptr<const float>(pos), ptr<const float>(rot_mat),
                           ptr<const float>(rot), ptr<const bool>(active),
                           ptr<const float>(origin), ptr<int32_t>(g),
                           ptr<float>(A), ptr<float>(a_min),
                           ptr<float>(a_max), ptr<bool>(any_active),
                           ptr<int32_t>(n_over), ptr<float>(scratch), n,
                           i32(g_yaw, "g_yaw"), i32(g_pitch, "g_pitch"),
                           i32(g_roll, "g_roll"), (float)wx, (float)wy,
                           (float)wz, (float)inv_cell, (float)floor_ang,
                           (float)floor_pos, (float)trim, (float)sigma,
                           (float)eps, stream_of(pos)),
           "mcl_group_stats");
  return {g, A, a_min, a_max, any_active, n_over};
}

// ---- G1-G10 (gather_bench.cu)

// (a) G1, G2, G4: tab [rows, width] of `dtype`, idx [rows, 128] i32
Tensor row_gather(const Tensor& tab, const Tensor& idx, int64_t off,
                  int64_t width, c10::ScalarType dtype) {
  const int64_t rows = dim0(tab, 0);
  const c10::Device dev = tab.device();
  const Shape s_tab{rows, width}, s_idx{rows, LANES};
  check(tab, "tab", dtype, &s_tab, &dev, true);
  check(idx, "idx", I32, &s_idx, &dev, true);
  c10::cuda::CUDAGuard guard(dev);
  Tensor out = at::empty({rows, LANES}, tab.options());
  const int o = i32(off, "off");
  launched(mcl_row_gather(tab.data_ptr(), ptr<const int>(idx), out.data_ptr(),
                          i32(rows, "rows"), i32(width, "width"),
                          (int)tab.element_size(), o, stream_of(tab)),
           "mcl_row_gather");
  return out;
}

// (b) G3, G6 (shared != 0), G9: idx [..., 128] i32 -> [n / 128, 128] f32
Tensor flat_gather(const Tensor& tab, const Tensor& idx, int64_t off,
                   int64_t shared) {
  lanes_last(idx, "idx");
  const c10::Device dev = tab.device();
  check(tab, "tab", F32, nullptr, nullptr, true);
  check(idx, "idx", I32, nullptr, &dev, true);
  c10::cuda::CUDAGuard guard(dev);
  const int64_t n = idx.numel();
  Tensor out = at::empty({n / LANES, LANES}, tab.options());
  const int n_tab = pow2(tab.numel(), "tab.numel()");
  const int o = i32(off, "off");
  launched(mcl_flat_gather(ptr<const float>(tab), ptr<const int>(idx),
                           ptr<float>(out), n_tab, i32(n, "queries"), o,
                           shared ? 1 : 0, stream_of(tab)),
           "mcl_flat_gather");
  return out;
}

// (c) G5 (mode 0), G7 (1), G8 (2): tab [R, 128] f32, idx [..., 128] i32
Tensor col_gather(const Tensor& tab, const Tensor& idx, int64_t off,
                  int64_t mode) {
  table_rows(tab);
  lanes_last(idx, "idx");
  const c10::Device dev = tab.device();
  check(tab, "tab", F32, nullptr, nullptr, true);
  check(idx, "idx", I32, nullptr, &dev, true);
  c10::cuda::CUDAGuard guard(dev);
  const int64_t n = idx.numel();
  Tensor out = at::empty({n / LANES, LANES}, tab.options());
  const int rows = pow2(tab.size(0), "table rows");
  const int o = i32(off, "off");
  launched(mcl_col_gather(ptr<const float>(tab), ptr<const int>(idx),
                          ptr<float>(out), rows, i32(n, "queries"), o,
                          i32(mode, "mode"), stream_of(tab)),
           "mcl_col_gather");
  return out;
}

// (d) G10: tab [R, 128] f32; rows and lanes i32 of one shape, any
// alignment (the entry takes its vector path where they are aligned)
Tensor rowsel_accumulate(const Tensor& tab, const Tensor& rows,
                         const Tensor& lanes, int64_t passes,
                         int64_t tile_rows) {
  table_rows(tab);
  const c10::Device dev = tab.device();
  const Shape s_q(rows.sizes().begin(), rows.sizes().end());
  check(tab, "tab", F32, nullptr, nullptr, true);
  check(rows, "rows", I32, nullptr, &dev);
  check(lanes, "lanes", I32, &s_q, &dev);
  c10::cuda::CUDAGuard guard(dev);
  Tensor out = at::empty(rows.sizes(), tab.options());
  const int p = i32(passes, "passes");
  const int per_block = i32(tile_rows * LANES, "tile_rows * 128");
  launched(mcl_rowsel_accumulate(ptr<const float>(tab), ptr<const int>(rows),
                                 ptr<const int>(lanes), ptr<float>(out),
                                 i32(tab.size(0), "table rows"),
                                 i32(out.numel(), "queries"), p, per_block,
                                 stream_of(tab)),
           "mcl_rowsel_accumulate");
  return out;
}

}  // namespace

// one level of indirection, so that MCL_OPS_NS is expanded before the
// macros paste it into names
#define MCL_LIBRARY(ns, m) TORCH_LIBRARY(ns, m)
#define MCL_LIBRARY_IMPL(ns, k, m) TORCH_LIBRARY_IMPL(ns, k, m)

MCL_LIBRARY(MCL_OPS_NS, m) {
  m.def("like_score(Tensor gp_A, Tensor tile_group, Tensor meta, "
        "Tensor pts_fp, Tensor skipw, Tensor tables, int skip_all, "
        "float code_scale, float pt_scale, float trunc, float mdm, "
        "float mdf, float mw) -> (Tensor, Tensor)");
  m.def("beam_pen(Tensor gp_A, Tensor tile_group, Tensor meta, "
        "Tensor pts_fp, Tensor aux, Tensor skip, Tensor tables, int nprobe, "
        "int skip_all, int long_pen, float code_scale, float pt_scale, "
        "float trunc, float grid_min, float radius, float hr2, "
        "float sin_total_ref, float d_entry_thr, float tol) -> Tensor");
  m.def("local_score(Tensor tables, Tensor lidx, float mdm, float mdf, "
        "float mw) -> (Tensor, Tensor)");
  m.def("march_fixed(Tensor begin, Tensor direction, Tensor l_b, "
        "Tensor field, Tensor origin, int num_steps, float wx, float wy, "
        "float wz, float cell, float scale, float trunc, float grid, "
        "float radius, float d_entry_thr) -> (Tensor, Tensor, Tensor)");
  m.def("sample_field(Tensor q, Tensor field, Tensor? packed, "
        "Tensor origin, float wx, float wy, float wz, float cell, "
        "float scale, float trunc, bool trilinear) -> Tensor");
  m.def("march_sphere(Tensor begin, Tensor direction, Tensor max_t, "
        "Tensor wu, Tensor field, Tensor origin, int num_steps, float wx, "
        "float wy, float wz, float cell, float scale, float trunc, "
        "float grid, float radius, float d_entry_thr) -> "
        "(Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("march_dda(Tensor begin, Tensor direction, Tensor max_t, "
        "Tensor begin_inside, Tensor begin_voxel, Tensor occupied, "
        "Tensor min_label, Tensor rep_point, Tensor origin, int num_steps, "
        "float step, float cell, int label_max, float ray_angle_half, "
        "float min_dist_thr_sq, bool refine) -> (Tensor, Tensor)");
  m.def("group_stats(Tensor pos, Tensor rot_mat, Tensor rot, "
        "Tensor active, Tensor origin, int g_yaw, int g_pitch, int g_roll, "
        "float wx, float wy, float wz, float inv_cell, float floor_ang, "
        "float floor_pos, float trim, float sigma, float eps) -> "
        "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("row_gather(Tensor tab, Tensor idx, int off, int width, "
        "ScalarType dtype) -> Tensor");
  m.def("flat_gather(Tensor tab, Tensor idx, int off, int shared) -> Tensor");
  m.def("col_gather(Tensor tab, Tensor idx, int off, int mode) -> Tensor");
  m.def("rowsel_accumulate(Tensor tab, Tensor rows, Tensor lanes, "
        "int passes, int tile_rows) -> Tensor");
}

MCL_LIBRARY_IMPL(MCL_OPS_NS, CUDA, m) {
  m.impl("like_score", &like_score);
  m.impl("beam_pen", &beam_pen);
  m.impl("local_score", &local_score);
  m.impl("march_fixed", &march_fixed);
  m.impl("sample_field", &sample_field);
  m.impl("march_sphere", &march_sphere);
  m.impl("march_dda", &march_dda);
  m.impl("group_stats", &group_stats);
  m.impl("row_gather", &row_gather);
  m.impl("flat_gather", &flat_gather);
  m.impl("col_gather", &col_gather);
  m.impl("rowsel_accumulate", &rowsel_accumulate);
}
