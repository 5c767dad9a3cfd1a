// Python bindings of the port's CUDA kernels (csrc/*.cu), built with
// torch.utils.cpp_extension.load by ops/_native.py.
//
// Each function checks that its tensors are int32, contiguous and on one
// CUDA device, launches on that device's current stream and checks the
// launch.  The Python wrappers (ops/kernel.py, ops/plumbing.py) check
// shapes and allocate the outputs with torch.empty.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <climits>
#include <optional>
#include <vector>

#include "launch.h"

namespace {

using Tensors = std::vector<at::Tensor>;

void check(const at::Tensor& t, const at::Device& dev, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == dev, name,
              ": all tensors must be on one CUDA device");
  TORCH_CHECK(t.scalar_type() == at::kInt, name, ": expected int32, got ",
              t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), name, ": tensors must be contiguous");
}

const int* in(const at::Tensor& t, const at::Device& dev, const char* name) {
  check(t, dev, name);
  return t.data_ptr<int>();
}

int* out(const at::Tensor& t, const at::Device& dev, const char* name) {
  check(t, dev, name);
  return t.data_ptr<int>();
}

std::vector<const int*> ins(const Tensors& ts, size_t n,
                            const at::Device& dev, const char* name) {
  TORCH_CHECK(ts.size() == n, name, ": expected ", n, " tensors, got ",
              ts.size());
  std::vector<const int*> p;
  for (const auto& t : ts) p.push_back(in(t, dev, name));
  return p;
}

std::vector<int*> outs(const Tensors& ts, size_t n, const at::Device& dev,
                       const char* name) {
  TORCH_CHECK(ts.size() == n, name, ": expected ", n, " tensors, got ",
              ts.size());
  std::vector<int*> p;
  for (const auto& t : ts) p.push_back(out(t, dev, name));
  return p;
}

int dim(int64_t v, const char* name) {
  TORCH_CHECK(v >= 0 && v <= INT_MAX, name, ": size ", v, " out of range");
  return static_cast<int>(v);
}

void* stream_of(const at::Device& dev) {
  return c10::cuda::getCurrentCUDAStream(dev.index()).stream();
}

}  // namespace

void raft_step(const Tensors& state, const Tensors& new_state,
               const Tensors& inbox, const Tensors& outs_, int64_t G,
               int64_t P, int64_t W, int64_t M, int64_t E, int64_t O) {
  const char* name = "raft_step";
  TORCH_CHECK(!state.empty(), name, ": no state tensors");
  const at::Device dev = state[0].device();
  auto si = ins(state, dbt::N_STATE, dev, name);
  auto so = outs(new_state, dbt::N_STATE, dev, name);
  auto ib = ins(inbox, dbt::N_INBOX, dev, name);
  auto o = outs(outs_, dbt::N_OUT, dev, name);
  if (G == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  dbt::raft_step_launch(si.data(), so.data(), ib.data(), o.data(),
                        dim(G, name), dim(P, name), dim(W, name),
                        dim(M, name), dim(E, name), dim(O, name),
                        stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void summarize_flags(const Tensors& srcs, const at::Tensor& flags,
                     int64_t G, int64_t P) {
  const char* name = "summarize_flags";
  const at::Device dev = flags.device();
  auto s = ins(srcs, dbt::N_FLAG_SRCS, dev, name);
  int* f = out(flags, dev, name);
  if (G == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  dbt::summarize_flags_launch(s.data(), f, dim(G, name), dim(P, name),
                              stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gather_pack(const Tensors& detail, const Tensors& vals,
                 const std::optional<at::Tensor>& idx4,
                 const std::optional<at::Tensor>& idx_sum,
                 const at::Tensor& flat, int64_t G, int64_t O, int64_t M,
                 int64_t E, int64_t P, int64_t W, int64_t b, int64_t b2) {
  const char* name = "gather_pack";
  const at::Device dev = flat.device();
  auto d = ins(detail, dbt::N_DETAIL_SRCS, dev, name);
  auto v = ins(vals, dbt::N_PACK_VALS, dev, name);
  TORCH_CHECK(b == 0 || idx4.has_value(), name, ": idx4 missing");
  TORCH_CHECK(b2 == 0 || idx_sum.has_value(), name, ": idx_sum missing");
  const int* i4 = idx4 ? in(*idx4, dev, name) : nullptr;
  const int* is = idx_sum ? in(*idx_sum, dev, name) : nullptr;
  int* fl = out(flat, dev, name);
  if (b + b2 == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  dbt::gather_pack_launch(d.data(), v.data(), i4, is, fl, dim(G, name),
                          dim(O, name), dim(M, name), dim(E, name),
                          dim(P, name), dim(W, name), dim(b, name),
                          dim(b2, name), stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void place_rows(const at::Tensor& pos, const Tensors& dst,
                const Tensors& src, const Tensors& outs_) {
  const char* name = "place_rows";
  const at::Device dev = pos.device();
  const size_t n = src.size();
  TORCH_CHECK(n >= 1 && n <= (size_t)dbt::MAX_FIELDS, name,
              ": 1..", dbt::MAX_FIELDS, " fields");
  TORCH_CHECK(dst.empty() || dst.size() == n, name,
              ": dst and src field counts differ");
  const int* p = in(pos, dev, name);
  auto s = ins(src, n, dev, name);
  auto o = outs(outs_, n, dev, name);
  std::vector<const int*> d(n, nullptr);
  if (!dst.empty()) d = ins(dst, n, dev, name);
  const int64_t G_out = pos.numel(), G_src = src[0].size(0);
  TORCH_CHECK(G_src > 0 || G_out == 0, name, ": the source has no rows");
  std::vector<int> width(n);
  for (size_t f = 0; f < n; ++f) {
    TORCH_CHECK(src[f].dim() >= 1 && src[f].size(0) == G_src, name,
                ": source row counts differ");
    const int64_t w = G_src ? src[f].numel() / G_src : 0;
    TORCH_CHECK(outs_[f].numel() == G_out * w, name, ": field ", f,
                " output size differs");
    TORCH_CHECK(dst.empty() || dst[f].numel() == G_out * w, name,
                ": field ", f, " dst size differs");
    width[f] = dim(w, name);
  }
  if (G_out == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  dbt::place_rows_launch(p, d.data(), s.data(), o.data(), width.data(),
                         (int)n, dim(G_out, name), dim(G_src, name),
                         stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void set_remote_snapshot(const at::Tensor& rstate,
                         const at::Tensor& snap_index,
                         const at::Tensor& g_idx, const at::Tensor& p_idx,
                         const at::Tensor& snap, const at::Tensor& out_rstate,
                         const at::Tensor& out_snap) {
  const char* name = "set_remote_snapshot";
  const at::Device dev = rstate.device();
  TORCH_CHECK(rstate.dim() == 2, name, ": rstate must be [G, P]");
  const int64_t G = rstate.size(0), P = rstate.size(1), n = g_idx.numel();
  TORCH_CHECK(snap_index.sizes() == rstate.sizes() &&
                  out_rstate.sizes() == rstate.sizes() &&
                  out_snap.sizes() == rstate.sizes() &&
                  p_idx.numel() == n && snap.numel() == n,
              name, ": bad shapes");
  const int* rs = in(rstate, dev, name);
  const int* sn = in(snap_index, dev, name);
  const int* gi = in(g_idx, dev, name);
  const int* pi = in(p_idx, dev, name);
  const int* sv = in(snap, dev, name);
  int* ors = out(out_rstate, dev, name);
  int* osn = out(out_snap, dev, name);
  dim(G * P, name);
  if (G * P == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  dbt::set_remote_snapshot_launch(rs, sn, gi, pi, sv, ors, osn,
                                  dim(G, name), dim(P, name), dim(n, name),
                                  stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("raft_step", &raft_step, "csrc/raft_step.cu");
  m.def("summarize_flags", &summarize_flags, "csrc/flags.cu");
  m.def("gather_pack", &gather_pack, "csrc/gather_pack.cu");
  m.def("place_rows", &place_rows, "csrc/place_rows.cu, rows mode");
  m.def("set_remote_snapshot", &set_remote_snapshot,
        "csrc/place_rows.cu, snapshot mode");
}
