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

// raft_step.cu's kernel `kind`, R rows a block; the routed step's outputs
// are buf, count and escalate.  Returns the routed step's resident blocks
// an SM (the occupancy API's), 0 for the other kinds
static int64_t step_launch(const char* name, dbt::StepKind kind,
                           const Tensors& state, const Tensors& new_state,
                           const Tensors& inbox, const Tensors& outs_,
                           int64_t G, int64_t P, int64_t W, int64_t M,
                           int64_t E, int64_t O, int64_t R, int64_t K) {
  TORCH_CHECK(!state.empty(), name, ": no state tensors");
  TORCH_CHECK(R == 32 || R == 64 || R == 128, name,
              ": rows a block must be 32, 64 or 128, got ", R);
  TORCH_CHECK(K >= 0 && K <= O, name, ": staged messages ", K,
              " outside [0, ", O, "]");
  const at::Device dev = state[0].device();
  auto si = ins(state, dbt::N_STATE, dev, name);
  auto so = outs(new_state, dbt::N_STATE, dev, name);
  auto ib = ins(inbox, dbt::N_INBOX, dev, name);
  auto o = outs(outs_, kind == dbt::STEP_ROUTED ? dbt::N_ROUTED_OUT
                                                 : dbt::N_OUT,
                dev, name);
  o.resize(dbt::N_OUT, nullptr);
  if (G == 0) return 0;
  const c10::cuda::CUDAGuard guard(dev);
  const int per_sm = dbt::raft_step_launch(
      si.data(), so.data(), ib.data(), o.data(), dim(G, name), dim(P, name),
      dim(W, name), dim(M, name), dim(E, name), dim(O, name), kind,
      dim(R, name), dim(K, name), stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return per_sm;
}

void raft_step(const Tensors& state, const Tensors& new_state,
               const Tensors& inbox, const Tensors& outs_, int64_t G,
               int64_t P, int64_t W, int64_t M, int64_t E, int64_t O,
               int64_t R, int64_t K) {
  step_launch("raft_step", dbt::STEP_EXTERNAL, state, new_state, inbox,
              outs_, G, P, W, M, E, O, R, K);
}

int64_t raft_step_routed(const Tensors& state, const Tensors& new_state,
                         const Tensors& inbox, const Tensors& outs_,
                         int64_t G, int64_t P, int64_t W, int64_t M,
                         int64_t E, int64_t O, int64_t R, int64_t K) {
  return step_launch("raft_step_routed", dbt::STEP_ROUTED, state, new_state,
                     inbox, outs_, G, P, W, M, E, O, R, K);
}

void raft_step_internal(const Tensors& state, const Tensors& new_state,
                        const Tensors& inbox, const Tensors& outs_,
                        int64_t G, int64_t P, int64_t W, int64_t M,
                        int64_t E, int64_t O, int64_t R, int64_t K) {
  step_launch("raft_step_internal", dbt::STEP_INTERNAL, state, new_state,
              inbox, outs_, G, P, W, M, E, O, R, K);
}

void summarize_flags(const Tensors& srcs,
                     const std::optional<at::Tensor>& undeliv,
                     const at::Tensor& flags, int64_t G, int64_t P) {
  const char* name = "summarize_flags";
  const at::Device dev = flags.device();
  auto s = ins(srcs, dbt::N_FLAG_SRCS, dev, name);
  const int* u = nullptr;
  if (undeliv) {
    TORCH_CHECK(undeliv->numel() == G, name, ": undeliv must be [G]");
    u = in(*undeliv, dev, name);
  }
  int* f = out(flags, dev, name);
  if (G == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  dbt::summarize_flags_launch(s.data(), u, f, dim(G, name), dim(P, name),
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

// the words a row of each field of `ts` (G rows), checking that each has
// G rows
std::vector<int> row_widths(const Tensors& ts, int64_t G, const char* name) {
  std::vector<int> width(ts.size());
  for (size_t f = 0; f < ts.size(); ++f) {
    TORCH_CHECK(ts[f].dim() >= 1 && ts[f].size(0) == G, name, ": field ", f,
                " row count differs");
    width[f] = dim(G ? ts[f].numel() / G : 0, name);
  }
  return width;
}

// field f's output at word off[f] of `out`: a multiple of 4 words, inside
// `out`, after field f - 1's
std::vector<long long> out_offsets(const at::Tensor& out,
                                   const std::vector<int64_t>& off,
                                   const std::vector<int>& width,
                                   int64_t G_out, const char* name) {
  TORCH_CHECK(off.size() == width.size(), name, ": one offset a field");
  std::vector<long long> o(off.size());
  int64_t end = 0;
  for (size_t f = 0; f < off.size(); ++f) {
    TORCH_CHECK(off[f] >= end && off[f] % 4 == 0, name, ": field ", f,
                " output offset ", off[f], " overlaps or is not 16-byte "
                "aligned");
    end = off[f] + G_out * width[f];
    TORCH_CHECK(end <= out.numel(), name, ": field ", f,
                " output past the buffer");
    o[f] = off[f];
  }
  return o;
}

void launched(int rc, const char* name) {
  TORCH_CHECK(rc != 1, name, ": the output buffer is not 16-byte aligned");
  TORCH_CHECK(rc == 0, name, ": rows too wide for 32-bit offsets");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void place_rows(const at::Tensor& pos, const Tensors& dst,
                const Tensors& src, const at::Tensor& out_buf,
                const std::vector<int64_t>& off) {
  const char* name = "place_rows";
  const at::Device dev = pos.device();
  const size_t n = src.size();
  TORCH_CHECK(n >= 1 && n <= (size_t)dbt::MAX_FIELDS, name,
              ": 1..", dbt::MAX_FIELDS, " fields");
  TORCH_CHECK(dst.empty() || dst.size() == n, name,
              ": dst and src field counts differ");
  const int* p = in(pos, dev, name);
  auto s = ins(src, n, dev, name);
  std::vector<const int*> d;
  if (!dst.empty()) d = ins(dst, n, dev, name);
  int* o = out(out_buf, dev, name);
  const int64_t G_out = pos.numel(), G_src = src[0].size(0);
  TORCH_CHECK(G_src > 0 || G_out == 0, name, ": the source has no rows");
  auto width = row_widths(src, G_src, name);
  for (size_t f = 0; f < n && !dst.empty(); ++f)
    TORCH_CHECK(dst[f].numel() == G_out * width[f], name, ": field ", f,
                " dst size differs");
  auto offs = out_offsets(out_buf, off, width, G_out, name);
  if (G_out == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  launched(dbt::place_rows_launch(p, d.empty() ? nullptr : d.data(), s.data(),
                                  o, offs.data(), width.data(), (int)n,
                                  dim(G_out, name), dim(G_src, name),
                                  stream_of(dev)),
           name);
}

void merge_escalated(const at::Tensor& escalate, const Tensors& old_,
                     const Tensors& new_) {
  const char* name = "merge_escalated";
  const at::Device dev = escalate.device();
  const size_t n = new_.size();
  TORCH_CHECK(n >= 1 && n <= (size_t)dbt::MAX_FIELDS, name,
              ": 1..", dbt::MAX_FIELDS, " fields");
  const int64_t G = escalate.numel();
  const int* e = in(escalate, dev, name);
  auto o_ = ins(old_, n, dev, name);
  auto n_ = outs(new_, n, dev, name);
  auto width = row_widths(new_, G, name);
  for (size_t f = 0; f < n; ++f)
    TORCH_CHECK(old_[f].sizes() == new_[f].sizes(), name, ": field ", f,
                " shapes differ");
  if (G == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  launched(dbt::merge_escalated_launch(e, o_.data(), n_.data(), width.data(),
                                       (int)n, dim(G, name), stream_of(dev)),
           name);
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

void route(const Tensors& st, const at::Tensor& buf, const at::Tensor& count,
           const at::Tensor& dest_row, const at::Tensor& rank,
           const std::optional<at::Tensor>& suppress,
           const std::optional<at::Tensor>& alive, int64_t alive_stride,
           const Tensors& base_inbox, const Tensors& inbox,
           const at::Tensor& stats, const std::optional<at::Tensor>& packed,
           const std::optional<at::Tensor>& undeliv,
           const std::optional<at::Tensor>& delivered,
           const at::Tensor& scratch, const at::Tensor& cnt, int64_t B,
           int64_t base, int64_t tick, int64_t propose_leaders,
           int64_t propose_n, const std::optional<at::Tensor>& census) {
  const char* name = "route";
  const at::Device dev = buf.device();
  auto s = ins(st, dbt::N_ROUTE_STATE, dev, name);
  TORCH_CHECK(buf.dim() == 3 && st[0].dim() == 2 && st[5].dim() == 2 &&
                  inbox.size() == (size_t)dbt::N_INBOX &&
                  inbox[0].dim() == 2 && inbox[10].dim() == 3,
              name, ": bad shapes");
  const int64_t G = buf.size(0), O = buf.size(1), P = st[0].size(1);
  const int64_t W = st[5].size(1), M = inbox[0].size(1);
  const int64_t E = inbox[10].size(2);
  TORCH_CHECK(buf.size(2) == 11, name, ": buf must be [G, O, 11]");
  TORCH_CHECK(P >= 1 && P <= 16, name, ": P must be in [1, 16]");
  TORCH_CHECK(W >= 1 && (W & (W - 1)) == 0, name, ": W must be a power of two");
  TORCH_CHECK(B >= 1 && base >= 0 && base + P * B == M, name,
              ": base + P * budget must equal M");
  TORCH_CHECK(count.numel() == G && dest_row.numel() == G * P &&
                  rank.numel() == G * P && stats.numel() == dbt::N_ROUTE_STATS,
              name, ": bad table shapes");
  for (int i = 0; i < dbt::N_ROUTE_STATE; ++i)
    TORCH_CHECK(st[i].size(0) == G, name, ": state row counts differ");
  TORCH_CHECK(scratch.numel() == G * P * B, name,
              ": scratch must be [G, P, B]");
  TORCH_CHECK(cnt.numel() == G * P, name, ": cnt must be [G, P]");
  TORCH_CHECK(G * M <= INT_MAX - 256, name, ": G * M out of range");
  const int* sup = nullptr;
  if (suppress) {
    TORCH_CHECK(suppress->numel() == G, name, ": suppress must be [G]");
    sup = in(*suppress, dev, name);
  }
  const int* alv = nullptr;
  if (alive) {
    TORCH_CHECK(alive_stride >= 1 && alive->numel() == G * alive_stride, name,
                ": alive must be [G * alive_stride]");
    alv = in(*alive, dev, name);
  }
  std::vector<const int*> bi;
  int64_t M_base = 0;
  if (!base_inbox.empty()) {
    bi = ins(base_inbox, dbt::N_INBOX, dev, name);
    M_base = base_inbox[0].size(1);
    TORCH_CHECK(M_base >= base && base_inbox[10].size(2) == E, name,
                ": base_inbox narrower than the prefix");
  }
  auto ib = outs(inbox, dbt::N_INBOX, dev, name);
  int* pk = nullptr;
  if (packed) {
    TORCH_CHECK(packed->numel() == G * ((O + 31) / 32), name,
                ": packed must be [G, ceil(O / 32)]");
    pk = out(*packed, dev, name);
  }
  int* ud = nullptr;
  if (undeliv) {
    TORCH_CHECK(undeliv->numel() == G, name, ": undeliv must be [G]");
    ud = out(*undeliv, dev, name);
  }
  unsigned char* dl = nullptr;
  if (delivered) {
    TORCH_CHECK(delivered->is_cuda() && delivered->device() == dev &&
                    delivered->scalar_type() == at::kBool &&
                    delivered->is_contiguous() && delivered->numel() == G * O,
                name, ": delivered must be a contiguous [G, O] bool tensor");
    dl = static_cast<unsigned char*>(delivered->data_ptr());
  }
  unsigned long long* cen = nullptr;
  if (census) {
    TORCH_CHECK(census->is_cuda() && census->device() == dev &&
                    census->scalar_type() == at::kLong &&
                    census->is_contiguous() &&
                    census->numel() == dbt::N_ROUTE_CENSUS,
                name, ": census must be a contiguous [", dbt::N_ROUTE_CENSUS,
                "] int64 tensor");
    cen = reinterpret_cast<unsigned long long*>(census->data_ptr<int64_t>());
  }
  int* stt = out(stats, dev, name);
  int* scr = out(scratch, dev, name);
  int* cn = out(cnt, dev, name);
  if (G == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  dbt::route_launch(s.data(), in(buf, dev, name), in(count, dev, name),
                    in(dest_row, dev, name), in(rank, dev, name), sup, alv,
                    dim(alive_stride, name), bi.empty() ? nullptr : bi.data(),
                    dim(M_base, name), ib.data(), stt, pk, ud, dl, scr, cn,
                    dim(G, name), dim(P, name), dim(W, name), dim(O, name),
                    dim(M, name), dim(E, name), dim(B, name), dim(base, name),
                    dim(tick, name), dim(propose_leaders, name),
                    dim(propose_n, name), cen, stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void xlane_pack(const Tensors& st, const at::Tensor& buf,
                const at::Tensor& count,
                const std::optional<at::Tensor>& suppress,
                const at::Tensor& dest_local, const at::Tensor& dest_dev,
                const at::Tensor& rank, const at::Tensor& xbuf,
                const at::Tensor& rowoff, const at::Tensor& btot,
                const at::Tensor& boff, const at::Tensor& part,
                const at::Tensor& tot,
                const at::Tensor& stats, int64_t me, int64_t D, int64_t B,
                int64_t R, const std::optional<at::Tensor>& alive,
                int64_t alive_stride,
                const std::optional<at::Tensor>& packed,
                const std::optional<at::Tensor>& undeliv) {
  const char* name = "xlane_pack";
  const at::Device dev = buf.device();
  auto s = ins(st, dbt::N_LANE_STATE, dev, name);
  TORCH_CHECK(buf.dim() == 3 && buf.size(2) == 11 && st[0].dim() == 2 &&
                  st[4].dim() == 2 && xbuf.dim() == 3,
              name, ": bad shapes");
  const int64_t G = buf.size(0), O = buf.size(1), P = st[0].size(1);
  const int64_t W = st[4].size(1), XB = xbuf.size(1);
  const int64_t KT = xbuf.size(2), E = (KT - 14) / 2;
  TORCH_CHECK(P >= 1 && P <= 16, name, ": P must be in [1, 16]");
  TORCH_CHECK(W >= 1 && (W & (W - 1)) == 0, name, ": W must be a power of two");
  TORCH_CHECK(D >= 1 && D <= 16 && me >= 0 && me < D && xbuf.size(0) == D,
              name, ": me / D out of range");
  TORCH_CHECK(KT >= 14 && KT % 2 == 0 && XB >= 1 && B >= 1, name,
              ": xbuf must be [D, XB, 14 + 2E]");
  for (int i = 0; i < dbt::N_LANE_STATE; ++i)
    TORCH_CHECK(st[i].size(0) == G, name, ": state row counts differ");
  TORCH_CHECK(count.numel() == G && dest_local.numel() == G * P &&
                  dest_dev.numel() == G * P && rank.numel() == G * P,
              name, ": bad table shapes");
  TORCH_CHECK(packed.has_value() == undeliv.has_value(), name,
              ": packed and undeliv come together");
  const int64_t n_stats =
      packed ? dbt::N_LANE_STATS_X : dbt::N_LANE_STATS;
  TORCH_CHECK(stats.numel() == n_stats, name, ": stats must be [", n_stats,
              "]");
  const int* alv = nullptr;
  if (alive) {
    TORCH_CHECK(alive_stride >= 1 && alive->numel() == G * D * alive_stride,
                name, ": alive must be [G * D * alive_stride]");
    alv = in(*alive, dev, name);
  }
  int* pk = nullptr;
  int* ud = nullptr;
  if (packed) {
    TORCH_CHECK(packed->numel() == G * ((O + 31) / 32) &&
                    undeliv->numel() == G,
                name, ": packed must be [G, ceil(O / 32)], undeliv [G]");
    pk = out(*packed, dev, name);
    ud = out(*undeliv, dev, name);
  }
  TORCH_CHECK(R == 32 || R == 64 || R == 128, name,
              ": rows a block must be 32, 64 or 128, got ", R);
  const int64_t nblk = (G + R - 1) / R;
  TORCH_CHECK(rowoff.numel() == G * D && btot.numel() == nblk * D &&
                  boff.numel() == nblk * D && part.numel() == nblk * 5 &&
                  tot.numel() == D,
              name, ": workspace must be [G, D], [nblk, D] twice, [nblk, 5], "
              "[D]");
  const int* sup = nullptr;
  if (suppress) {
    TORCH_CHECK(suppress->numel() == G, name, ": suppress must be [G]");
    sup = in(*suppress, dev, name);
  }
  const c10::cuda::CUDAGuard guard(dev);
  dbt::xlane_pack_launch(s.data(), in(buf, dev, name), in(count, dev, name),
                         sup, in(dest_local, dev, name),
                         in(dest_dev, dev, name), in(rank, dev, name),
                         out(xbuf, dev, name), out(rowoff, dev, name),
                         out(btot, dev, name), out(boff, dev, name),
                         out(part, dev, name),
                         out(tot, dev, name), out(stats, dev, name),
                         dim(n_stats, name), alv, dim(alive_stride, name),
                         pk, ud, dim(G, name), dim(P, name), dim(W, name),
                         dim(O, name), dim(E, name), dim(D, name),
                         dim(XB, name), dim(B, name), dim(me, name),
                         dim(R, name), stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void xlane_scatter(const Tensors& inbox, const at::Tensor& recv,
                   const at::Tensor& stats, int64_t B, int64_t base) {
  const char* name = "xlane_scatter";
  const at::Device dev = recv.device();
  auto ib = outs(inbox, dbt::N_INBOX, dev, name);
  TORCH_CHECK(inbox[0].dim() == 2 && inbox[10].dim() == 3 &&
                  recv.dim() == 2,
              name, ": bad shapes");
  const int64_t G = inbox[0].size(0), M = inbox[0].size(1);
  const int64_t E = inbox[10].size(2), R = recv.size(0);
  TORCH_CHECK(recv.size(1) == 14 + 2 * E, name,
              ": recv must be [R, 14 + 2E]");
  TORCH_CHECK(stats.numel() == dbt::N_LANE_STATS ||
                  stats.numel() == dbt::N_LANE_STATS_X,
              name, ": stats must be [7] or [8]");
  for (int i = 0; i < dbt::N_INBOX; ++i)
    TORCH_CHECK(inbox[i].size(0) == G && inbox[i].size(1) == M, name,
                ": inbox shapes differ");
  const c10::cuda::CUDAGuard guard(dev);
  dbt::xlane_scatter_launch(ib.data(), in(recv, dev, name),
                            out(stats, dev, name), dim(R, name), dim(G, name),
                            dim(M, name), dim(E, name), dim(B, name),
                            dim(base, name), stream_of(dev));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

namespace {

// an inbox's 12 planes as the copy's source region: [G, S] and [G, S, E]
// planes of width S; returns S
int64_t inbox_region(const Tensors& ts, std::vector<const int*>& p,
                     int64_t G, const at::Device& dev, const char* name,
                     const char* what) {
  p = ins(ts, dbt::N_INBOX, dev, name);
  TORCH_CHECK(ts[0].dim() == 2 && ts[10].dim() == 3 && ts[0].size(0) == G,
              name, ": ", what, " must be [G, S] and [G, S, E] planes");
  const int64_t S = ts[0].size(1), E = ts[10].size(2);
  for (int f = 0; f < dbt::N_INBOX; ++f)
    TORCH_CHECK(ts[f].numel() == G * S * (f >= 10 ? E : 1), name, ": ",
                what, " plane ", f, " has the wrong size");
  return S;
}

// the output allocation of a [G, M, E] inbox (inbox_layout)
int* inbox_out(const at::Tensor& out_buf, int64_t G, int64_t M, int64_t E,
               const at::Device& dev, const char* name) {
  long long off[dbt::N_INBOX];
  const long long words =
      dbt::inbox_layout(dim(G, name), dim(M, name), dim(E, name), off);
  TORCH_CHECK(out_buf.dim() == 1 && out_buf.numel() == words, name,
              ": the output buffer must hold ", words, " words");
  return out(out_buf, dev, name);
}

}  // namespace

void assemble_inbox(const Tensors& host, const Tensors& pending,
                    const at::Tensor& combo, const at::Tensor& out_buf) {
  const char* name = "assemble_inbox";
  const at::Device dev = combo.device();
  TORCH_CHECK(combo.dim() == 2 && combo.size(1) == 4, name,
              ": combo must be [G, 4]");
  const int64_t G = combo.size(0);
  const int* c = in(combo, dev, name);
  std::vector<const int*> ph, pp;
  const int64_t Mh = inbox_region(host, ph, G, dev, name, "host");
  const int64_t PB = inbox_region(pending, pp, G, dev, name, "pending");
  const int64_t E = host[10].size(2);
  TORCH_CHECK(pending[10].size(2) == E, name, ": entry widths differ");
  int* o = inbox_out(out_buf, G, PB + Mh, E, dev, name);
  if (G * (PB + Mh) == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  launched(dbt::inbox_copy_launch(pp.data(), ph.data(), c, 4, 1, o,
                                        dim(G, name), dim(PB + Mh, name),
                                        dim(E, name), dim(PB, name),
                                        stream_of(dev)),
                 name);
}

void host_inbox_from_ticks(const at::Tensor& combo, const at::Tensor& out_buf,
                           int64_t M, int64_t E) {
  const char* name = "host_inbox_from_ticks";
  const at::Device dev = combo.device();
  TORCH_CHECK(combo.dim() == 2 && combo.size(1) == 4, name,
              ": combo must be [G, 4]");
  TORCH_CHECK(M >= 0 && E >= 0, name, ": negative width");
  const int64_t G = combo.size(0);
  const int* c = in(combo, dev, name);
  int* o = inbox_out(out_buf, G, M, E, dev, name);
  if (G * M == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  launched(dbt::inbox_fill_launch(c, o, dim(G, name), dim(M, name),
                                        dim(E, name), stream_of(dev)),
                 name);
}

void zero_inbox_rows(const Tensors& src, const at::Tensor& mask,
                     const at::Tensor& out_buf) {
  const char* name = "zero_inbox_rows";
  const at::Device dev = mask.device();
  const int64_t G = mask.numel();
  const int* mk = in(mask, dev, name);
  std::vector<const int*> ps;
  const int64_t M = inbox_region(src, ps, G, dev, name, "inbox");
  const int64_t E = src[10].size(2);
  int* o = inbox_out(out_buf, G, M, E, dev, name);
  if (G * M == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  launched(dbt::inbox_copy_launch(nullptr, ps.data(), mk, 1, 0, o,
                                        dim(G, name), dim(M, name),
                                        dim(E, name), 0, stream_of(dev)),
                 name);
}

void select_and_blob(const at::Tensor& flags, const at::Tensor& combo,
                     const at::Tensor& packed, const at::Tensor& stats,
                     const Tensors& detail_srcs, const at::Tensor& head,
                     const at::Tensor& detail, const at::Tensor& scratch,
                     const std::vector<int64_t>& caps, int64_t host_off) {
  const char* name = "select_and_blob";
  const at::Device dev = flags.device();
  auto d = ins(detail_srcs, dbt::N_DETAIL_SRCS, dev, name);
  TORCH_CHECK(caps.size() == 5, name, ": five capacities");
  const int64_t G = flags.numel();
  TORCH_CHECK(detail_srcs[0].dim() == 3 && detail_srcs[3].dim() == 3 &&
                  detail_srcs[4].dim() == 2 && detail_srcs[5].dim() == 2,
              name, ": bad detail source shapes");
  const int64_t O = detail_srcs[0].size(1), Mo = detail_srcs[1].size(1);
  const int64_t E = detail_srcs[3].size(2), P = detail_srcs[4].size(1);
  const int64_t W = detail_srcs[5].size(1), nw = (O + 31) / 32;
  for (const auto& t : detail_srcs)
    TORCH_CHECK(t.size(0) == G, name, ": detail source row counts differ");
  TORCH_CHECK(combo.numel() == G * 4 && packed.numel() == G * nw &&
                  stats.numel() == 6,
              name, ": bad combo / packed / stats sizes");
  TORCH_CHECK(host_off >= 0 && host_off <= Mo, name, ": bad host offset");
  int cap[5];
  int64_t rows = 0;
  for (int k = 0; k < 5; ++k) {
    TORCH_CHECK(caps[k] >= 0 && caps[k] <= G, name, ": capacity above G");
    cap[k] = (int)caps[k];
    rows += caps[k];
  }
  const int64_t Mh = Mo - host_off;
  TORCH_CHECK(head.numel() == G + G * nw + 6 + 5 + rows + caps[4] * 10, name,
              ": head has the wrong size");
  TORCH_CHECK(detail.numel() == caps[0] * O * 11 + 2 * caps[1] * Mh +
                                    caps[1] * Mh * E + caps[2] * P +
                                    2 * caps[3] * W,
              name, ": detail has the wrong size");
  // scratch: block totals and offsets [nb, 5] each, then a mask byte a row
  const int64_t nb = (G + 255) / 256;
  TORCH_CHECK(scratch.numel() == 10 * nb + (G + 3) / 4, name,
              ": scratch must be 10 * ceil(G / 256) + ceil(G / 4) words");
  const int* f = in(flags, dev, name);
  const int* c = in(combo, dev, name);
  const int* pk = in(packed, dev, name);
  const int* st = in(stats, dev, name);
  int* h = out(head, dev, name);
  int* dt = out(detail, dev, name);
  int* sc = out(scratch, dev, name);
  if (G == 0) return;
  const c10::cuda::CUDAGuard guard(dev);
  launched(dbt::select_blob_launch(
               f, c, pk, st, d.data(), h, dt,
               reinterpret_cast<unsigned char*>(sc + 10 * nb), sc,
               sc + 5 * nb, cap, dim(G, name), dim(nw, name), dim(O, name),
               dim(Mo, name), dim(E, name), dim(P, name), dim(W, name),
               dim(host_off, name), stream_of(dev)),
           name);
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("raft_step", &raft_step, "csrc/raft_step.cu, external layout");
  m.def("raft_step_routed", &raft_step_routed,
        "csrc/raft_step.cu, external layout, the routed round's outputs");
  m.def("raft_step_internal", &raft_step_internal,
        "csrc/raft_step.cu, internal (G-last) layout");
  m.def("summarize_flags", &summarize_flags, "csrc/flags.cu");
  m.def("gather_pack", &gather_pack, "csrc/gather_pack.cu");
  m.def("place_rows", &place_rows, "csrc/place_rows.cu, rows mode");
  m.def("merge_escalated", &merge_escalated,
        "csrc/place_rows.cu, the in-place escalation merge");
  m.def("set_remote_snapshot", &set_remote_snapshot,
        "csrc/place_rows.cu, snapshot mode");
  m.def("route", &route, "csrc/route.cu");
  m.def("assemble_inbox", &assemble_inbox, "csrc/inbox.cu, copy (assemble)");
  m.def("host_inbox_from_ticks", &host_inbox_from_ticks,
        "csrc/inbox.cu, fill (from_ticks)");
  m.def("zero_inbox_rows", &zero_inbox_rows,
        "csrc/inbox.cu, copy (zero_rows)");
  m.def("select_and_blob", &select_and_blob, "csrc/select_blob.cu");
  m.def("xlane_pack", &xlane_pack, "csrc/xlane.cu, pack");
  m.def("xlane_scatter", &xlane_scatter, "csrc/xlane.cu, scatter");
}
