// The RASA pipeline simulator's two scan lanes, hand-written for Hopper
// (sm_90a), with a plain C interface for ctypes (kernels/fastsim_scan.py).
//
// Replaces the JAX package's two lax.scan programs in core/fastsim.py:
//   fastsim_scan     <- _sim_chunk_fn (fastsim.py:813), the full-stream
//                       scan, vmapped over designs, cores or packed segments
//   fastsim_mm_scan  <- _jax_mm_fn (fastsim.py:1346), the MM-only scan of
//                       the paper's port model
//
// Each thread runs one lane's whole recurrence, instruction after
// instruction, in float64 with the carry in registers (the eight register
// ready-times are kept in registers by unrolled selects, never indexed
// memory).  The full-stream step lives in fastsim_step.cuh, shared with
// the whole-trace arbitration kernel (jitarb.cu).  A lane of fastsim_scan is one (trace, design) pair, one core,
// or a run of packed segments; its trace is the range [lo, hi) of the
// shared code/val columns, so the sweep, cores and packed layouts of the
// reference are the same kernel with other lane tables.  Lanes are whole:
// no chunking, no padding of the lane count.
//
// What bounds it: the dependence of each step on the previous one.  A lane
// does a few tens of fp64 operations a step, each waiting on the last, so a
// lane takes (steps x dependent operations x fp64 latency); the card's
// bytes and fp64 rate are far from the limit with 8-72 lanes.  The design
// does nothing about that in this version: it is right first (the numpy
// lane's arithmetic bit for bit).
//
// Bit-equality with the numpy lane (core/fastsim.py::run_segment):
//  * every statement is transcribed from run_segment (fastsim_step.cuh and
//    the MM-only step below), in its order, with
//    Python's max() (the first of equal values) and its branches;
//  * Python's float floor division (CPython's _float_div_mod) is py_floordiv;
//  * this file is built with -fmad=false (kernels/_build.py): a product is
//    rounded before the sum it feeds, as numpy rounds it;
//  * double division, fmod and floor are correctly rounded on the card.

#include "fastsim_step.cuh"

namespace {

using namespace fastsim;

// per-lane int64 fields of lane_i: trace lo, trace hi, share lo, share count
constexpr int kLaneI = 4;
// outputs per lane (and per emitted segment): t_end, wl_skips, bw_stall,
// last_grant, bucket walk steps (a lane's: all its segments')
constexpr int kOut = 5;
// one lane a CTA: lanes diverge (designs take other branches, bucket walks
// differ in length), so lanes sharing a warp would wait on each other; with
// a few hundred lanes at most, each lane has an SM's scheduler to itself
constexpr int kLanesPerCta = 1;

// One lane's full-stream recurrence (run_segment, fastsim_step.cuh).
// kBucket: the token bucket (else the port model); kEmit: OP_END writes the
// finished segment's results to seg_out and resets the carry, and issue
// indices restart after it.
template <bool kBucket, bool kEmit>
__global__ void __launch_bounds__(kLanesPerCta) fastsim_scan_kernel(
    const int32_t* __restrict__ code, const double* __restrict__ val,
    const double* __restrict__ lane_f, const long long* __restrict__ lane_i,
    const double* __restrict__ shares, int n_lanes, double* __restrict__ out,
    double* __restrict__ seg_out, int* __restrict__ err_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const double* f = lane_f + (size_t)lane * kLaneF;
  const long long* li_ = lane_i + (size_t)lane * kLaneI;
  const Design d(f);
  const Bucket bk{shares + li_[2], li_[3], f[12], f[13], f[14], f[15]};
  const long long lo = li_[0], hi = li_[1];

  Carry s;
  s.reset(bk.burst);
  long long walks_done = 0;
  int err = 0, seg = 0;
  long long i = 0;  // the segment-local instruction index
  for (long long pos = lo; pos < hi; ++pos, ++i) {
    const int c = code[pos];
    if (kEmit && (c & 7) == OP_END) {
      double* o = seg_out + ((size_t)seg * n_lanes + lane) * kOut;
      o[0] = s.t_end;
      o[1] = (double)s.wl_skips;
      o[2] = s.bw_stall;
      o[3] = s.last_grant;
      o[4] = (double)s.walks;
      walks_done += s.walks;
      s.reset(bk.burst);
      ++seg;
      i = -1;
      continue;
    }
    err = step<kBucket>(s, c, val + pos, (double)i / d.issue, d, bk);
    if (err) break;
  }
  double* o = out + (size_t)lane * kOut;
  o[0] = s.t_end;
  o[1] = (double)s.wl_skips;
  o[2] = s.bw_stall;
  o[3] = s.last_grant;
  o[4] = (double)(walks_done + s.walks);
  err_out[lane] = err;
}

// per-lane fields of the MM-only scan: wl, fs, dr, wlbp, wls, pipe
constexpr int kMMLaneF = 6;
// per-row doubles: a_const, b_const, c_const, tm, t_issue, ts_issue
constexpr int kMMVal = 6;

// One lane's MM-only recurrence (the reference's _jax_mm_fn step) over the
// rasa_mm rows [lo, hi) of its trace's block.  code packs c, a, b (4 bits
// each), then a_dyn, b_dyn, c_dyn, reusable, ts_mask (one bit each): an
// operand whose last writer is an MM reads its register's ready-time,
// any other its static ready-time from val.
__global__ void __launch_bounds__(kLanesPerCta) fastsim_mm_kernel(
    const int32_t* __restrict__ code, const double* __restrict__ val,
    const double* __restrict__ lane_f, const long long* __restrict__ lane_rows,
    int n_lanes, double* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const double* f = lane_f + (size_t)lane * kMMLaneF;
  const double wl = f[0], fs = f[1], dr = f[2];
  const bool wlbp = f[3] != 0.0, wls = f[4] != 0.0, pipe = f[5] != 0.0;
  const long long lo = lane_rows[2 * lane], hi = lane_rows[2 * lane + 1];

  double reg_ready[NREG];
#pragma unroll
  for (int k = 0; k < NREG; ++k) reg_ready[k] = 0.0;
  double p_ff_start = -1.0, p_ff_end = 0.0, p_fs_end = 0.0, p_dr_end = 0.0;
  double wl_port_free = 0.0, t_end = 0.0;
  bool have_prev = false;
  long long wl_skips = 0;
  for (long long r = lo; r < hi; ++r) {
    const int c = code[r];
    const double* v = val + (size_t)r * kMMVal;
    const int cr = c & 15, ar = (c >> 4) & 15, br = (c >> 8) & 15;
    const double ra = (c >> 12) & 1 ? get_reg(reg_ready, ar) : v[0];
    const double rb = (c >> 13) & 1 ? get_reg(reg_ready, br) : v[1];
    const double rc = (c >> 14) & 1 ? get_reg(reg_ready, cr) : v[2];
    const double t_issue = v[4];
    const double t_ready_ac = pymax(t_issue, ra, rc);
    const double t_ready_b = pymax(t_issue, rb);
    const bool reuse = wlbp && ((c >> 15) & 1);
    double ff_start;
    if (reuse) {
      ff_start = pymax(t_ready_ac, have_prev ? p_ff_end : 0.0);
      wl_skips += 1;
    } else if (wls) {
      const double wl_start = pymax(t_ready_b, have_prev ? p_ff_start : 0.0, wl_port_free);
      const bool hidden = have_prev && wl_start <= p_fs_end;
      const double weights_ready = hidden ? wl_start + 1.0 : wl_start + wl;
      ff_start = pymax(t_ready_ac, have_prev ? p_ff_end : 0.0, weights_ready);
      wl_port_free = wl_start + wl;
    } else if (pipe) {
      const double wl_start = pymax(t_ready_b, have_prev ? p_fs_end : 0.0, wl_port_free);
      ff_start = pymax(t_ready_ac, wl_start + wl, have_prev ? p_dr_end : 0.0);
      wl_port_free = wl_start + wl;
    } else {  // BASE
      const double wl_start = pymax(t_ready_b, have_prev ? p_dr_end : 0.0, wl_port_free);
      ff_start = pymax(t_ready_ac, wl_start + wl);
      wl_port_free = wl_start + wl;
    }
    const double ff_end = ff_start + v[3];
    const double fs_end = ff_end + fs;
    const double dr_end = fs_end + dr;
    set_reg(reg_ready, cr, dr_end);
    if (dr_end > t_end) t_end = dr_end;
    // the latest free store of this MM's result retires at
    // max(its issue, dr_end) + 1
    if ((c >> 16) & 1) {
      const double ts_end = pymax(v[5], dr_end) + 1.0;
      if (ts_end > t_end) t_end = ts_end;
    }
    p_ff_start = ff_start;
    p_ff_end = ff_end;
    p_fs_end = fs_end;
    p_dr_end = dr_end;
    have_prev = true;
  }
  out[2 * lane] = t_end;
  out[2 * lane + 1] = (double)wl_skips;
}

template <bool kBucket, bool kEmit>
cudaError_t launch_scan(const int32_t* code, const double* val, const double* lane_f,
                        const long long* lane_i, const double* shares, int n_lanes,
                        double* out, double* seg_out, int* err, cudaStream_t s) {
  const int grid = (n_lanes + kLanesPerCta - 1) / kLanesPerCta;
  fastsim_scan_kernel<kBucket, kEmit><<<grid, kLanesPerCta, 0, s>>>(
      code, val, lane_f, lane_i, shares, n_lanes, out, seg_out, err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The full-stream scan: lane l simulates code/val[lane_i[l][0], lane_i[l][1])
// with its design and bucket fields lane_f[l] and shares[lane_i[l][2] ...
// + lane_i[l][3]).  out [n_lanes, 5]; with emit, seg_out [n_seg, n_lanes, 5]
// gets each OP_END's segment.  err [n_lanes]: 0, or the error code.  Returns
// the launch's cudaError_t.
int fastsim_scan(int bucket, int emit, const void* code, const void* val, const void* lane_f,
                 const void* lane_i, const void* shares, int n_lanes, void* out,
                 void* seg_out, void* err, void* stream) {
  if (n_lanes <= 0) return 0;
  auto c = static_cast<const int32_t*>(code);
  auto v = static_cast<const double*>(val);
  auto f = static_cast<const double*>(lane_f);
  auto li = static_cast<const long long*>(lane_i);
  auto sh = static_cast<const double*>(shares);
  auto o = static_cast<double*>(out);
  auto so = static_cast<double*>(seg_out);
  auto e = static_cast<int*>(err);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t r;
  if (bucket) {
    r = emit ? launch_scan<true, true>(c, v, f, li, sh, n_lanes, o, so, e, s)
             : launch_scan<true, false>(c, v, f, li, sh, n_lanes, o, so, e, s);
  } else {
    r = emit ? launch_scan<false, true>(c, v, f, li, sh, n_lanes, o, so, e, s)
             : launch_scan<false, false>(c, v, f, li, sh, n_lanes, o, so, e, s);
  }
  return (int)r;
}

// The MM-only scan: lane l runs the rows lane_rows[l] of code [rows] and
// val [rows, 6] under lane_f[l]; out [n_lanes, 2]: t_end, wl_skips.
int fastsim_mm_scan(const void* code, const void* val, const void* lane_f, const void* lane_rows,
                    int n_lanes, void* out, void* stream) {
  if (n_lanes <= 0) return 0;
  const int grid = (n_lanes + kLanesPerCta - 1) / kLanesPerCta;
  fastsim_mm_kernel<<<grid, kLanesPerCta, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(code), static_cast<const double*>(val),
      static_cast<const double*>(lane_f), static_cast<const long long*>(lane_rows), n_lanes,
      static_cast<double*>(out));
  return (int)cudaGetLastError();
}

const char* fastsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
