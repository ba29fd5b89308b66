// The RASA pipeline simulator's two scan lanes, hand-written for Hopper
// (sm_90a), with a plain C interface for ctypes (kernels/fastsim_scan.py).
//
// Replaces the JAX package's two lax.scan programs in core/fastsim.py:
//   fastsim_scan     <- _sim_chunk_fn (fastsim.py:813), the full-stream
//                       scan, vmapped over designs, cores or packed segments
//   fastsim_mm_scan  <- _jax_mm_fn (fastsim.py:1346), the MM-only scan of
//                       the paper's port model
//
// A lane of fastsim_scan is one (trace, design) pair, one core, or a run of
// packed segments; its trace is the range [lo, hi) of the shared code/val
// columns, so the sweep, cores and packed layouts of the reference are the
// same kernel with other lane tables.  The full-stream step lives in
// fastsim_step.cuh, shared with the whole-trace arbitration kernel
// (jitarb.cu).
//
// What bounds it: the dependence of each step on the previous one.  A chain
// does a few tens of fp64 operations a step, each waiting on the last, so it
// takes (steps x dependent operations x fp64 latency); the card's bytes and
// fp64 rate are far from the limit with 8-72 lanes.  The design keeps that
// chain fed and short, and runs as many chains at once as the work has:
//  * one chain a CTA: a whole lane, or in the packed layout one segment of a
//    lane (OP_END resets the carry and the issue index, so the segments of a
//    lane are independent chains); the wrapper's chain table lists them;
//  * the chain's thread streams its instructions from shared memory through
//    the TMA ring of fastsim_step.cuh, and reads its lane's epoch shares from
//    shared memory where they fit (the CTA's 32 threads stage them first);
//  * the epoch index and the issue time are exact products where the lane's
//    epoch and issue rate are powers of two (flags of lane_f, set on the
//    host), not divisions on the chain;
//  * the carry stays in registers (the eight register ready-times by
//    unrolled selects, never indexed memory).
// The MM-only kernel (below) runs one lane a thread, its rows read from
// device memory.
//
// Bit-equality with the numpy lane (core/fastsim.py::run_segment):
//  * every statement is transcribed from run_segment (fastsim_step.cuh and
//    the MM-only step below), in its order, with
//    Python's max() (the first of equal values) and its branches;
//  * Python's float floor division (CPython's _float_div_mod) is py_floordiv,
//    or floor(t * (1 / E)) where E is a power of two or inf (t / E and the
//    product are then the same exact value);
//  * this file is built with -fmad=false (kernels/_build.py): a product is
//    rounded before the sum it feeds, as numpy rounds it;
//  * double division, fmod and floor are correctly rounded on the card.

#include "fastsim_step.cuh"

namespace {

using namespace fastsim;

// per-lane int64 fields of lane_i: trace lo, trace hi, share lo, share count
constexpr int kLaneI = 4;
// int64 fields of a chain (kernels/fastsim_scan.py, chain_table): lane, lo,
// hi, segment (-1: the lane's trailing part, which writes the lane's row)
constexpr int kChainI = 4;
// outputs per lane (and per emitted segment): t_end, wl_skips, bw_stall,
// last_grant, bucket walk steps (a lane's: all its segments')
constexpr int kOut = 5;
// the MM-only kernel: one lane a CTA (lanes diverge: designs take other
// branches), so each lane has an SM's scheduler to itself
constexpr int kLanesPerCta = 1;
// the full-stream kernel: a warp a chain; its 32 threads stage the lane's
// shares, then one runs the chain
constexpr int kScanThreads = 32;
// the most epoch shares a CTA stages in shared memory (64 KB); a lane with
// more reads them from device memory
constexpr int kShareSlots = 8192;
// a chain's error in err_out: (its order in the lane) * 4 + the code, the
// least of the lane's chains kept (atomicMin); the wrapper decodes it
constexpr int kTrailing = 1 << 28;   // the order of a lane's trailing part

// One chain of the full-stream recurrence (run_segment, fastsim_step.cuh):
// chains[blockIdx.x] = (lane, lo, hi, seg).  kBucket: the token bucket (else
// the port model).  A segment (seg >= 0) writes seg_out[seg, lane]; a lane's
// trailing part (seg < 0) writes out[lane]'s first four fields; every chain
// adds its walk steps to out[lane, 4] (integers: the sum is exact in any
// order), and its error to err_out[lane].  `sh_slots` shares fit in shared
// memory: a lane with more reads them from device memory.
template <bool kBucket>
__global__ void __launch_bounds__(kScanThreads) fastsim_scan_kernel(
    const int32_t* __restrict__ code, const double* __restrict__ val, long long n_col,
    const double* __restrict__ lane_f, const long long* __restrict__ lane_i,
    const double* __restrict__ shares, const long long* __restrict__ chains, int n_lanes,
    int sh_slots, double* __restrict__ out, double* __restrict__ seg_out,
    int* __restrict__ err_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kStages];
  const long long* ch = chains + (size_t)blockIdx.x * kChainI;
  const int lane = (int)ch[0], seg = (int)ch[3];
  const long long lo = ch[1], hi = ch[2];
  const double* f = lane_f + (size_t)lane * kLaneF;
  const long long* li_ = lane_i + (size_t)lane * kLaneI;
  const long long n_sh = li_[3];
  const double* sh_g = shares + li_[2];
  double* sh_s = reinterpret_cast<double*>(smem + kRingBytes);
  const bool staged = kBucket && n_sh <= sh_slots;
  if (staged)
    for (long long k = threadIdx.x; k < n_sh; k += blockDim.x) sh_s[k] = sh_g[k];
  Ring ring(smem, 0, bars);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x != 0) return;

  const Design d(f);
  const double E = f[12];
  const Bucket bk{staged ? sh_s : sh_g, n_sh, E, f[13], f[14], f[15], 1.0 / E,
                  f[kEpochPow2] != 0.0};
  Carry s;
  s.reset(bk.burst);
  IssueClock clk(d, 0);
  const int err = ring.run(code, val, n_col, lo, hi,
                           [&](long long pos, int c, const double* vp) {
                             return step<kBucket>(s, c, vp, clk.at(d, pos - lo), d, bk);
                           });
  double* o = seg >= 0 ? seg_out + ((size_t)seg * n_lanes + lane) * kOut
                       : out + (size_t)lane * kOut;
  o[0] = s.t_end;
  o[1] = (double)s.wl_skips;
  o[2] = s.bw_stall;
  o[3] = s.last_grant;
  if (seg >= 0) o[4] = (double)s.walks;
  atomicAdd(out + (size_t)lane * kOut + 4, (double)s.walks);
  if (err) atomicMin(err_out + lane, (seg >= 0 ? seg : kTrailing) * 4 + err);
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

template <bool kBucket>
cudaError_t launch_scan(const int32_t* code, const double* val, long long n_col,
                        const double* lane_f, const long long* lane_i, const double* shares,
                        const long long* chains, int n_chains, int n_lanes, int sh_slots,
                        double* out, double* seg_out, int* err, cudaStream_t s) {
  const size_t smem = kRingBytes + (size_t)sh_slots * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        fastsim_scan_kernel<kBucket>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (r != cudaSuccess) return r;
  }
  fastsim_scan_kernel<kBucket><<<n_chains, kScanThreads, smem, s>>>(
      code, val, n_col, lane_f, lane_i, shares, chains, n_lanes, sh_slots, out, seg_out, err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The full-stream scan: lane l simulates code/val[lane_i[l][0], lane_i[l][1])
// (columns of n_col positions, 16-byte aligned) with its design and bucket
// fields lane_f[l] and shares[lane_i[l][2] ... + lane_i[l][3]), as the chains
// [n_chains, 4] split it (one CTA each).  out [n_lanes, 5] and seg_out
// [n_seg, n_lanes, 5] zeroed, err [n_lanes] filled with INT_MAX by the
// caller.  max_sh: the most shares of a lane; *sh_slots gets the shares a CTA
// staged in shared memory (a lane with more read device memory).  Returns
// the launch's cudaError_t.
int fastsim_scan(int bucket, const void* code, const void* val, long long n_col,
                 const void* lane_f, const void* lane_i, const void* shares, const void* chains,
                 int n_chains, int n_lanes, long long max_sh, void* out, void* seg_out,
                 void* err, int* sh_slots, void* stream) {
  const int slots = bucket ? (int)(max_sh < kShareSlots ? max_sh : kShareSlots) : 0;
  *sh_slots = slots;
  if (n_chains <= 0) return 0;
  auto c = static_cast<const int32_t*>(code);
  auto v = static_cast<const double*>(val);
  auto f = static_cast<const double*>(lane_f);
  auto li = static_cast<const long long*>(lane_i);
  auto sh = static_cast<const double*>(shares);
  auto ch = static_cast<const long long*>(chains);
  auto o = static_cast<double*>(out);
  auto so = static_cast<double*>(seg_out);
  auto e = static_cast<int*>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t r =
      bucket ? launch_scan<true>(c, v, n_col, f, li, sh, ch, n_chains, n_lanes, slots, o, so, e, s)
             : launch_scan<false>(c, v, n_col, f, li, sh, ch, n_chains, n_lanes, slots, o, so, e,
                                  s);
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
