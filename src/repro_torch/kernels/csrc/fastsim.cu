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
// The MM-only kernel (below) has a shorter step, so the instructions a row
// issues bound it as much as the row's chain.  One CTA a lane; its thread
// streams the rows (a code and six doubles, 52 bytes) through the same TMA
// ring with six doubles a position, loads each row into registers while the
// row before runs, keeps the register file in shared memory (a load and a
// store a row, not selects over eight registers), and runs a loop without
// branches for each weight-load path, unrolled so that rows interleave.
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
// the MM-only kernel's ring: a row's code and its six doubles (39,936 bytes)
using MMRing = RingT<kMMVal>;
// rows of the MM-only loop unrolled, so the compiler interleaves a row's
// loads, decoding and register-file reads with the chain of the rows before
constexpr int kMMUnroll = 4;
// the reference's weight-load paths (a lane's design takes one): one loop each
enum MMPath { kBase, kPipe, kWls };

// One MM row in registers: its code and its six doubles (a row's doubles
// start on a 16-byte edge of the ring: three 16-byte loads)
struct MMRow {
  int c;
  double v[kMMVal];

  __device__ __forceinline__ void load(const int32_t* cs, const double* vs, int k) {
    c = cs[k];
    const double2* p = reinterpret_cast<const double2*>(vs + k * kMMVal);
#pragma unroll
    for (int j = 0; j < kMMVal / 2; ++j) {
      const double2 d = p[j];
      v[2 * j] = d.x;
      v[2 * j + 1] = d.y;
    }
  }
};

// One lane's MM-only carry (the reference's _jax_mm_fn state; the register
// file's ready-times live in shared memory).  p_ff_start starts at 0: the
// reference's -1 is read only after a row, so `have_prev ? p_x : 0` is p_x
// for every carry.
struct MMCarry {
  double p_ff_start = 0.0, p_ff_end = 0.0, p_fs_end = 0.0, p_dr_end = 0.0;
  double wl_port_free = 0.0, t_end = 0.0;
  bool have_prev = false;
  long long wl_skips = 0;
};

// A lane's MM-only design fields (wls and pipe pick the loop: MMPath)
struct MMDesign {
  double wl, fs, dr;
  bool wlbp;
};

// One row of the reference's MM-only step on weight-load path kPath, in its
// statement order.  code packs c, a, b (4 bits each; ids below NREG, the
// wrapper checks), then a_dyn, b_dyn, c_dyn, reusable, ts_mask (one bit
// each): an operand whose last writer is an MM reads its register's
// ready-time from the register file `rf`, any other its static ready-time
// from the row.  No branch: a reusing row's ff_start and port time are
// selected, so the unrolled rows are one block of straight-line code.
template <int kPath>
__device__ __forceinline__ void mm_step(MMCarry& s, const MMRow& row, const MMDesign& d,
                                        double* rf) {
  const int c = row.c;
  const double* v = row.v;
  const int cr = c & (NREG - 1), ar = (c >> 4) & (NREG - 1), br = (c >> 8) & (NREG - 1);
  const double ra = (c >> 12) & 1 ? rf[ar] : v[0];
  const double rb = (c >> 13) & 1 ? rf[br] : v[1];
  const double rc = (c >> 14) & 1 ? rf[cr] : v[2];
  const double t_issue = v[4];
  const double t_ready_ac = pymax(t_issue, ra, rc);
  const double t_ready_b = pymax(t_issue, rb);
  const bool reuse = d.wlbp && ((c >> 15) & 1);
  double wl_start, ff_load;   // the weight load's start; ff_start where the row loads
  if (kPath == kWls) {
    wl_start = pymax(t_ready_b, s.p_ff_start, s.wl_port_free);
    const bool hidden = s.have_prev && wl_start <= s.p_fs_end;
    const double weights_ready = hidden ? wl_start + 1.0 : wl_start + d.wl;
    ff_load = pymax(t_ready_ac, s.p_ff_end, weights_ready);
  } else if (kPath == kPipe) {
    wl_start = pymax(t_ready_b, s.p_fs_end, s.wl_port_free);
    ff_load = pymax(t_ready_ac, wl_start + d.wl, s.p_dr_end);
  } else {
    wl_start = pymax(t_ready_b, s.p_dr_end, s.wl_port_free);
    ff_load = pymax(t_ready_ac, wl_start + d.wl);
  }
  const double ff_start = reuse ? pymax(t_ready_ac, s.p_ff_end) : ff_load;
  s.wl_port_free = reuse ? s.wl_port_free : wl_start + d.wl;
  s.wl_skips += reuse;
  const double ff_end = ff_start + v[3];
  const double fs_end = ff_end + d.fs;
  const double dr_end = fs_end + d.dr;
  rf[cr] = dr_end;
  if (dr_end > s.t_end) s.t_end = dr_end;
  // the latest free store of this MM's result retires at
  // max(its issue, dr_end) + 1
  if ((c >> 16) & 1) {
    const double ts_end = pymax(v[5], dr_end) + 1.0;
    if (ts_end > s.t_end) s.t_end = ts_end;
  }
  s.p_ff_start = ff_start;
  s.p_ff_end = ff_end;
  s.p_fs_end = fs_end;
  s.p_dr_end = dr_end;
  s.have_prev = true;
}

// A lane's rows [lo, hi) through the ring, each row loaded into registers
// while the row before runs
template <int kPath>
__device__ __forceinline__ void mm_lane(MMRing& ring, MMCarry& s, const MMDesign& d, double* rf,
                                        const int32_t* code, const double* val, long long n,
                                        long long lo, long long hi) {
  ring.chunks(code, val, n, lo, hi,
              [&](long long, int k0, int k1, const int32_t* cs, const double* vs) {
                MMRow next;
                next.load(cs, vs, k0);
#pragma unroll kMMUnroll
                for (int k = k0; k < k1; ++k) {
                  const MMRow row = next;
                  // the chunk's last row reloads itself: the next row is in
                  // the next chunk's stage, not yet waited for
                  next.load(cs, vs, k + 1 < k1 ? k + 1 : k);
                  mm_step<kPath>(s, row, d, rf);
                }
                return 0;
              });
}

// One lane's MM-only recurrence over the rasa_mm rows [lo, hi) of its
// trace's block: one CTA a lane (lanes diverge: designs take other paths),
// its one thread streaming the rows through a TMA ring.
__global__ void __launch_bounds__(1) fastsim_mm_kernel(
    const int32_t* __restrict__ code, const double* __restrict__ val, long long n_rows,
    const double* __restrict__ lane_f, const long long* __restrict__ lane_rows,
    double* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kStages];
  __shared__ double rf[NREG];   // each register's ready-time
  const int lane = blockIdx.x;
  const double* f = lane_f + (size_t)lane * kMMLaneF;
  const MMDesign d{f[0], f[1], f[2], f[3] != 0.0};
  const long long lo = lane_rows[2 * lane], hi = lane_rows[2 * lane + 1];
  MMRing ring(smem, 0, bars);
  ring.init();
  for (int k = 0; k < NREG; ++k) rf[k] = 0.0;
  __syncthreads();

  MMCarry s;
  if (f[4] != 0.0)
    mm_lane<kWls>(ring, s, d, rf, code, val, n_rows, lo, hi);
  else if (f[5] != 0.0)
    mm_lane<kPipe>(ring, s, d, rf, code, val, n_rows, lo, hi);
  else
    mm_lane<kBase>(ring, s, d, rf, code, val, n_rows, lo, hi);
  out[2 * lane] = s.t_end;
  out[2 * lane + 1] = (double)s.wl_skips;
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

// The MM-only scan: lane l runs the rows lane_rows[l] of code [n_rows] and
// val [n_rows, 6] (both 16-byte aligned) under lane_f[l], one CTA each;
// out [n_lanes, 2]: t_end, wl_skips.
int fastsim_mm_scan(const void* code, const void* val, long long n_rows, const void* lane_f,
                    const void* lane_rows, int n_lanes, void* out, void* stream) {
  if (n_lanes <= 0) return 0;
  fastsim_mm_kernel<<<n_lanes, 1, MMRing::kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(code), static_cast<const double*>(val), n_rows,
      static_cast<const double*>(lane_f), static_cast<const long long*>(lane_rows),
      static_cast<double*>(out));
  return (int)cudaGetLastError();
}

const char* fastsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
