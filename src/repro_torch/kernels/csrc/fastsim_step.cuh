// The RASA pipeline simulator's per-instruction step, shared by the scan
// kernels (fastsim.cu) and the whole-trace arbitration kernel (jitarb.cu).
//
// It transcribes the statements of core/fastsim.py::run_segment for one
// instruction, in their order, with Python's max() (the first of equal
// values) and its float floor division (py_floordiv), in float64.  Every
// source that includes it is built with -fmad=false (kernels/_build.py): a
// product is rounded before the sum it feeds, as numpy rounds it, so one
// transcription gives every kernel the numpy lane's bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fastsim {

constexpr int OP_TL = 0, OP_TS = 1, OP_MM = 2, OP_END = 4;
constexpr int NREG = 8;
// per-lane fields of lane_f (kernels/fastsim_scan.py, LANE_FIELDS)
constexpr int kLaneF = 16;
// error codes (fastsim_scan.py raises on them)
constexpr int ERR_NEVER_GRANTED = 1;   // the numpy lane's RuntimeError
constexpr int ERR_NO_PROGRESS = 2;     // a walk that would never end

__device__ __forceinline__ double get_reg(const double (&r)[NREG], int i) {
  double v = r[0];
#pragma unroll
  for (int k = 1; k < NREG; ++k) v = i == k ? r[k] : v;
  return v;
}

__device__ __forceinline__ void set_reg(double (&r)[NREG], int i, double v) {
#pragma unroll
  for (int k = 0; k < NREG; ++k) r[k] = i == k ? v : r[k];
}

// Python's max(a, b) and max(a, b, c): the first of equal values
__device__ __forceinline__ double pymax(double a, double b) { return b > a ? b : a; }
__device__ __forceinline__ double pymax(double a, double b, double c) {
  return pymax(pymax(a, b), c);
}

// a // b for Python floats (b > 0 here: the epoch length, maybe inf)
__device__ __forceinline__ double py_floordiv(double a, double b) {
  double mod = fmod(a, b);
  double div = (a - mod) / b;
  if (mod != 0.0) {
    if ((b < 0.0) != (mod < 0.0)) div -= 1.0;
  }
  double floordiv;
  if (div != 0.0) {
    floordiv = floor(div);
    if (div - floordiv > 0.5) floordiv += 1.0;
  } else {
    floordiv = copysign(0.0, a / b);
  }
  return floordiv;
}

struct Bucket {
  const double* shares;
  long long n_sh;
  double E, tail, burst, sched_end;

  // `shares[int(t // E)] if t // E < n_sh else tail`; fd = t // E
  __device__ __forceinline__ double share_at(double t, double& fd) const {
    fd = py_floordiv(t, E);
    return fd < (double)n_sh ? shares[(long long)fd] : tail;
  }

  // the refill walk `while bt < t_to` of run_segment's grant
  __device__ __forceinline__ int advance(double& tokens, double& bt, double t_to,
                                         long long& walks) const {
    while (bt < t_to) {
      double fd;
      double rate = share_at(bt, fd);
      double step_end;
      if (bt >= sched_end) {
        step_end = t_to;
      } else {
        double e_end = (fd + 1.0) * E;
        step_end = t_to < e_end ? t_to : e_end;
      }
      if (isinf(rate)) {
        tokens = burst;
      } else {
        tokens = tokens + rate * (step_end - bt);
        if (tokens > burst) tokens = burst;
      }
      if (!(step_end > bt)) return ERR_NO_PROGRESS;
      bt = step_end;
      ++walks;
    }
    return 0;
  }

  // run_segment's grant (EpochBandwidthLoadModel._grant): start time of a
  // request of n_bytes at t_earliest; updates tokens and the bucket time
  __device__ __forceinline__ int grant(double& tokens, double& bt, double t_earliest,
                                       double n_bytes, double& start, long long& walks) const {
    int err = advance(tokens, bt, t_earliest, walks);
    if (err) return err;
    double need = n_bytes < burst ? n_bytes : burst;
    if (tokens >= need) {
      start = t_earliest;
    } else {
      double t = bt, tk = tokens;
      while (true) {
        double fd;
        double rate = share_at(t, fd);
        if (isinf(rate)) {
          start = t;
          break;
        }
        if (rate <= 0.0 && t >= sched_end) return ERR_NEVER_GRANTED;
        double e_end = (fd + 1.0) * E;
        if (rate > 0.0) {
          double t_hit = t + (need - tk) / rate;
          if (t_hit <= e_end || t >= sched_end) {
            start = t_hit;
            break;
          }
          tk += rate * (e_end - t);
        }
        if (!(e_end > t)) return ERR_NO_PROGRESS;
        t = e_end;
        ++walks;
      }
      if (start < t_earliest) start = t_earliest;
    }
    err = advance(tokens, bt, start, walks);
    if (err) return err;
    tokens = tokens - n_bytes;
    return 0;
  }
};

// One lane's carry: run_segment's state between two instructions.
struct Carry {
  double reg[NREG];
  double p_ff_start, p_ff_end, p_fs_end, p_dr_end;
  bool have_prev;
  double wl_port_free, t_end;
  long long wl_skips;
  double bw_stall, next_free, store_next, last_grant, tokens, bt;
  long long walks;

  // run_segment's initial state
  __device__ __forceinline__ void reset(double burst) {
#pragma unroll
    for (int k = 0; k < NREG; ++k) reg[k] = 0.0;
    p_ff_start = -1.0;
    p_ff_end = p_fs_end = p_dr_end = 0.0;
    have_prev = false;
    wl_port_free = 0.0;
    t_end = 0.0;
    wl_skips = 0;
    bw_stall = 0.0;
    next_free = store_next = 0.0;
    last_grant = 0.0;
    tokens = burst;
    bt = 0.0;
    walks = 0;
  }
};

// A lane's design and port fields (kernels/fastsim_scan.py, LANE_FIELDS 0-11)
struct Design {
  double wl, fs, dr, issue, load_lat;
  bool wlbp, wls, pipe;
  double inv_load, inv_store;
  bool store_free, charge;

  __device__ __forceinline__ explicit Design(const double* f)
      : wl(f[0]), fs(f[1]), dr(f[2]), issue(f[3]), load_lat(f[4]), wlbp(f[5] != 0.0),
        wls(f[6] != 0.0), pipe(f[7] != 0.0), inv_load(f[8]), inv_store(f[9]),
        store_free(f[10] != 0.0), charge(f[11] != 0.0) {}
};

// One instruction of run_segment: `c` the packed code (kernels/fastsim_scan.py,
// pack_code), `*vp` the tile bytes of a TL/TS or the valid rows of an MM (read
// in the branch that needs it: loading it ahead of the branch made
// fastsim_scan_kernel's long lanes ~3% slower on an H100), `t_issue` the
// instruction's index over the issue rate.  kBucket: the token
// bucket (else the port model: every request granted when its port frees).
// Any opcode other than TL/TS/MM (NOP padding) leaves the carry as it is.
// Returns 0, or the error code of a grant.
template <bool kBucket>
__device__ __forceinline__ int step(Carry& s, int c, const double* vp, double t_issue,
                                   const Design& d, const Bucket& bk) {
  const int op = c & 7;
  if (op == OP_TL) {
    const double port_start = t_issue > s.next_free ? t_issue : s.next_free;
    double start;
    if (!kBucket) {
      start = port_start;
    } else {
      const int err = bk.grant(s.tokens, s.bt, port_start, *vp, start, s.walks);
      if (err) return err;
      s.bw_stall += start - port_start;
    }
    s.next_free = start + d.inv_load;
    if (start > s.last_grant) s.last_grant = start;
    const double done = start + d.load_lat;
    set_reg(s.reg, (c >> 4) & 15, done);
    if (done > s.t_end) s.t_end = done;
    return 0;
  }

  if (op == OP_TS) {
    const double r = get_reg(s.reg, (c >> 8) & 15);
    const double t_avail = t_issue > r ? t_issue : r;
    double e;
    if (d.store_free) {
      e = t_avail + 1.0;
    } else {
      const double port_start = t_avail > s.store_next ? t_avail : s.store_next;
      double start;
      if (kBucket && d.charge) {
        const int err = bk.grant(s.tokens, s.bt, port_start, *vp, start, s.walks);
        if (err) return err;
        s.bw_stall += start - port_start;
      } else {
        start = port_start;
      }
      s.store_next = start + d.inv_store;
      if (start > s.last_grant) s.last_grant = start;
      e = start + 1.0;
    }
    if (e > s.t_end) s.t_end = e;
    return 0;
  }

  if (op != OP_MM) return 0;  // OP_NOP padding

  const int cr = (c >> 4) & 15, ar = (c >> 8) & 15, br = (c >> 12) & 15;
  const double t_ready_ac = pymax(t_issue, get_reg(s.reg, ar), get_reg(s.reg, cr));
  const double t_ready_b = pymax(t_issue, get_reg(s.reg, br));
  const bool reuse = d.wlbp && ((c >> 16) & 1);
  double ff_start;
  if (reuse) {
    ff_start = pymax(t_ready_ac, s.have_prev ? s.p_ff_end : 0.0);
    s.wl_skips += 1;
  } else if (d.wls) {
    const double wl_start =
        pymax(t_ready_b, s.have_prev ? s.p_ff_start : 0.0, s.wl_port_free);
    const bool hidden = s.have_prev && wl_start <= s.p_fs_end;
    const double weights_ready = hidden ? wl_start + 1.0 : wl_start + d.wl;
    ff_start = pymax(t_ready_ac, s.have_prev ? s.p_ff_end : 0.0, weights_ready);
    s.wl_port_free = wl_start + d.wl;
  } else if (d.pipe) {
    const double wl_start =
        pymax(t_ready_b, s.have_prev ? s.p_fs_end : 0.0, s.wl_port_free);
    ff_start = pymax(t_ready_ac, wl_start + d.wl, s.have_prev ? s.p_dr_end : 0.0);
    s.wl_port_free = wl_start + d.wl;
  } else {  // BASE
    const double wl_start =
        pymax(t_ready_b, s.have_prev ? s.p_dr_end : 0.0, s.wl_port_free);
    ff_start = pymax(t_ready_ac, wl_start + d.wl);
    s.wl_port_free = wl_start + d.wl;
  }
  const double ff_end = ff_start + *vp;
  const double fs_end = ff_end + d.fs;
  const double dr_end = fs_end + d.dr;
  set_reg(s.reg, cr, dr_end);
  if (dr_end > s.t_end) s.t_end = dr_end;
  s.p_ff_start = ff_start;
  s.p_ff_end = ff_end;
  s.p_fs_end = fs_end;
  s.p_dr_end = dr_end;
  s.have_prev = true;
  return 0;
}

}  // namespace fastsim
