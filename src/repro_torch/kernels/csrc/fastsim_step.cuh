// The RASA pipeline simulator's per-instruction step, and the staging ring
// that feeds it, shared by the full-stream scan kernel (fastsim.cu) and the
// whole-trace arbitration kernel (jitarb.cu); the MM-only kernel (fastsim.cu)
// streams its rows through the same ring, six doubles a position.
//
// The step transcribes the statements of core/fastsim.py::run_segment for
// one instruction, in their order, with Python's max() (the first of equal
// values) and its float floor division (py_floordiv), in float64.  Every
// source that includes it is built with -fmad=false (kernels/_build.py): a
// product is rounded before the sum it feeds, as numpy rounds it, so one
// transcription gives every kernel the numpy lane's bits.
//
// What bounds a step: its dependent chain through the carry (a few tens of
// fp64 operations, branches and selects, each waiting on the last) on the
// lane's one thread, which nothing else on the SM hides.  What the design
// does about it:
//  * the instruction stream reaches the chain from shared memory: a ring of
//    kStages chunks of kChunk instructions a lane, filled by TMA bulk copies
//    (cp.async.bulk, one mbarrier a stage) kStages - 1 chunks ahead of the
//    step, so no step waits on device memory;
//  * the bucket's epoch index t // E is floor(t * (1 / E)) when E is a power
//    of two or inf (the lane's flag, set on the host): the same bits as
//    Python's // for every finite t >= 0, without py_floordiv's fmod and
//    division on the chain; the issue time i / issue is i * (1 / issue)
//    likewise, else the division of the next step is taken before this one;
//  * the kernels read the epoch shares from shared memory where they fit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fastsim {

constexpr int OP_TL = 0, OP_TS = 1, OP_MM = 2, OP_END = 4;
constexpr int NREG = 8;
// per-lane fields of lane_f (kernels/fastsim_scan.py, LANE_FIELDS)
constexpr int kLaneF = 18;
constexpr int kEpochPow2 = 16, kIssuePow2 = 17;   // the two exact-reciprocal flags
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
  const double* shares;   // shared memory where the lane's shares fit, else global
  long long n_sh;
  double E, tail, burst, sched_end;
  double inv_E;           // 1 / E, exact when pow2
  bool pow2;              // E is a power of two or inf: t // E == floor(t * inv_E)

  // t // E as Python computes it, for finite t >= 0
  __device__ __forceinline__ double epoch_of(double t) const {
    return pow2 ? floor(t * inv_E) : py_floordiv(t, E);
  }

  // `shares[int(t // E)] if t // E < n_sh else tail`; fd = t // E
  __device__ __forceinline__ double share_at(double t, double& fd) const {
    fd = epoch_of(t);
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

// A lane's design and port fields (kernels/fastsim_scan.py, LANE_FIELDS 0-11,
// and the issue rate's flag)
struct Design {
  double wl, fs, dr, issue, load_lat;
  bool wlbp, wls, pipe;
  double inv_load, inv_store;
  bool store_free, charge;
  bool issue_pow2;    // issue is a power of two: i / issue == i * inv_issue
  double inv_issue;

  __device__ __forceinline__ explicit Design(const double* f)
      : wl(f[0]), fs(f[1]), dr(f[2]), issue(f[3]), load_lat(f[4]), wlbp(f[5] != 0.0),
        wls(f[6] != 0.0), pipe(f[7] != 0.0), inv_load(f[8]), inv_store(f[9]),
        store_free(f[10] != 0.0), charge(f[11] != 0.0), issue_pow2(f[kIssuePow2] != 0.0),
        inv_issue(1.0 / f[3]) {}
};

// The issue times i / issue of a run of consecutive indices, from i0 on:
// exact products where issue is a power of two; else each division is taken
// one step ahead of the step that needs it.
struct IssueClock {
  double ahead;

  __device__ __forceinline__ IssueClock(const Design& d, long long i0)
      : ahead(d.issue_pow2 ? 0.0 : (double)i0 / d.issue) {}

  __device__ __forceinline__ double at(const Design& d, long long i) {
    if (d.issue_pow2) return (double)i * d.inv_issue;
    const double t = ahead;
    ahead = (double)(i + 1) / d.issue;
    return t;
  }
};

// One instruction of run_segment: `c` the packed code (kernels/fastsim_scan.py,
// pack_code), `*vp` the tile bytes of a TL/TS or the valid rows of an MM (read
// in the branch that needs it), `t_issue` the instruction's index over the
// issue rate.  kBucket: the token bucket (else the port model: every request
// granted when its port frees).  Any opcode other than TL/TS/MM (NOP padding,
// OP_END in a lane that does not emit) leaves the carry as it is.  Returns 0,
// or the error code of a grant.
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

// ---------------------------------------------------------------------------
// The staging ring: one lane's instruction stream in shared memory
// ---------------------------------------------------------------------------

constexpr int kChunk = 256;    // positions a chunk (a multiple of jitarb.cu's kBlock)
constexpr int kStages = 3;     // chunks a ring holds: a chunk is filled two ahead

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One lane's ring of kStages chunks of a code column (int32 a position) and
// a value column (kW doubles a position).  A chunk covers the columns'
// positions [g kChunk, (g + 1) kChunk); every copy starts and ends on a
// 16-byte edge of the code column (4 positions), so a lane's first copy
// starts at lo rounded down and reads up to 3 positions before it.  The
// positions past the code column's last 16-byte edge are read by the thread
// itself: no copy reads past a column.  One thread runs a ring: it issues
// the copies and waits on the stages' barriers; `fills` counts every fill
// of the ring's life, so the barriers' phases carry over from one run to
// the next.
template <int kW>
struct RingT {
  // bytes of one ring in dynamic shared memory: values, then codes
  static constexpr int kBytes = kStages * kChunk * (4 + 8 * kW);

  int32_t* code_s;   // [kStages][kChunk], shared memory
  double* val_s;     // [kStages][kChunk][kW], shared memory
  uint64_t* bar;     // [kStages], shared memory
  unsigned fills;

  // ring `k` of the dynamic shared memory at `base`, with its barriers
  __device__ __forceinline__ RingT(unsigned char* base, int k, uint64_t* bars)
      : code_s(reinterpret_cast<int32_t*>(base + (size_t)k * kBytes +
                                          kStages * kChunk * 8 * kW)),
        val_s(reinterpret_cast<double*>(base + (size_t)k * kBytes)),
        bar(bars + k * kStages), fills(0) {}

  // the barriers' set-up, once, before any fill (then a CTA barrier)
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar + s)), "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // fill chunk g of the run [lo, hi) of columns of n positions
  __device__ __forceinline__ void fill(const int32_t* code, const double* val, long long n,
                                       long long lo, long long hi, long long g) {
    const int s = fills % kStages;
    const long long c0 = g * kChunk;
    const long long a = lo > c0 ? (lo & ~3LL) : c0;
    const long long e = (hi + 3) & ~3LL;
    const long long b = e < c0 + kChunk ? e : c0 + kChunk;
    const long long n16 = n & ~3LL;
    const long long bb = b < n16 ? b : n16;   // the copies' end
    int32_t* cs = code_s + s * kChunk;   // position p at cs[p - c0]
    double* vs = val_s + (size_t)s * kChunk * kW;
    for (long long p = bb; p < b && p < n; ++p) {   // past the code column's last edge
      cs[p - c0] = code[p];
      for (int w = 0; w < kW; ++w) vs[(p - c0) * kW + w] = val[p * kW + w];
    }
    const uint32_t n_copy = bb > a ? (uint32_t)(bb - a) : 0u;
    const uint32_t mb = smem_addr(bar + s);
    // the stage's last reads (generic proxy) come before the copies' writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
                 "r"(n_copy * (4u + 8u * kW))
                 : "memory");
    if (n_copy) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(cs + (a - c0))),
          "l"(code + a), "r"(n_copy * 4u), "r"(mb)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(vs + (a - c0) * kW)),
          "l"(val + a * kW), "r"(n_copy * 8u * kW), "r"(mb)
          : "memory");
    }
    ++fills;
  }

  // wait for fill number k of the ring's life; returns its stage
  __device__ __forceinline__ int wait(unsigned k) const {
    const int s = k % kStages;
    const uint32_t mb = smem_addr(bar + s), parity = (k / kStages) & 1u;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(mb), "r"(parity)
          : "memory");
    }
    return s;
  }

  // Run chunk(c0, k0, k1, cs, vs) over the chunks of the positions [lo, hi)
  // of columns of n positions (code and val 16-byte aligned), in order: the
  // chunk's positions c0 + [k0, k1) are at cs[k] and vs + k kW in shared
  // memory.  Stops at the first chunk that returns an error and returns it
  // (or 0).  Every fill issued is waited for before the return, so the ring
  // is free for the next run.
  template <class Chunk>
  __device__ __forceinline__ int chunks(const int32_t* code, const double* val, long long n,
                                        long long lo, long long hi, Chunk&& chunk) {
    if (lo >= hi) return 0;
    const long long g0 = lo / kChunk, g1 = (hi - 1) / kChunk + 1;
    unsigned next = fills;   // the next fill to wait for
    long long gf = g0;       // the next chunk to fill
    for (; gf < g1 && gf < g0 + kStages - 1; ++gf) fill(code, val, n, lo, hi, gf);
    int err = 0;
    for (long long g = g0; g < g1 && !err; ++g) {
      const int s = wait(next++);
      if (gf < g1) fill(code, val, n, lo, hi, gf++);
      const long long c0 = g * kChunk;
      const int k0 = (int)((lo > c0 ? lo : c0) - c0);
      const int k1 = (int)((hi < c0 + kChunk ? hi : c0 + kChunk) - c0);
      err = chunk(c0, k0, k1, code_s + s * kChunk, val_s + (size_t)s * kChunk * kW);
    }
    while (next != fills) wait(next++);   // an error left fills in flight
    return err;
  }

  // Run body(pos, code, &val) over the positions [lo, hi), in order, until
  // it returns an error; returns it (or 0).
  template <class Body>
  __device__ __forceinline__ int run(const int32_t* code, const double* val, long long n,
                                     long long lo, long long hi, Body&& body) {
    return chunks(code, val, n, lo, hi,
                  [&](long long c0, int k0, int k1, const int32_t* cs, const double* vs) {
                    int err = 0;
                    for (int k = k0; k < k1; ++k) {
                      err = body(c0 + k, cs[k], vs + k * kW);
                      if (err) break;
                    }
                    return err;
                  });
  }
};

// the instruction stream's ring: one double a position
using Ring = RingT<1>;
constexpr int kRingBytes = Ring::kBytes;

}  // namespace fastsim
