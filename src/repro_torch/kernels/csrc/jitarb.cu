// The serving batcher's whole-trace arbitration program, hand-written for
// Hopper (sm_90a), with a plain C interface for ctypes (kernels/jitarb.py).
//
// Replaces the JAX package's multicore/jitarb.py program: the
// lax.while_loop of _kernel (jitarb.py:462), jitted at :899 and vmapped at
// :900-903.  One launch settles a whole arrival trace per CTA: the boundary
// event loop, each start's share relaxation over a sliding window of
// per-epoch weight sums, the relaxation rounds' block re-simulations
// (resumed from a snapshot cache), and the reactive admission decisions.
//
// Design:
//  * one CTA per arrival trace (variant): finish_admit_times launches one,
//    finish_times_many one per variant of an arrival-rate sweep, over trace
//    columns shared by all of them;
//  * one warp per core lane (up to 8 cores; past that a warp takes several):
//    the lane's token-bucket scan runs on the warp's first thread (the step
//    of fastsim_step.cuh, as the scan kernels run it), fed by the warp's own
//    TMA staging ring (fastsim_step.cuh) whose chunks start on snapshot
//    blocks, so a resume from a snapshot starts a chunk; the warp's other
//    threads search the snapshot cache; lanes in different warps never wait
//    on each other's branches;
//  * the scalar loop on thread 0, between __syncthreads(): the boundary
//    choice, the admission decisions, and the folds over the lanes;
//  * the per-epoch weight sums fold in the host arbiter's span order (start
//    epoch, then core index): each thread takes epochs, never lanes, so one
//    epoch's sum is one thread's sequential fold, bit for bit the host's;
//  * the weight-sum window is a ring of 2 S epochs (slot = epoch mod 2 S):
//    sliding it zeroes the epochs that enter, nothing moves;
//  * state: the lanes' carry, queue heads and loop scalars in shared memory,
//    and this round's C x S shares where they fit beside the warps' rings
//    (else in global memory, the launcher's choice); the window, the last
//    simulated shares, the snapshot cache ([C, NB + 1, 22] doubles, one
//    carry every 64 instructions), the queues and the outputs in global
//    memory (workspace from the wrapper).
//
// What bounds it: the dependent chain of the scan step (tens of dependent
// fp64 operations an instruction) on one thread per lane, times the
// instructions every relaxation round re-simulates; the bytes (the trace
// columns, the snapshots) and the card's fp64 rate are far from the limit.
// The design keeps the chain fed and short: its instructions come from
// shared memory through the ring, its shares from shared memory where they
// fit, and the epoch index and issue time are exact products, not divisions
// on the chain: the epoch is always a power of two (the planner takes no
// other, the wrapper refuses one), the issue rate where lane_f flags it.  Nothing runs a lane's chain faster than one
// thread: the program's rounds are sequential.
//
// Bit-equality with the numpy client (multicore/online.py) follows from the
// reference program's argument and from one transcription of the step
// (fastsim_step.cuh, built with -fmad=false): every share is
// budget * w / wsum[e], every boundary floor/ceil is exact at power-of-two
// epochs, and the folds keep the host's order.

#include "fastsim_step.cuh"

namespace {

using namespace fastsim;

constexpr int kBlock = 64;        // instructions between snapshots
constexpr int kMaxC = 32;         // cores
constexpr int kMaxWarps = 8;      // warps of a CTA: one per core up to 8 cores
constexpr int kSnap = 22;         // doubles of a snapshot (kernels/jitarb.py, SNAP_FIELDS)
constexpr int kSnapLg = 19;       // its last_grant
constexpr int kStats = 6;         // per-variant statistics (kernels/jitarb.py, STATS_FIELDS)
constexpr int MODE_FIXED = 0, MODE_OCC = 1, MODE_PRED = 3;  // else bandwidth (2)
constexpr int ERR_ROUNDS = 3, ERR_WINDOW = 4;
constexpr int ACT_STOP = 0, ACT_START = 1, ACT_ADMIT = 2, ACT_RESCHED = 3;
constexpr int kNoDiff = 0x7fffffff;

struct Params {
  const int32_t* code;
  const double* val;
  const int32_t* tr_len;
  const int32_t* t2l;
  const double* wt;
  const double* est;
  const double* lane_f;
  const int32_t* qtail0;
  const double* arrival;
  int32_t* qidx;
  double* qsub;
  const int32_t* tid_of;
  int V, C, N, maxq, R, L, U, S, mode, kmax, max_rounds, n_real;
  int sh_staged;   // this round's shares live in shared memory
  double E, budget, burst, min_share, lookahead;
  double* wsum;
  double* shares;
  double* p_sh;
  double* snaps;
  double* finish;
  double* adm;
  double* stats;
};

// the lanes' state and the loop scalars (shared memory)
struct State {
  int tid[kMaxC], cur[kMaxC], qhead[kMaxC], qtail[kMaxC], row[kMaxC], nblk[kMaxC];
  int perm[kMaxC], k0[kMaxC], fcmin[kMaxC], err[kMaxC];
  double start[kMaxC], ends[kMaxC], lg[kMaxC], te[kMaxC], pnsh[kMaxC], ptail[kMaxC];
  double w[kMaxC], nsh[kMaxC], tail[kMaxC], hi[kMaxC], m[kMaxC], lim[kMaxC];
  double cutoff[kMaxC], te_n[kMaxC], lg_n[kMaxC], lane_blocks[kMaxC];
  bool live[kMaxC], need[kMaxC], sim[kMaxC], reset[kMaxC];
  unsigned fills[kMaxWarps];   // each warp's ring fills (its barriers' phases)
  double base, old_base, base2, nw, mxn, d, horizon, dec_done, t_dec;
  int n_r, n_b, n_arr, adm, action, conv, r, err_all, stop;
};

__device__ __forceinline__ long long slot_of(double e, long long W) {
  return (long long)e % W;
}

__device__ __forceinline__ double dmax(double a, double b) { return b > a ? b : a; }
__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }

__device__ __forceinline__ void pack(const Carry& s, double* o) {
#pragma unroll
  for (int k = 0; k < NREG; ++k) o[k] = s.reg[k];
  o[8] = s.p_ff_start;
  o[9] = s.p_ff_end;
  o[10] = s.p_fs_end;
  o[11] = s.p_dr_end;
  o[12] = s.have_prev ? 1.0 : 0.0;
  o[13] = s.wl_port_free;
  o[14] = s.t_end;
  o[15] = (double)s.wl_skips;
  o[16] = s.bw_stall;
  o[17] = s.next_free;
  o[18] = s.store_next;
  o[19] = s.last_grant;
  o[20] = s.tokens;
  o[21] = s.bt;
}

__device__ __forceinline__ void unpack(const double* o, Carry& s) {
#pragma unroll
  for (int k = 0; k < NREG; ++k) s.reg[k] = o[k];
  s.p_ff_start = o[8];
  s.p_ff_end = o[9];
  s.p_fs_end = o[10];
  s.p_dr_end = o[11];
  s.have_prev = o[12] != 0.0;
  s.wl_port_free = o[13];
  s.t_end = o[14];
  s.wl_skips = (long long)o[15];
  s.bw_stall = o[16];
  s.next_free = o[17];
  s.store_next = o[18];
  s.last_grant = o[19];
  s.tokens = o[20];
  s.bt = o[21];
  s.walks = 0;
}

// snapshot slot 0 of a started lane is the fresh segment state; deeper
// slots start invalid (an inf last_grant never precedes a dirty boundary)
__device__ void reset_snaps(State& st, double* snaps, int C, int NB, double burst) {
  const int n = C * (NB + 1);
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int l = idx / (NB + 1), j = idx % (NB + 1);
    if (!st.reset[l]) continue;
    double* o = snaps + ((size_t)l * (NB + 1) + j) * kSnap;
    if (j == 0) {
      Carry s;
      s.reset(burst);
      pack(s, o);
    } else {
      o[kSnapLg] = INFINITY;
    }
  }
}

// thread 0: the head of the outer loop -- the boundary choice, and the
// start, admission or rescheduling step it leads to (starting lanes are
// flagged for the snapshot reset; the settle follows on the whole CTA)
__device__ void head(const Params& p, State& st, const double* arrival, const int32_t* tid_of,
                     int32_t* qidx, double* qsub, double* adm_ep) {
  const int C = p.C, N = p.N, maxq = p.maxq;
  const double E = p.E;
  const bool reactive = p.mode != MODE_FIXED;
  bool has_q[kMaxC];
  int nxt[kMaxC];
  double sub[kMaxC], freee[kMaxC], b_c[kMaxC];
  bool any_q = false;
  double bstar = INFINITY;
  for (int l = 0; l < C; ++l) {
    has_q[l] = st.qhead[l] < st.qtail[l];
    any_q |= has_q[l];
    const int slot = min(st.qhead[l], maxq - 1);
    nxt[l] = min(max((int)qidx[l * maxq + slot], 0), N - 1);
    sub[l] = qsub[l * maxq + slot];
    freee[l] = st.tid[l] >= 0 ? dmax(st.start[l], ceil((st.start[l] * E + st.te[l]) / E)) : 0.0;
    b_c[l] = has_q[l] ? dmax(freee[l], sub[l]) : INFINITY;
    bstar = dmin(bstar, b_c[l]);
  }
  const bool alive = any_q || (reactive && st.adm < p.n_real);
  if (!alive) {
    st.action = ACT_STOP;
    return;
  }
  if (!reactive || bstar <= st.t_dec) {
    // all cores sharing the least candidate start their queue heads
    for (int l = 0; l < C; ++l) {
      st.reset[l] = false;
      if (has_q[l] && b_c[l] == bstar) {
        st.tid[l] = tid_of[nxt[l]];
        st.cur[l] = nxt[l];
        st.start[l] = bstar;
        st.ends[l] = INFINITY;
        st.lg[l] = 0.0;
        st.te[l] = 0.0;
        st.qhead[l] += 1;
        st.reset[l] = true;
        st.pnsh[l] = -1.0;   // a fresh span has no previous sim
        st.ptail[l] = -1.0;
      }
    }
    // the boundary event reopens every span still active here
    for (int l = 0; l < C; ++l)
      if (st.tid[l] >= 0 && st.ends[l] > bstar) st.ends[l] = INFINITY;
    st.d = bstar;
    st.action = ACT_START;
    return;
  }
  if (st.t_dec > st.dec_done) {
    // the host driver's decision epoch at t_dec: enqueue arrivals, admit
    // under the policy, record admit epochs
    const double t = st.t_dec;
    int n_arr = 0;
    for (int i = 0; i < N; ++i) n_arr += arrival[i] <= t;
    const int n_wait = n_arr - st.adm;
    int n_act = 0;
    for (int l = 0; l < C; ++l)
      n_act += st.tid[l] >= 0 && st.start[l] <= t && st.ends[l] > t;
    int h = 0;
    for (int j = 0; j < p.kmax; ++j)
      h += j < n_wait && p.budget / (double)(n_act + j + 1) >= p.min_share;
    const int cap = min(n_wait, h);
    bool busy[kMaxC], any_busy = false;
    double fa[kMaxC];
    for (int l = 0; l < C; ++l) {
      busy[l] = freee[l] > t || has_q[l];
      any_busy |= busy[l];
      double x = dmax(st.tid[l] >= 0 ? st.start[l] * E + st.te[l] : 0.0, t * E);
      const int depth = st.qtail[l] - st.qhead[l];
      for (int j = 0; j < depth; ++j) {
        const int sl = min(st.qhead[l] + j, maxq - 1);
        const int u = tid_of[min(max((int)qidx[l * maxq + sl], 0), N - 1)];
        x = x + p.est[(size_t)u * C + l];
      }
      fa[l] = x;
    }
    const int adm = st.adm;
    auto enqueue = [&](int l, int rank) {
      const int col = min(st.qtail[l], maxq - 1);
      qidx[l * maxq + col] = rank;
      qsub[l * maxq + col] = t;
      st.qtail[l] += 1;
    };
    int take;
    if (p.mode == MODE_OCC || p.mode == MODE_PRED) {
      bool pick[kMaxC];
      int rank[kMaxC], n_pick = 0;
      const double hz = (t + p.lookahead) * E;
      for (int l = 0; l < C; ++l) {
        pick[l] = p.mode == MODE_OCC ? !busy[l] : fa[l] <= hz;
        n_pick += pick[l];
      }
      take = min(cap, n_pick);
      int k = 0;
      for (int l = 0; l < C; ++l) {
        if (p.mode == MODE_OCC) {
          rank[l] = k;   // rank among the idle cores, ascending core index
          k += pick[l];
        } else {
          // the host's stable sort by free_at
          int before = 0;
          for (int m2 = 0; m2 < C; ++m2)
            before += pick[m2] && (fa[m2] < fa[l] || (fa[m2] == fa[l] && m2 < l));
          rank[l] = before;
        }
      }
      for (int l = 0; l < C; ++l)
        if (pick[l] && rank[l] < take) enqueue(l, adm + rank[l]);
    } else {  // bandwidth: headroom-gated, soonest-free placed
      take = cap;
      double fe[kMaxC];
      for (int l = 0; l < C; ++l) fe[l] = fa[l];
      for (int j = 0; j < take; ++j) {
        const int u = tid_of[min(max(adm + j, 0), N - 1)];
        int cj = 0;
        double best = fe[0] + p.est[(size_t)u * C];
        for (int l = 1; l < C; ++l) {
          const double key = fe[l] + p.est[(size_t)u * C + l];
          if (key < best) {   // the first minimal, as the host's min()
            best = key;
            cj = l;
          }
        }
        fe[cj] = best;
        enqueue(cj, adm + j);
      }
    }
    for (int j = 0; j < take; ++j) adm_ep[adm + j] = t;
    // work conservation: an idle chip never starves a waiting request
    const bool wc = take == 0 && n_wait > 0 && !any_busy;
    if (wc) {
      const int u = tid_of[min(max(adm, 0), N - 1)];
      int cw = 0;
      double best = fa[0] + p.est[(size_t)u * C];
      for (int l = 1; l < C; ++l) {
        const double key = fa[l] + p.est[(size_t)u * C + l];
        if (key < best) {
          best = key;
          cw = l;
        }
      }
      enqueue(cw, adm);
      adm_ep[adm] = t;
    }
    st.adm = adm + take + (wc ? 1 : 0);
    st.n_arr = n_arr;
    st.dec_done = t;
    st.t_dec = t;
    st.action = ACT_ADMIT;
    return;
  }
  // the next decision epoch: the next arrival always, the chip's next
  // event while requests wait
  const double cand = st.n_arr < p.n_real ? arrival[min(max(st.n_arr, 0), N - 1)] : INFINITY;
  double evt = INFINITY;
  for (int l = 0; l < C; ++l) {
    const double f_evt = has_q[l] ? dmax(freee[l], sub[l]) : freee[l];
    if ((st.tid[l] >= 0 || has_q[l]) && f_evt > st.dec_done) evt = dmin(evt, f_evt);
  }
  const double t2 = dmin(cand, st.n_arr > st.adm ? evt : INFINITY);
  if (isinf(t2) && st.n_arr >= p.n_real) st.adm = p.n_real;
  st.t_dec = t2;
  st.action = ACT_RESCHED;
}

// The settle at boundary st.d on the whole CTA: slide the window, zero the
// idle gap, then relax to the fixed point.  `shares` is this round's table
// (shared or global memory), `smem` the warps' rings.
__device__ void settle(const Params& p, State& st, double* ring, double* shares, double* p_sh,
                       double* snaps, unsigned char* smem, uint64_t* bars) {
  const int C = p.C, S = p.S, NB = p.L / kBlock;
  const long long W = 2LL * S;
  const double E = p.E, budget = p.budget, d = st.d;
  const int tx = threadIdx.x, nth = blockDim.x;
  const int warp = tx >> 5, lane_t = tx & 31;
  if (tx == 0) {
    st.old_base = st.base;
    st.base2 = dmax(st.base, d - (double)S);
    for (int l = 0; l < C; ++l) {
      st.live[l] = st.tid[l] >= 0;
      st.need[l] = st.live[l] && isinf(st.ends[l]);
      const int u = max(st.tid[l], 0);
      st.row[l] = p.t2l[(size_t)u * C + l];
      st.w[l] = p.wt[(size_t)u * C + l];
      st.nblk[l] = (p.tr_len[st.row[l]] + kBlock - 1) / kBlock;
      st.cutoff[l] = (d - st.start[l]) * E;
      st.perm[l] = l;
    }
    // the host's span order: start epoch, then core index
    for (int a = 1; a < C; ++a) {
      const int x = st.perm[a];
      const double kx = st.start[x] * C + (double)x;
      int b = a - 1;
      while (b >= 0 && st.start[st.perm[b]] * C + (double)st.perm[b] > kx) {
        st.perm[b + 1] = st.perm[b];
        --b;
      }
      st.perm[b + 1] = x;
    }
  }
  __syncthreads();
  {
    const double base2 = st.base2, old_end = st.old_base + (double)W, nw = st.nw;
    for (long long i = tx; i < W; i += nth) {
      const double e = base2 + (double)i;
      if (e >= old_end || (e >= nw && e < d)) ring[slot_of(e, W)] = 0.0;
    }
  }
  if (tx == 0) {
    st.base = st.base2;
    st.r = 0;
    st.conv = 0;
    st.stop = 0;
  }
  __syncthreads();
  const double base2 = st.base2;
  while (true) {
    if (tx == 0) {
      double horizon = d;
      for (int l = 0; l < C; ++l)
        if (st.live[l] && isfinite(st.ends[l])) horizon = dmax(horizon, st.ends[l]);
      double wf = 0.0;
      for (int j = 0; j < C; ++j) {
        const int l = st.perm[j];
        if (st.live[l] && isinf(st.ends[l])) wf = wf + st.w[l];
      }
      for (int l = 0; l < C; ++l) {
        const bool open = st.live[l] && isinf(st.ends[l]);
        st.hi[l] = isinf(st.ends[l]) ? horizon : st.ends[l];
        const double n_sh = isinf(st.ends[l]) ? horizon - st.start[l] : st.ends[l] - st.start[l];
        if (st.need[l]) st.mxn = dmax(st.mxn, n_sh);
        st.nsh[l] = dmin(dmax(n_sh, 0.0), (double)S);
        st.tail[l] = open ? budget * st.w[l] / wf : budget;
        st.m[l] = dmin(st.nsh[l], st.pnsh[l]);
        st.fcmin[l] = kNoDiff;
      }
      st.horizon = horizon;
    }
    __syncthreads();
    // per-epoch weight sums: a thread per epoch, the lanes in span order
    for (int k = tx; k < S; k += nth) {
      const double e = d + (double)k;
      double win = 0.0;
      for (int j = 0; j < C; ++j) {
        const int l = st.perm[j];
        if (st.live[l] && st.start[l] <= e && e < st.hi[l]) win = win + st.w[l];
      }
      ring[slot_of(e, W)] = win;
    }
    __syncthreads();
    // this round's shares, and the first epoch each differs from the last sim
    for (long long idx = tx; idx < (long long)C * S; idx += nth) {
      const int l = (int)(idx / S), k = (int)(idx % S);
      long long li = (long long)(st.start[l] - base2) + k;
      li = li < 0 ? 0 : (li > W - 1 ? W - 1 : li);
      const double sh = budget * st.w[l] / ring[slot_of(base2 + (double)li, W)];
      shares[idx] = sh;
      if ((double)k < st.m[l] && sh != p_sh[idx]) atomicMin(&st.fcmin[l], k);
    }
    __syncthreads();
    if (tx == 0) {
      for (int l = 0; l < C; ++l) {
        double fc = st.fcmin[l] == kNoDiff ? INFINITY : (double)st.fcmin[l];
        const double cap =
            (st.nsh[l] != st.pnsh[l] || st.tail[l] != st.ptail[l]) ? st.m[l] : INFINITY;
        fc = dmin(fc, cap);
        st.sim[l] = st.need[l] && isfinite(fc);
        st.lim[l] = dmax(fc * E, st.cutoff[l]);
        st.err[l] = 0;
      }
    }
    __syncthreads();
    // the re-simulations: warp l runs lane l from its deepest valid snapshot
    // (a CTA has at most kMaxWarps warps: past that, warps take more lanes)
    for (int l = warp; l < C; l += nth >> 5) {
      if (!st.sim[l]) continue;
      const double* lsn = snaps + (size_t)l * (NB + 1) * kSnap;
      int best = 0;
      for (int j = lane_t; j <= NB; j += 32)
        if (lsn[(size_t)j * kSnap + kSnapLg] < st.lim[l]) best = j;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(0xffffffffu, best, o));
      if (lane_t == 0) {
        st.k0[l] = best;
        Carry s;
        unpack(lsn + (size_t)best * kSnap, s);
        const Design dz(p.lane_f + (size_t)l * kLaneF);
        const double nsh = st.nsh[l];
        const Bucket bk{shares + (size_t)l * S, (long long)nsh, E, st.tail[l], p.burst,
                        nsh * E, 1.0 / E, true};
        const size_t row = (size_t)st.row[l] * p.L;
        double* lsnap = snaps + (size_t)l * (NB + 1) * kSnap;
        const long long lo = (long long)best * kBlock, hi = (long long)st.nblk[l] * kBlock;
        Ring rg(smem, warp, bars);
        rg.fills = st.fills[warp];
        IssueClock clk(dz, lo);
        // a snapshot after every block; the blocks run whole (nblk * kBlock <= L)
        const int err = rg.run(p.code + row, p.val + row, p.L, lo, hi,
                               [&](long long i, int c, const double* vp) {
                                 const int e = step<true>(s, c, vp, clk.at(dz, i), dz, bk);
                                 if (!e && (i + 1) % kBlock == 0)
                                   pack(s, lsnap + (size_t)((i + 1) / kBlock) * kSnap);
                                 return e;
                               });
        st.fills[warp] = rg.fills;
        st.te_n[l] = s.t_end;
        st.lg_n[l] = s.last_grant;
        st.err[l] = err;
      }
    }
    __syncthreads();
    if (tx == 0) {
      int blo = NB + 1, bhi = 0;
      for (int l = 0; l < C; ++l) {
        if (!st.sim[l]) continue;
        st.lane_blocks[l] += (double)max(0, st.nblk[l] - st.k0[l]);
        blo = min(blo, st.k0[l]);
        bhi = max(bhi, st.nblk[l]);
        if (st.err[l] && !st.err_all) st.err_all = st.err[l];
        st.te[l] = st.te_n[l];
        st.lg[l] = st.lg_n[l];
        st.pnsh[l] = st.nsh[l];
        st.ptail[l] = st.tail[l];
      }
      st.n_b += max(0, bhi - blo);
      bool conv = true;
      for (int l = 0; l < C; ++l) {
        const double x = st.start[l] + floor(st.lg[l] / E) + 1.0;
        const double e_new = st.need[l] ? dmin(x, st.ends[l]) : st.ends[l];
        conv = conv && e_new == st.ends[l];
        st.ends[l] = e_new;
      }
      st.nw = st.horizon;
      st.r += 1;
      st.conv = conv;
      st.stop = st.err_all || conv || st.r >= p.max_rounds;
    }
    __syncthreads();
    for (long long idx = tx; idx < (long long)C * S; idx += nth)
      if (st.sim[idx / S]) p_sh[idx] = shares[idx];
    __syncthreads();
    if (st.stop) break;
  }
  if (tx == 0) {
    st.n_r += st.r;
    if (!st.conv && !st.err_all) st.err_all = ERR_ROUNDS;
  }
  __syncthreads();
}

// at most 256 threads a CTA, and one CTA an SM: ptxas may then give a thread
// up to 255 registers, and the scan step keeps its carry in them (with the
// thread count alone it stops at 128 and spills)
__global__ void __launch_bounds__(32 * kMaxWarps, 1) jitarb_kernel(Params p) {
  const int v = blockIdx.x;
  const int tx = threadIdx.x, nth = blockDim.x;
  const int C = p.C, N = p.N, S = p.S, maxq = p.maxq, NB = p.L / kBlock;
  const long long W = 2LL * S;
  const bool reactive = p.mode != MODE_FIXED;
  const double* arrival = p.arrival + (size_t)v * N;
  const int32_t* tid_of = p.tid_of + (size_t)v * N;
  int32_t* qidx = p.qidx + (size_t)v * C * maxq;
  double* qsub = p.qsub + (size_t)v * C * maxq;
  double* ring = p.wsum + (size_t)v * W;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kMaxWarps * kStages];
  // this round's shares: after the warps' rings where they fit
  double* shares = p.sh_staged
                       ? reinterpret_cast<double*>(smem + (size_t)(nth >> 5) * kRingBytes)
                       : p.shares + (size_t)v * C * S;
  double* p_sh = p.p_sh + (size_t)v * C * S;
  double* snaps = p.snaps + (size_t)v * C * (NB + 1) * kSnap;
  double* finish = p.finish + (size_t)v * (N + 1);
  double* adm_ep = p.adm + (size_t)v * (N + 1);
  __shared__ State st;

  for (long long i = tx; i < W; i += nth) ring[i] = 0.0;
  for (long long i = tx; i < (long long)C * S; i += nth) p_sh[i] = 0.0;
  for (int i = tx; i <= N; i += nth) finish[i] = adm_ep[i] = 0.0;
  if (tx < C) {
    const int l = tx;
    st.qhead[l] = 0;
    st.qtail[l] = p.qtail0[l];
    st.tid[l] = -1;
    st.cur[l] = 0;
    st.start[l] = 0.0;
    st.ends[l] = -INFINITY;
    st.lg[l] = 0.0;
    st.te[l] = 0.0;
    st.pnsh[l] = -1.0;
    st.ptail[l] = -1.0;
    st.reset[l] = true;
    st.lane_blocks[l] = 0.0;
  }
  if ((tx & 31) == 0) {
    Ring(smem, tx >> 5, bars).init();
    st.fills[tx >> 5] = 0;
  }
  if (tx == 0) {
    st.base = 0.0;
    st.nw = 0.0;
    st.mxn = 0.0;
    st.n_r = st.n_b = 0;
    st.n_arr = 0;
    st.adm = reactive ? 0 : p.n_real;
    st.dec_done = -INFINITY;
    st.t_dec = reactive ? arrival[0] : INFINITY;
    st.err_all = 0;
  }
  __syncthreads();
  reset_snaps(st, snaps, C, NB, p.burst);
  __syncthreads();
  while (true) {
    if (tx == 0) head(p, st, arrival, tid_of, qidx, qsub, adm_ep);
    __syncthreads();
    const int action = st.action;
    if (action == ACT_STOP) break;
    if (action == ACT_START) {
      reset_snaps(st, snaps, C, NB, p.burst);
      __syncthreads();
      settle(p, st, ring, shares, p_sh, snaps, smem, bars);
      if (st.err_all) break;
      if (tx == 0)
        for (int l = 0; l < C; ++l)
          if (st.tid[l] >= 0) finish[st.cur[l]] = st.start[l] * p.E + st.te[l];
    }
    __syncthreads();
  }
  if (tx == 0) {
    double* o = p.stats + (size_t)v * kStats;
    o[0] = st.mxn;
    o[1] = (double)st.n_r;
    o[2] = (double)st.n_b;
    o[3] = (double)(st.err_all ? st.err_all : (st.mxn > (double)S ? ERR_WINDOW : 0));
    double sum = 0.0, most = 0.0;
    for (int l = 0; l < C; ++l) {
      sum += st.lane_blocks[l];
      most = dmax(most, st.lane_blocks[l]);
    }
    o[4] = sum;
    o[5] = most;
  }
}

// the warps of a CTA for C cores: one a core, at least 4, at most kMaxWarps
int warps_for(int C) { return C < 4 ? 4 : (C > kMaxWarps ? kMaxWarps : C); }

// doubles of shares that fit in a CTA's shared memory beside the rings of
// its warps for C cores (< 0: a CUDA error)
long long share_slots(int C) {
  int dev, optin = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r == cudaSuccess)
    r = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes a;
  if (r == cudaSuccess) r = cudaFuncGetAttributes(&a, jitarb_kernel);
  if (r != cudaSuccess) return -(long long)r;
  const long long free = (long long)optin - (long long)a.sharedSizeBytes -
                         (long long)warps_for(C) * kRingBytes;
  return free > 0 ? free / (long long)sizeof(double) : 0;
}

}  // namespace

extern "C" {

// One launch of the program: one CTA per variant (V), one warp per core (C
// <= 32).  Inputs and workspace as kernels/jitarb.py documents them; qidx and
// qsub are the variants' own queues (the admission step appends to them).
// E is a power of two or inf (t // E == floor(t * (1 / E))).  *sh_staged gets 1 where this round's
// C x S shares live in shared memory, 0 where in the workspace `shares`.
// Returns the launch's cudaError_t.
int jitarb_launch(const void* code, const void* val, const void* tr_len, const void* t2l,
                  const void* wt, const void* est, const void* lane_f, const void* qtail0,
                  const void* arrival, void* qidx, void* qsub, const void* tid_of, int V, int C,
                  int N, int maxq, int R, int L, int U, int S, int mode, int kmax,
                  int max_rounds, int n_real, double E, double budget, double burst,
                  double min_share, double lookahead, void* wsum, void* shares, void* p_sh,
                  void* snaps, void* finish, void* adm, void* stats, int* sh_staged,
                  void* stream) {
  *sh_staged = 0;
  if (V <= 0) return 0;
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const long long slots = share_slots(C);
  if (slots < 0) return (int)-slots;
  Params p;
  p.code = static_cast<const int32_t*>(code);
  p.val = static_cast<const double*>(val);
  p.tr_len = static_cast<const int32_t*>(tr_len);
  p.t2l = static_cast<const int32_t*>(t2l);
  p.wt = static_cast<const double*>(wt);
  p.est = static_cast<const double*>(est);
  p.lane_f = static_cast<const double*>(lane_f);
  p.qtail0 = static_cast<const int32_t*>(qtail0);
  p.arrival = static_cast<const double*>(arrival);
  p.qidx = static_cast<int32_t*>(qidx);
  p.qsub = static_cast<double*>(qsub);
  p.tid_of = static_cast<const int32_t*>(tid_of);
  p.V = V;
  p.C = C;
  p.N = N;
  p.maxq = maxq;
  p.R = R;
  p.L = L;
  p.U = U;
  p.S = S;
  p.mode = mode;
  p.kmax = kmax;
  p.max_rounds = max_rounds;
  p.n_real = n_real;
  p.sh_staged = (long long)C * S <= slots;
  p.E = E;
  p.budget = budget;
  p.burst = burst;
  p.min_share = min_share;
  p.lookahead = lookahead;
  p.wsum = static_cast<double*>(wsum);
  p.shares = static_cast<double*>(shares);
  p.p_sh = static_cast<double*>(p_sh);
  p.snaps = static_cast<double*>(snaps);
  p.finish = static_cast<double*>(finish);
  p.adm = static_cast<double*>(adm);
  p.stats = static_cast<double*>(stats);
  const int warps = warps_for(C);
  const size_t smem = (size_t)warps * kRingBytes +
                      (p.sh_staged ? (size_t)C * S * sizeof(double) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        jitarb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (r != cudaSuccess) return (int)r;
  }
  jitarb_kernel<<<V, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(p);
  *sh_staged = p.sh_staged;
  return (int)cudaGetLastError();
}

// the most doubles of shares (C x S) that a launch for C cores keeps in
// shared memory, or the negated cudaError_t of the query
long long jitarb_share_capacity(int C) { return share_slots(C); }

const char* jitarb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
