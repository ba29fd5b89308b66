"""The serving batcher's whole-trace arbitration program: the hand-written
CUDA kernel, its wrapper, and the plain PyTorch version it is held against.

Counterpart of the JAX package's ``multicore/jitarb.py`` program (the
``lax.while_loop`` of ``_kernel``, jitted at ``:899`` and vmapped at
``:900-903``).  One call settles one arrival trace per variant: the boundary
event loop (each core's candidate start is the later of its queue head's
submit epoch and the epoch its running segment frees it; all cores sharing
the least candidate start together), each start's share relaxation over a
sliding ``2 S``-epoch window of per-epoch weight sums, the relaxation
rounds' block re-simulations resumed from a snapshot cache (one carry every
:data:`BLOCK` instructions), and -- for the reactive policies -- the
admission decisions, all in one launch.  The host side (planning, the
domain gate) is :mod:`repro_torch.multicore.jitarb`.

The inputs (built by ``repro_torch.multicore.jitarb``):

- the trace table: ``code`` int32 ``[R, L]`` (``fastsim_scan.pack_code``)
  and ``val`` float64 ``[R, L]`` (tile bytes of a TL/TS, valid rows of an
  MM), ``tr_len`` int32 ``[R]``; ``t2l`` int32 ``[U, C]`` the row of each
  (request shape, core), ``wt`` and ``est`` float64 ``[U, C]`` its span
  weight and its unthrottled cost estimate;
- the cores: ``lane_f`` float64 ``[C, 18]`` (``fastsim_scan.LANE_FIELDS``:
  the design, the ports, the epoch, the burst and the exact-division
  flags) and ``qtail0`` int32 ``[C]``;
- per variant: ``arrival`` float64 ``[V, N]`` (sorted, padded with inf),
  ``qidx`` int32 / ``qsub`` float64 ``[V, C, maxq]`` (the queues' prefill,
  ``fixed`` admission), ``tid_of`` int32 ``[V, N]`` (the shape of each
  arrival rank).

It returns ``finish`` and ``adm`` float64 ``[V, N]`` (finish cycles and
admit epochs by arrival rank) and ``stats`` float64 ``[V, 6]``
(:data:`STATS_FIELDS`).  A grant that never comes, a bucket walk that makes
no progress, a relaxation that has not converged after ``max_rounds`` and a
span longer than the window ``S`` are errors: the wrapper raises on them.
:func:`jitarb` takes the plain version for tensors on the CPU and launches
the kernel for tensors on the card (or raises).
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build
from .fastsim_scan import (CARRY_KEYS, LANE_FIELDS, NUM_TREGS, PlainLanes, _aligned,
                           _check_tensors, _spread, plain_state, pow2_or_inf)

#: the entry point's device kernel, as named in csrc/jitarb.cu
KERNEL_NAMES = {"jitarb": "jitarb_kernel"}
#: launches counted where the wrapper launches its kernel
launches = {key: 0 for key in KERNEL_NAMES}
#: launches by path: (where the round's shares lived -- "shared" or
#: "global" --, the issue rate's exact-division flag over the cores --
#: "all", "none" or "some"); the epoch's is always set (jitarb_cuda refuses
#: an epoch that is not a power of two)
launch_paths: collections.Counter = collections.Counter()

#: admission policies the program replays (csrc/jitarb.cu's mode codes)
MODES = ("fixed", "occupancy", "bandwidth", "predicted")
#: instructions between snapshots of the resume cache
BLOCK = 64
#: one snapshot: the eight register ready-times, then the scalars of the
#: step's carry (the plain lanes' CARRY_KEYS after ``rr``)
SNAP_FIELDS = tuple(f"r{k}" for k in range(NUM_TREGS)) + CARRY_KEYS[1:]
#: column of ``last_grant`` in a snapshot (a snapshot is valid below it)
SNAP_LG = SNAP_FIELDS.index("last_grant")
#: per-variant statistics: the longest span (epochs), the relaxation rounds,
#: the simulated blocks (each round's span of blocks over its lanes, as the
#: reference counts them), the error code, the blocks the lanes simulated
#: (summed over lanes) and the most any one lane simulated
STATS_FIELDS = ("mxn", "rounds", "blocks", "err", "lane_blocks", "max_lane_blocks")
ERR_NEVER_GRANTED, ERR_NO_PROGRESS, ERR_ROUNDS, ERR_WINDOW = 1, 2, 3, 4
_ERRORS = {
    ERR_NEVER_GRANTED: "tail share must be > 0: request can never be granted",
    ERR_NO_PROGRESS: "token bucket walk made no progress (epoch length below the "
                     "time's resolution)",
    ERR_ROUNDS: "share relaxation did not converge within max_rounds",
    ERR_WINDOW: "whole-trace arbitration window bound violated (a span is longer "
                "than the window S): the host span bound is unsound here",
}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    launch_paths.clear()


def raise_on(stats: torch.Tensor) -> None:
    """Raise the first error a variant reported."""
    for code in stats[:, 3].tolist():
        if code:
            raise RuntimeError(_ERRORS.get(int(code), f"jitarb error {int(code)}"))


# --------------------------------------------------------------------------
# the plain version: the program's arithmetic in float64 tensors, its
# while_loops as Python loops, each round's block re-simulation through the
# plain lanes of fastsim_scan
# --------------------------------------------------------------------------

class _Variant:
    """One arrival trace's run of the plain program (one CTA of the kernel)."""

    def __init__(self, tab: dict, v: int, sc: dict):
        self.tab, self.sc = tab, sc
        dev = tab["code"].device
        self.dev = dev
        C = tab["t2l"].shape[1]
        self.C = C
        self.N = tab["arrival"].shape[1]
        self.maxq = tab["qidx"].shape[2]
        self.S, self.W = sc["S"], 2 * sc["S"]
        self.NB = tab["code"].shape[1] // BLOCK
        self.arrival = tab["arrival"][v].tolist()
        self.tid_of = tab["tid_of"][v].tolist()
        self.qidx = tab["qidx"][v].tolist()
        self.qsub = tab["qsub"][v].tolist()
        self.qtail = tab["qtail0"].tolist()
        self.t2l = tab["t2l"].tolist()
        self.wt = tab["wt"].tolist()
        self.est = tab["est"].tolist()
        self.tr_len = tab["tr_len"].tolist()
        f64 = dict(dtype=torch.float64, device=dev)
        self.lane_f = tab["lane_f"]
        self.burst_t = tab["lane_f"][:, LANE_FIELDS.index("burst")].contiguous()
        self.qhead = [0] * C
        self.tid = [-1] * C
        self.cur = [0] * C
        self.start = [0.0] * C
        self.ends = [-math.inf] * C
        self.lg = [0.0] * C
        self.te = [0.0] * C
        self.wsum = torch.zeros(self.W, **f64)
        self.base = 0.0
        self.nw = 0.0
        self.finish = [0.0] * (self.N + 1)
        self.adm_ep = [0.0] * (self.N + 1)
        self.mxn = 0.0
        self.snaps = torch.empty((C, self.NB + 1, len(SNAP_FIELDS)), **f64)
        for lane in range(C):
            self._reset_snaps(lane)
        self.n_r = 0
        self.n_b = 0
        self.lane_blocks = [0] * C
        self.p_sh = torch.zeros((C, self.S), **f64)
        self.p_nsh = [-1.0] * C
        self.p_tail = [-1.0] * C
        self.reactive = sc["mode"] != 0
        self.n_arr = 0
        self.adm = 0 if self.reactive else sc["n_real"]
        self.dec_done = -math.inf
        self.t_dec = self.arrival[0] if self.reactive else math.inf

    def _reset_snaps(self, lane: int) -> None:
        # slot 0 is the fresh segment state; deeper slots start invalid (an
        # inf last_grant never precedes a dirty boundary)
        self.snaps[lane, 0] = _pack(plain_state(self.burst_t[lane:lane + 1]))[0]
        self.snaps[lane, 1:, SNAP_LG] = math.inf

    # ---- the outer loop -------------------------------------------------
    def run(self) -> None:
        C, E = self.C, self.sc["E"]
        while True:
            has_q = [self.qhead[c] < self.qtail[c] for c in range(C)]
            alive = any(has_q) or (self.reactive and self.adm < self.sc["n_real"])
            if not alive:
                break
            slot = [min(self.qhead[c], self.maxq - 1) for c in range(C)]
            nxt = [min(max(self.qidx[c][slot[c]], 0), self.N - 1) for c in range(C)]
            sub = [self.qsub[c][slot[c]] for c in range(C)]
            free = [max(self.start[c], float(math.ceil((self.start[c] * E + self.te[c]) / E)))
                    if self.tid[c] >= 0 else 0.0 for c in range(C)]
            b_c = [max(free[c], sub[c]) if has_q[c] else math.inf for c in range(C)]
            bstar = min(b_c)
            if not self.reactive or bstar <= self.t_dec:
                self._start_step(has_q, nxt, b_c, bstar)
            elif self.t_dec > self.dec_done:
                self._admit_step(has_q, free)
            else:
                self._resched_step(has_q, free, sub)

    def _start_step(self, has_q, nxt, b_c, bstar) -> None:
        """All cores sharing the least candidate start their queue heads,
        then the arbiter settles at that boundary."""
        for c in range(self.C):
            if has_q[c] and b_c[c] == bstar:
                self.tid[c] = self.tid_of[nxt[c]]
                self.cur[c] = nxt[c]
                self.start[c] = bstar
                self.ends[c] = math.inf
                self.lg[c] = 0.0
                self.te[c] = 0.0
                self.qhead[c] += 1
                self._reset_snaps(c)
                # a fresh span has no previous sim
                self.p_nsh[c] = -1.0
                self.p_tail[c] = -1.0
        for c in range(self.C):
            # the boundary event reopens every span still active here
            if self.tid[c] >= 0 and self.ends[c] > bstar:
                self.ends[c] = math.inf
        self._settle(bstar)
        E = self.sc["E"]
        for c in range(self.C):
            if self.tid[c] >= 0:
                self.finish[self.cur[c]] = self.start[c] * E + self.te[c]

    def _admit_step(self, has_q, free) -> None:
        """The host driver's decision epoch at ``t_dec``: enqueue arrivals,
        admit under the policy, record admit epochs."""
        C, E, sc = self.C, self.sc["E"], self.sc
        budget, mode, kmax, N, maxq = sc["budget"], sc["mode"], sc["kmax"], self.N, self.maxq
        t = self.t_dec
        n_arr = sum(1 for a in self.arrival if a <= t)
        n_wait = n_arr - self.adm
        n_act = sum(1 for c in range(C) if self.tid[c] >= 0 and self.start[c] <= t
                    and self.ends[c] > t)
        h = sum(1 for j in range(kmax)
                if j < n_wait and budget / float(n_act + j + 1) >= sc["min_share"])
        cap = min(n_wait, h)
        busy = [free[c] > t or has_q[c] for c in range(C)]
        fa = []
        for c in range(C):
            x = max(self.start[c] * E + self.te[c] if self.tid[c] >= 0 else 0.0, t * E)
            for j in range(self.qtail[c] - self.qhead[c]):
                sl = min(self.qhead[c] + j, maxq - 1)
                x = x + self.est[self.tid_of[min(max(self.qidx[c][sl], 0), N - 1)]][c]
            fa.append(x)
        adm = self.adm

        def enqueue(c: int, rank: int) -> None:
            col = min(self.qtail[c], maxq - 1)
            self.qidx[c][col] = rank
            self.qsub[c][col] = t
            self.qtail[c] += 1

        if mode in (1, 3):              # occupancy, predicted
            if mode == 1:
                pick = [not b for b in busy]
                take = min(cap, sum(pick))
                rank, k = [], 0
                for c in range(C):
                    rank.append(k)
                    k += pick[c]
            else:
                hz = (t + sc["lookahead"]) * E
                pick = [x <= hz for x in fa]
                take = min(cap, sum(pick))
                rank = [sum(1 for m in range(C) if pick[m] and (
                    fa[m] < fa[c] or (fa[m] == fa[c] and m < c))) for c in range(C)]
            for c in range(C):
                if pick[c] and rank[c] < take:
                    enqueue(c, adm + rank[c])
        else:                           # bandwidth: soonest-free placement
            take = cap
            fe = list(fa)
            for j in range(take):
                u = self.tid_of[min(max(adm + j, 0), N - 1)]
                key = [fe[c] + self.est[u][c] for c in range(C)]
                cj = key.index(min(key))        # the first minimal, as the host
                fe[cj] = key[cj]
                enqueue(cj, adm + j)
        for j in range(take):
            self.adm_ep[adm + j] = t
        # work conservation: an idle chip never starves a waiting request
        wc = take == 0 and n_wait > 0 and not any(busy)
        if wc:
            u = self.tid_of[min(max(adm, 0), N - 1)]
            key = [fa[c] + self.est[u][c] for c in range(C)]
            enqueue(key.index(min(key)), adm)
            self.adm_ep[adm] = t
        self.adm = adm + take + int(wc)
        self.n_arr = n_arr
        self.dec_done = t
        self.t_dec = t

    def _resched_step(self, has_q, free, sub) -> None:
        """The next decision epoch from the settled post-start state: the
        next arrival always, the chip's next event while requests wait."""
        C, n_real = self.C, self.sc["n_real"]
        cand = self.arrival[min(max(self.n_arr, 0), self.N - 1)] \
            if self.n_arr < n_real else math.inf
        evt = math.inf
        for c in range(C):
            f_evt = max(free[c], sub[c]) if has_q[c] else free[c]
            if (self.tid[c] >= 0 or has_q[c]) and f_evt > self.dec_done:
                evt = min(evt, f_evt)
        t2 = min(cand, evt if self.n_arr > self.adm else math.inf)
        if math.isinf(t2) and self.n_arr >= n_real:
            self.adm = n_real
        self.t_dec = t2

    # ---- the arbiter settle ---------------------------------------------
    def _settle(self, d: float) -> None:
        """Slide the weight-sum window up to ``max(base, d - S)``, zero the
        idle gap, then relax to the fixed point."""
        C, S, W, E, sc = self.C, self.S, self.W, self.sc["E"], self.sc
        budget, dev = sc["budget"], self.dev
        f64 = dict(dtype=torch.float64, device=dev)
        base2 = max(self.base, d - float(S))
        sh = int(base2 - self.base)
        iw = torch.arange(W, device=dev)
        src = iw + sh
        self.wsum = torch.where(src < W, self.wsum[src.clamp(0, W - 1)], 0.0)
        e_abs = base2 + iw.to(torch.float64)
        self.wsum = torch.where((e_abs >= self.nw) & (e_abs < d), 0.0, self.wsum)
        self.base = base2
        live = [self.tid[c] >= 0 for c in range(C)]
        need = [live[c] and math.isinf(self.ends[c]) for c in range(C)]
        tid_s = [max(self.tid[c], 0) for c in range(C)]
        row = [self.t2l[tid_s[c]][c] for c in range(C)]
        w = [self.wt[tid_s[c]][c] for c in range(C)]
        nblk = [(self.tr_len[row[c]] + BLOCK - 1) // BLOCK for c in range(C)]
        cutoff = [(d - self.start[c]) * E for c in range(C)]
        # the host arbiter folds weights over spans in its span order: start
        # epoch, then core index
        perm = sorted(range(C), key=lambda c: (self.start[c], c))
        k = torch.arange(S, device=dev, dtype=torch.float64)
        e = d + k
        w_t = torch.tensor(w, **f64)
        row_t = torch.tensor(row, dtype=torch.int64, device=dev)
        start_t = torch.tensor(self.start, **f64)
        lidx = ((start_t - base2).to(torch.int64)[:, None]
                + torch.arange(S, device=dev)[None, :]).clamp(0, W - 1)
        r = 0
        conv = False
        while not conv and r < sc["max_rounds"]:
            horizon = max([d] + [self.ends[c] for c in range(C)
                                 if live[c] and math.isfinite(self.ends[c])])
            hi = [horizon if math.isinf(self.ends[c]) else self.ends[c] for c in range(C)]
            open_ = [live[c] and math.isinf(self.ends[c]) for c in range(C)]
            win = torch.zeros(S, **f64)
            wf = 0.0
            for c in perm:
                if live[c]:
                    act = (self.start[c] <= e) & (e < hi[c])
                    win = torch.where(act, win + w[c], win)
                if open_[c]:
                    wf = wf + w[c]
            off = int(d - base2)
            self.wsum[off:off + S] = win
            n_sh = [horizon - self.start[c] if math.isinf(self.ends[c])
                    else self.ends[c] - self.start[c] for c in range(C)]
            for c in range(C):
                if need[c]:
                    self.mxn = max(self.mxn, n_sh[c])
            n_sh = [min(max(x, 0.0), float(S)) for x in n_sh]
            tail = [budget * w[c] / wf if open_[c] else budget for c in range(C)]
            shares = budget * w_t[:, None] / self.wsum[lidx]            # [C, S]
            m = [min(n_sh[c], self.p_nsh[c]) for c in range(C)]
            m_t = torch.tensor(m, **f64)
            diff = (k[None, :] < m_t[:, None]) & (shares != self.p_sh)
            first = torch.where(diff, k[None, :], math.inf).amin(1).tolist()
            sim = []
            fc = []
            for c in range(C):
                cap = m[c] if (n_sh[c] != self.p_nsh[c] or tail[c] != self.p_tail[c]) \
                    else math.inf
                fc.append(min(first[c], cap))
                sim.append(need[c] and math.isfinite(fc[c]))
            te_n, lg_n, blocks = self._resim(row_t, nblk, shares, n_sh, tail, sim, fc,
                                             cutoff)
            for c in range(C):
                if sim[c]:
                    self.te[c] = te_n[c]
                    self.lg[c] = lg_n[c]
                    self.p_sh[c] = shares[c]
                    self.p_nsh[c] = n_sh[c]
                    self.p_tail[c] = tail[c]
            new_ends = []
            for c in range(C):
                x = self.start[c] + float(math.floor(self.lg[c] / E)) + 1.0
                new_ends.append(min(x, self.ends[c]) if need[c] else self.ends[c])
            conv = all(new_ends[c] == self.ends[c] for c in range(C))
            self.ends = new_ends
            self.nw = horizon
            self.n_b += blocks
            r += 1
        self.n_r += r
        if not conv:
            raise RuntimeError(_ERRORS[ERR_ROUNDS])

    def _resim(self, row_t, nblk, shares, n_sh, tail, sim, fc, cutoff):
        """Re-simulate the ``sim`` lanes under this round's shares, each
        from its deepest snapshot whose last grant precedes the first
        epoch its visible schedule changed (or the settled cutoff)."""
        C, E, dev = self.C, self.sc["E"], self.dev
        lim = torch.tensor([max(fc[c] * E, cutoff[c]) for c in range(C)],
                           dtype=torch.float64, device=dev)
        valid = self.snaps[:, :, SNAP_LG] < lim[:, None]
        slots = torch.arange(self.NB + 1, device=dev)
        k0 = torch.where(valid, slots, 0).amax(1).tolist()
        for c in range(C):
            if sim[c]:
                self.lane_blocks[c] += max(0, nblk[c] - k0[c])
        blo = min([k0[c] for c in range(C) if sim[c]], default=self.NB + 1)
        bhi = max([nblk[c] for c in range(C) if sim[c]], default=0)
        carry = _unpack(self.snaps[torch.arange(C, device=dev), torch.tensor(k0, device=dev)])
        carry["walks"] = torch.zeros(C, dtype=torch.float64, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        n_sh_t = torch.tensor(n_sh, **f64)
        lanes = PlainLanes(self.lane_f, shares.reshape(-1),
                           torch.arange(C, device=dev) * self.S, n_sh_t, bucket=True,
                           tail=torch.tensor(tail, **f64), sched_end=n_sh_t * E)
        err = torch.zeros(C, dtype=torch.int32, device=dev)
        code, val = self.tab["code"], self.tab["val"]
        sim_t = torch.tensor(sim, device=dev)
        k0_t = torch.tensor(k0, device=dev)
        nblk_t = torch.tensor(nblk, device=dev)
        iota = torch.arange(BLOCK, **f64)
        for b in range(blo, bhi):
            act_b = sim_t & (k0_t <= b) & (b < nblk_t)
            # the block's codes, values and instruction indices, a column
            # per step
            cols = slice(b * BLOCK, (b + 1) * BLOCK)
            cs, vs = code[row_t, cols].unbind(1), val[row_t, cols].unbind(1)
            lis = (iota + float(b * BLOCK)).expand(C, BLOCK).unbind(1)
            for j in range(BLOCK):
                err = lanes.step(carry, cs[j], vs[j], lis[j], act_b & (err == 0), err)
            code_max = int(err.max())
            if code_max:
                raise RuntimeError(_ERRORS[code_max])
            packed = _pack(carry)
            self.snaps[:, b + 1] = torch.where(act_b[:, None], packed, self.snaps[:, b + 1])
        return (carry["t_end"].tolist(), carry["last_grant"].tolist(), max(0, bhi - blo))


def _pack(s: dict) -> torch.Tensor:
    """A carry of the plain lanes as snapshot rows [L, len(SNAP_FIELDS)]."""
    cols = [s["rr"]] + [s[key].to(torch.float64)[:, None] for key in CARRY_KEYS[1:]]
    return torch.cat(cols, 1)


def _unpack(rows: torch.Tensor) -> dict:
    s = {"rr": rows[:, :NUM_TREGS].clone()}
    for j, key in enumerate(CARRY_KEYS[1:]):
        s[key] = rows[:, NUM_TREGS + j].clone()
    s["have_prev"] = s["have_prev"] != 0.0
    return s


def _scalars(E, budget, burst, min_share, lookahead, n_real, mode, S, kmax, max_rounds) -> dict:
    return dict(E=float(E), budget=float(budget), burst=float(burst),
                min_share=float(min_share), lookahead=float(lookahead), n_real=int(n_real),
                mode=MODES.index(mode), S=int(S), kmax=int(kmax), max_rounds=int(max_rounds))


def jitarb_plain(code, val, tr_len, t2l, wt, est, lane_f, qtail0, arrival, qidx, qsub, tid_of,
                 *, E, budget, burst, min_share, lookahead, n_real, mode, S, kmax,
                 max_rounds) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the program: each variant in turn, on the
    tensors' device.  Returns ``finish``, ``adm`` [V, N] and ``stats``
    [V, 4]; raises on an error."""
    sc = _scalars(E, budget, burst, min_share, lookahead, n_real, mode, S, kmax, max_rounds)
    tab = dict(code=code, val=val, tr_len=tr_len, t2l=t2l, wt=wt, est=est, lane_f=lane_f,
               qtail0=qtail0, arrival=arrival, qidx=qidx, qsub=qsub, tid_of=tid_of)
    V, N = arrival.shape
    f64 = dict(dtype=torch.float64, device=code.device)
    finish = torch.zeros((V, N), **f64)
    adm = torch.zeros((V, N), **f64)
    stats = torch.zeros((V, len(STATS_FIELDS)), **f64)
    for v in range(V):
        run = _Variant(tab, v, sc)
        run.run()
        if run.mxn > sc["S"]:
            raise RuntimeError(_ERRORS[ERR_WINDOW])
        finish[v] = torch.tensor(run.finish[:N], **f64)
        adm[v] = torch.tensor(run.adm_ep[:N], **f64)
        stats[v] = torch.tensor([run.mxn, run.n_r, run.n_b, 0.0, sum(run.lane_blocks),
                                 max(run.lane_blocks)], **f64)
    return finish, adm, stats


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

_DTYPES = dict(code=torch.int32, val=torch.float64, tr_len=torch.int32, t2l=torch.int32,
               wt=torch.float64, est=torch.float64, lane_f=torch.float64, qtail0=torch.int32,
               arrival=torch.float64, qidx=torch.int32, qsub=torch.float64,
               tid_of=torch.int32)
#: the most cores a launch takes: one warp each in a CTA of at most 1024
#: threads
MAX_CORES = 32


def _lib():
    lib = _build.load("jitarb")
    if not getattr(lib, "_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.jitarb_launch.argtypes = ([p] * 12 + [i] * 12 + [d] * 5 + [p] * 7
                                      + [ctypes.POINTER(i), p])
        lib.jitarb_launch.restype = i
        lib.jitarb_share_capacity.argtypes = [i]
        lib.jitarb_share_capacity.restype = ctypes.c_longlong
        lib.jitarb_error_string.argtypes = [i]
        lib.jitarb_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def share_capacity(cores: int) -> int:
    """The most shares (cores x S doubles) a launch for ``cores`` keeps in
    shared memory on the current card; a larger window's shares live in
    device memory."""
    lib = _lib()
    got = int(lib.jitarb_share_capacity(int(cores)))
    _build.raise_if(-got if got < 0 else 0, lib.jitarb_error_string, "jitarb_share_capacity")
    return got


def jitarb_cuda(code, val, tr_len, t2l, wt, est, lane_f, qtail0, arrival, qidx, qsub, tid_of,
                *, E, budget, burst, min_share, lookahead, n_real, mode, S, kmax,
                max_rounds) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The program through ``jitarb_kernel``, on the current stream: one CTA
    per variant, one warp per core.  Raises on a CPU tensor, on shapes that
    disagree, and on an error a variant reports.  A trace table whose data
    does not start on a 16-byte edge is copied first.  ``E`` must be a power
    of two or inf, as the planner makes it (the kernel's epoch index is
    ``floor(t * (1 / E))``)."""
    what = "jitarb"
    if not pow2_or_inf(E):
        raise ValueError(f"{what}: the epoch E={E} is not a power of two")
    tensors = dict(code=code, val=val, tr_len=tr_len, t2l=t2l, wt=wt, est=est, lane_f=lane_f,
                   qtail0=qtail0, arrival=arrival, qidx=qidx, qsub=qsub, tid_of=tid_of)
    dev = _check_tensors(what, tensors, _DTYPES)
    R, L = code.shape
    U, C = t2l.shape
    V, N = arrival.shape
    maxq = qidx.shape[2]
    if (tuple(val.shape) != (R, L) or tuple(tr_len.shape) != (R,) or L % BLOCK
            or tuple(wt.shape) != (U, C) or tuple(est.shape) != (U, C)
            or tuple(lane_f.shape) != (C, len(LANE_FIELDS)) or tuple(qtail0.shape) != (C,)
            or tuple(qidx.shape) != (V, C, maxq) or tuple(qsub.shape) != (V, C, maxq)
            or tuple(tid_of.shape) != (V, N) or not 1 <= C <= MAX_CORES or N < 1 or S < 1):
        raise ValueError(f"{what}: inconsistent shapes: code {tuple(code.shape)}, t2l "
                         f"{tuple(t2l.shape)}, lane_f {tuple(lane_f.shape)}, arrival "
                         f"{tuple(arrival.shape)}, qidx {tuple(qidx.shape)}, S {S} "
                         f"(L a multiple of {BLOCK}, 1 <= C <= {MAX_CORES})")
    sc = _scalars(E, budget, burst, min_share, lookahead, n_real, mode, S, kmax, max_rounds)
    f64 = dict(dtype=torch.float64, device=dev)
    nb = L // BLOCK
    finish = torch.empty((V, N + 1), **f64)
    adm = torch.empty((V, N + 1), **f64)
    stats = torch.empty((V, len(STATS_FIELDS)), **f64)
    # workspace: the weight-sum window, this round's and the last sim's
    # shares, the snapshot cache, the queues the admission step appends to
    wsum = torch.empty((V, 2 * S), **f64)
    shares = torch.empty((V, C, S), **f64)
    p_sh = torch.empty((V, C, S), **f64)
    snaps = torch.empty((V, C, nb + 1, len(SNAP_FIELDS)), **f64)
    q_idx = qidx.clone()
    q_sub = qsub.clone()
    code, val = _aligned(code), _aligned(val)
    lib = _lib()
    staged = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jitarb_launch(
            code.data_ptr(), val.data_ptr(), tr_len.data_ptr(), t2l.data_ptr(),
            wt.data_ptr(), est.data_ptr(), lane_f.data_ptr(), qtail0.data_ptr(),
            arrival.data_ptr(), q_idx.data_ptr(), q_sub.data_ptr(), tid_of.data_ptr(),
            V, C, N, maxq, R, L, U, sc["S"], sc["mode"], sc["kmax"], sc["max_rounds"],
            sc["n_real"], sc["E"], sc["budget"], sc["burst"], sc["min_share"],
            sc["lookahead"], wsum.data_ptr(), shares.data_ptr(), p_sh.data_ptr(),
            snaps.data_ptr(), finish.data_ptr(), adm.data_ptr(), stats.data_ptr(),
            ctypes.byref(staged), stream)
    _build.raise_if(rc, lib.jitarb_error_string, "jitarb launch")
    launches["jitarb"] += 1
    issue_pow2 = lane_f[:, LANE_FIELDS.index("issue_pow2")].cpu().numpy() != 0
    launch_paths[("shared" if staged.value else "global", _spread(issue_pow2))] += 1
    raise_on(stats.cpu())
    return finish[:, :N], adm[:, :N], stats


def jitarb(*args, **kw) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole-trace program: the plain version for tensors on the CPU,
    the kernel for tensors on the card."""
    if args[0].device.type == "cpu":
        return jitarb_plain(*args, **kw)
    return jitarb_cuda(*args, **kw)
