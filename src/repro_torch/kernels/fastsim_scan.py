"""The RASA pipeline simulator's scan lanes: the hand-written CUDA kernels,
their wrappers, and the plain PyTorch versions they are held against.

Counterparts of the JAX package's two ``lax.scan`` programs in
``core/fastsim.py``:

``fastsim_scan``
    The full-stream scan (``_sim_chunk_fn``): each lane runs the scheduling
    recurrence of ``core/fastsim.py::run_segment`` over its own range of a
    compiled trace's columns, in float64, under the port model or the token
    bucket (``bucket``).  A lane is one (trace, design) pair of a sweep, one
    core, or (``n_seg`` > 0) a run of packed segments whose ``OP_END``
    markers emit each segment's results into a row and reset the carry.
``fastsim_mm_scan``
    The MM-only scan of the paper's port model (``_jax_mm_fn``): the
    ``rasa_mm`` rows of a trace, with the loads' and the free stores' times
    solved on the host (``core/fastsim.py::_sweep_port_mm``).
``fastsim_events``
    The telemetry's stage replay (the JAX package's ``obs/record.py``
    ``replay_events``, a Python loop there): the full-stream recurrence of
    one segment a lane, recording every instruction's events -- a TL's or
    TS's grant start and its throttle stall, an MM's WL/FF/FS/DR window --
    into a row of its position (:data:`EVENT_FIELDS`).

The columns (built by :mod:`repro_torch.core.fastsim`):

- full stream: ``code`` int32 per instruction, :func:`pack_code` (opcode,
  the three register ids, the WLBP reuse bit); ``val`` float64, the tile
  bytes of a TL/TS and the valid rows (``tm``) of an MM; ``lane_f`` float64
  ``[L, 18]`` in :data:`LANE_FIELDS` order (the last two: the flags of
  :func:`pow2_or_inf` for the epoch and the issue rate); ``lane_i`` int64
  ``[L, 4]``: the lane's trace range ``[lo, hi)`` and its shares' range in
  ``shares``;
- MM-only: ``code`` int32 per MM row, :func:`pack_mm_code`; ``val`` float64
  ``[rows, 6]`` (:data:`MM_VAL_FIELDS`); ``lane_f`` ``[L, 6]``
  (:data:`MM_LANE_FIELDS`); ``lane_rows`` int64 ``[L, 2]``.

The full stream's columns also feed ``fastsim_events`` (its lanes may not
overlap: each writes the event rows of its own positions).

``fastsim_scan``/``fastsim_mm_scan``/``fastsim_events`` take the plain
version for tensors on the CPU and launch the kernel for tensors on the card (or raise).  A request
that the bucket can never grant raises the numpy lane's ``RuntimeError``.
"""

from __future__ import annotations

import collections
import ctypes
import math
import sys

import numpy as np
import torch

from . import _build

#: the entry points' device kernels, as named in csrc/fastsim.cu
KERNEL_NAMES = {"scan": "fastsim_scan_kernel", "mm_scan": "fastsim_mm_kernel",
                "events": "fastsim_events_kernel"}
#: launches counted where the wrappers launch their kernels
launches = {key: 0 for key in KERNEL_NAMES}
#: the full-stream launches by path: (chains, where the shares were read --
#: "shared", "global", "mixed" or "none" under the port model --, the
#: epoch's and the issue rate's exact-division flags over the lanes --
#: "all", "none" or "some")
launch_paths: collections.Counter = collections.Counter()

#: fields of a full-stream lane (csrc/fastsim.cu reads them in this order)
LANE_FIELDS = ("wl", "fs", "dr", "issue", "load_lat", "wlbp", "wls", "pipe",
               "inv_load", "inv_store", "store_free", "charge", "epoch",
               "tail", "burst", "sched_end", "epoch_pow2", "issue_pow2")
#: fields of an MM-only lane, and the doubles of an MM row
MM_LANE_FIELDS = ("wl", "fs", "dr", "wlbp", "wls", "pipe")
MM_VAL_FIELDS = ("a_const", "b_const", "c_const", "tm", "t_issue", "ts_issue")
#: results per lane (and per emitted segment) of the full-stream scan
OUT_FIELDS = ("t_end", "wl_skips", "bw_stall", "last_grant", "walks")
#: an event row's fields by opcode (a row a position of the columns; the
#: rows of other opcodes stay 0), and the event replay's results per lane
EVENT_FIELDS = {"tl": ("start", "stall"), "ts": ("start", "stall"),
                "mm": ("wl_start", "ff_start", "ff_end", "fs_end", "dr_end")}
EVENT_OUT_FIELDS = ("t_end", "bw_stall", "wl_skips")

# csrc/fastsim.cu's constants (core/trace.py's opcodes, core/isa.py's registers)
OP_TL, OP_TS, OP_MM, OP_END = 0, 1, 2, 4
NUM_TREGS = 8
ERR_NEVER_GRANTED, ERR_NO_PROGRESS = 1, 2
# a lane's error slot before the kernel: no chain has failed (csrc/fastsim.cu
# keeps the least of (chain order * 4 + code) over a lane's chains)
_NO_ERROR = 2**31 - 1


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    launch_paths.clear()


def pow2_or_inf(x: float) -> bool:
    """Whether ``x`` is +inf or a normal power of two: then ``t / x`` and
    ``t * (1 / x)`` are the same value for every t, and for finite t >= 0
    Python's ``t // x`` is ``floor(t * (1 / x))`` bit for bit (the kernels
    take the product where this flag is set)."""
    x = float(x)
    return x == math.inf or (sys.float_info.min <= x < math.inf and math.frexp(x)[0] == 0.5)


def chain_table(ranges: np.ndarray, markers: np.ndarray | None) -> np.ndarray:
    """The full-stream kernel's chains, one CTA each, int64 ``[n, 4]``:
    (lane, lo, hi, segment).  ``ranges`` [L, 2] are the lanes' ``[lo, hi)``;
    ``markers`` the sorted positions of the ``OP_END`` markers in the
    columns, or None where the lanes do not emit.  A lane without markers
    is one chain with segment -1 (it writes the lane's row); a packed lane
    is its segments (the positions before each marker, segment k writing
    row k) and its trailing part after the last marker (segment -1)."""
    ranges = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)
    if markers is None:
        lanes = np.arange(len(ranges), dtype=np.int64)
        return np.stack([lanes, ranges[:, 0], ranges[:, 1], np.full_like(lanes, -1)], 1)
    markers = np.asarray(markers, dtype=np.int64)
    rows = []
    for lane, (lo, hi) in enumerate(ranges.tolist()):
        ends = markers[np.searchsorted(markers, lo):np.searchsorted(markers, hi)].tolist()
        starts = [lo] + [e + 1 for e in ends]
        for k, (a, b) in enumerate(zip(starts, ends + [hi])):
            rows.append((lane, a, b, k if k < len(ends) else -1))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 4)


def pack_code(opcode, r_dst, r_a, r_b, reusable) -> np.ndarray:
    """``opcode | r_dst << 4 | r_a << 8 | r_b << 12 | reusable << 16``."""
    return (np.asarray(opcode, np.int32) | np.asarray(r_dst, np.int32) << 4
            | np.asarray(r_a, np.int32) << 8 | np.asarray(r_b, np.int32) << 12
            | np.asarray(reusable, np.int32) << 16).astype(np.int32)


def pack_mm_code(c, a, b, a_dyn, b_dyn, c_dyn, reusable, ts_mask) -> np.ndarray:
    """``c | a << 4 | b << 8``, then one bit each from 12: a_dyn, b_dyn,
    c_dyn, reusable, ts_mask (an operand is dynamic when its last writer is
    an MM; ts_mask: a free store of this MM's result follows it)."""
    bits = [np.asarray(x, np.int32) for x in (a_dyn, b_dyn, c_dyn, reusable, ts_mask)]
    code = (np.asarray(c, np.int32) | np.asarray(a, np.int32) << 4
            | np.asarray(b, np.int32) << 8)
    for k, bit in enumerate(bits):
        code = code | bit << (12 + k)
    return code.astype(np.int32)


def _lane_errors(slots: torch.Tensor) -> torch.Tensor:
    """Each lane's error code from the kernel's slots (the least of its
    failing chains' order * 4 + code): its first failing chain's code, the
    error the sequential lane stopped at; 0 where no chain failed."""
    return torch.where(slots == _NO_ERROR, 0, slots & 3)


def _raise_on(err: torch.Tensor) -> None:
    """Raise the numpy lane's error for a lane the kernel flagged."""
    worst = int(err.max()) if err.numel() else 0
    if worst == ERR_NEVER_GRANTED:
        raise RuntimeError("tail share must be > 0: request can never be granted")
    if worst == ERR_NO_PROGRESS:
        raise RuntimeError("token bucket walk made no progress (epoch length "
                           "below the time's resolution)")


# --------------------------------------------------------------------------
# the plain versions: float64 tensors over the lanes, a Python loop over
# the instructions
# --------------------------------------------------------------------------

def _pymax(a: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """Python's max(): the first of equal values."""
    for b in rest:
        a = torch.where(b > a, b, a)
    return a


class _Bucket:
    """The lanes' token buckets (run_segment's grant, masked per lane)."""

    def __init__(self, shares, sh_lo, sh_n, E, tail, burst, sched_end):
        self.shares, self.sh_lo = shares, sh_lo
        self.sh_n = sh_n.to(torch.float64)
        self.E, self.tail, self.burst, self.sched_end = E, tail, burst, sched_end

    def share_at(self, t):
        """(rate, t // E): ``shares[int(t // E)] if t // E < n_sh else tail``."""
        fd = torch.div(t, self.E, rounding_mode="floor")
        inside = fd < self.sh_n
        idx = self.sh_lo + torch.where(inside, fd, 0.0).to(torch.int64)
        return torch.where(inside, self.shares[idx], self.tail), fd

    def advance(self, tokens, bt, t_to, walk, walks, err):
        while True:
            m = walk & (bt < t_to) & (err == 0)
            if not bool(m.any()):
                return tokens, bt, walks, err
            rate, fd = self.share_at(bt)
            e_end = (fd + 1.0) * self.E
            step_end = torch.where(bt >= self.sched_end, t_to,
                                   torch.where(t_to < e_end, t_to, e_end))
            refill = tokens + rate * (step_end - bt)
            refill = torch.where(refill > self.burst, self.burst, refill)
            tokens = torch.where(m, torch.where(torch.isinf(rate), self.burst, refill),
                                 tokens)
            stuck = m & ~(step_end > bt)
            err = torch.where(stuck, ERR_NO_PROGRESS, err)
            moved = m & ~stuck
            bt = torch.where(moved, step_end, bt)
            walks = walks + moved.to(walks.dtype)

    def grant(self, tokens, bt, req, n_bytes, want, walks, err):
        tokens, bt, walks, err = self.advance(tokens, bt, req, want, walks, err)
        need = torch.where(n_bytes < self.burst, n_bytes, self.burst)
        short = want & ~(tokens >= need) & (err == 0)
        start = req.clone()
        t, tk = bt.clone(), tokens.clone()
        walking = short
        while bool(walking.any()):
            rate, fd = self.share_at(t)
            inf_r = torch.isinf(rate)
            dead = ~inf_r & (rate <= 0.0) & (t >= self.sched_end)
            e_end = (fd + 1.0) * self.E
            pos = rate > 0.0
            t_hit = t + (need - tk) / rate
            hit = ~inf_r & ~dead & pos & ((t_hit <= e_end) | (t >= self.sched_end))
            start = torch.where(walking & inf_r, t, start)
            start = torch.where(walking & hit, t_hit, start)
            err = torch.where(walking & dead, ERR_NEVER_GRANTED, err)
            cont = walking & ~inf_r & ~dead & ~hit
            tk = torch.where(cont & pos, tk + rate * (e_end - t), tk)
            stuck = cont & ~(e_end > t)
            err = torch.where(stuck, ERR_NO_PROGRESS, err)
            moved = cont & ~stuck
            t = torch.where(moved, e_end, t)
            walks = walks + moved.to(walks.dtype)
            walking = moved
        start = torch.where(short & (start < req), req, start)
        tokens, bt, walks, err = self.advance(tokens, bt, start, want, walks, err)
        tokens = torch.where(want & (err == 0), tokens - n_bytes, tokens)
        return start, tokens, bt, walks, err


#: the plain version's carry entries behind OUT_FIELDS
OUT_KEYS = ("t_end", "skips", "stall", "last_grant", "walks")


def plain_state(burst: torch.Tensor) -> dict:
    """A fresh carry of the plain lanes (run_segment's initial state), one
    entry per lane of ``burst``; :data:`CARRY_KEYS` order."""
    n, dev = burst.shape[0], burst.device
    f64 = dict(dtype=torch.float64, device=dev)
    zero = torch.zeros(n, **f64)
    return dict(rr=torch.zeros((n, NUM_TREGS), **f64), pffs=torch.full((n,), -1.0, **f64),
                pffe=zero, pfse=zero, pdre=zero,
                have_prev=torch.zeros(n, dtype=torch.bool, device=dev),
                wlfree=zero, t_end=zero, skips=zero, stall=zero, next_free=zero,
                store_next=zero, last_grant=zero, tokens=burst.clone(), bt=zero, walks=zero)


#: the plain lanes' carry entries (``rr`` is the eight register ready-times)
CARRY_KEYS = ("rr", "pffs", "pffe", "pfse", "pdre", "have_prev", "wlfree", "t_end", "skips",
              "stall", "next_free", "store_next", "last_grant", "tokens", "bt")


class PlainLanes:
    """The lanes of the plain full-stream scan: their design and bucket
    fields (``lane_f`` [L, 16], :data:`LANE_FIELDS`) and the token buckets
    over ``shares``; :meth:`step` runs one instruction of every lane."""

    def __init__(self, lane_f: torch.Tensor, shares: torch.Tensor, sh_lo: torch.Tensor,
                 sh_n: torch.Tensor, *, bucket: bool, tail=None, sched_end=None):
        self.f = f = dict(zip(LANE_FIELDS, lane_f.unbind(1)))
        self.wlbp, self.wls, self.pipe = (f[k] != 0 for k in ("wlbp", "wls", "pipe"))
        self.store_free, self.charge = f["store_free"] != 0, f["charge"] != 0
        self.bk = _Bucket(shares, sh_lo, sh_n, f["epoch"], f["tail"] if tail is None else tail,
                          f["burst"], f["sched_end"] if sched_end is None else sched_end)
        self.bucket = bucket
        self.lanes = torch.arange(lane_f.shape[0], device=lane_f.device)

    def step(self, s: dict, c: torch.Tensor, v: torch.Tensor, li: torch.Tensor,
             act: torch.Tensor, err: torch.Tensor, rec: torch.Tensor | None = None
             ) -> torch.Tensor:
        """run_segment's statements for one instruction of every lane where
        ``act``: ``c`` the packed code, ``v`` the value, ``li`` the
        instruction's index in its trace.  Updates the carry ``s`` in place
        and returns the lanes' error codes.  With ``rec`` ([L, 5]) each lane
        that steps a TL/TS/MM writes its event row there
        (:data:`EVENT_FIELDS`); the other rows stay as they are."""
        f, bk, lanes = self.f, self.bk, self.lanes
        wlbp, wls, pipe, store_free, charge = (self.wlbp, self.wls, self.pipe, self.store_free,
                                               self.charge)
        op = c & 7
        rd, ra, rb = (c >> 4) & 15, (c >> 8) & 15, (c >> 12) & 15
        t_issue = li / f["issue"]
        is_tl, is_ts, is_mm = act & (op == OP_TL), act & (op == OP_TS), act & (op == OP_MM)
        # the branches some lane takes at this step (one read of the device)
        any_tl, any_ts, any_mm = torch.stack([is_tl.any(), is_ts.any(), is_mm.any()]).tolist()
        rr = s["rr"]
        new_reg = rr[lanes, rd]
        te = s["t_end"]

        if any_tl or any_ts:      # ---- run_segment's TL and TS branches ----
            port_tl = torch.where(t_issue > s["next_free"], t_issue, s["next_free"])
            r_ts = rr[lanes, ra]
            t_avail = torch.where(t_issue > r_ts, t_issue, r_ts)
            port_ts = torch.where(t_avail > s["store_next"], t_avail, s["store_next"])
            tracked = is_ts & ~store_free
            if self.bucket:
                charged = tracked & charge
                start, s["tokens"], s["bt"], s["walks"], err = bk.grant(
                    s["tokens"], s["bt"], torch.where(is_tl, port_tl, port_ts), v,
                    is_tl | charged, s["walks"], err)
                live = err == 0
                is_tl, is_ts = is_tl & live, is_ts & live
                tracked, charged = tracked & live, charged & live
                start_tl = start
                start_ts = torch.where(charged, start, port_ts)
                s["stall"] = torch.where(is_tl, s["stall"] + (start_tl - port_tl), s["stall"])
                s["stall"] = torch.where(charged, s["stall"] + (start_ts - port_ts),
                                         s["stall"])
            else:
                start_tl, start_ts = port_tl, port_ts
            s["next_free"] = torch.where(is_tl, start_tl + f["inv_load"], s["next_free"])
            s["store_next"] = torch.where(tracked, start_ts + f["inv_store"],
                                          s["store_next"])
            lg = s["last_grant"]
            lg = torch.where(is_tl & (start_tl > lg), start_tl, lg)
            s["last_grant"] = torch.where(tracked & (start_ts > lg), start_ts, lg)
            done = start_tl + f["load_lat"]
            e_ts = torch.where(store_free, t_avail + 1.0, start_ts + 1.0)
            new_reg = torch.where(is_tl, done, new_reg)
            te = torch.where(is_tl & (done > te), done, te)
            te = torch.where(is_ts & (e_ts > te), e_ts, te)
            if rec is not None:   # TL: (start, stall); TS: (start, stall)
                zero = torch.zeros_like(start_tl)
                stall_tl = start_tl - port_tl if self.bucket else zero
                ev_ts = torch.where(store_free, t_avail, start_ts)
                stall_ts = (torch.where(charged, start_ts - port_ts, zero)
                            if self.bucket else zero)
                for k, (a, b) in enumerate(((start_tl, ev_ts), (stall_tl, stall_ts))):
                    rec[:, k] = torch.where(is_tl, a, torch.where(is_ts, b, rec[:, k]))

        if any_mm:                # ---- run_segment's rasa_mm rules ---------
            hp = s["have_prev"]
            t_ready_ac = _pymax(t_issue, rr[lanes, ra], rr[lanes, rd])
            t_ready_b = _pymax(t_issue, rr[lanes, rb])
            reuse = wlbp & (((c >> 16) & 1) != 0)
            pffs_e, pffe_e, pfse_e, pdre_e = (torch.where(hp, s[key], 0.0)
                                              for key in ("pffs", "pffe", "pfse", "pdre"))
            ff_reuse = _pymax(t_ready_ac, pffe_e)
            wls_wl = _pymax(t_ready_b, pffs_e, s["wlfree"])
            hidden = hp & (wls_wl <= s["pfse"])
            w_ready = torch.where(hidden, wls_wl + 1.0, wls_wl + f["wl"])
            ff_wls = _pymax(t_ready_ac, pffe_e, w_ready)
            pipe_wl = _pymax(t_ready_b, pfse_e, s["wlfree"])
            ff_pipe = _pymax(t_ready_ac, pipe_wl + f["wl"], pdre_e)
            base_wl = _pymax(t_ready_b, pdre_e, s["wlfree"])
            ff_base = _pymax(t_ready_ac, base_wl + f["wl"])
            wl_start = torch.where(wls, wls_wl, torch.where(pipe, pipe_wl, base_wl))
            ff_start = torch.where(reuse, ff_reuse,
                                   torch.where(wls, ff_wls, torch.where(pipe, ff_pipe, ff_base)))
            ff_end = ff_start + v
            fs_end = ff_end + f["fs"]
            dr_end = fs_end + f["dr"]
            new_reg = torch.where(is_mm, dr_end, new_reg)
            te = torch.where(is_mm & (dr_end > te), dr_end, te)
            if rec is not None:   # MM: (wl_start, ff_start, ff_end, fs_end, dr_end)
                ev_wl = torch.where(reuse, t_ready_b, wl_start)
                for k, x in enumerate((ev_wl, ff_start, ff_end, fs_end, dr_end)):
                    rec[:, k] = torch.where(is_mm, x, rec[:, k])
            for key, new in (("pffs", ff_start), ("pffe", ff_end), ("pfse", fs_end),
                             ("pdre", dr_end)):
                s[key] = torch.where(is_mm, new, s[key])
            s["have_prev"] = hp | is_mm
            s["wlfree"] = torch.where(is_mm & ~reuse, wl_start + f["wl"], s["wlfree"])
            s["skips"] = s["skips"] + (is_mm & reuse).to(torch.float64)

        if any_tl or any_mm:
            rr = rr.clone()
            rr[lanes, rd] = new_reg
            s["rr"] = rr
        s["t_end"] = te
        return err


def fastsim_scan_plain(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                       lane_i: torch.Tensor, shares: torch.Tensor, *, bucket: bool,
                       n_seg: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the full-stream scan: every lane steps through
    its range in lockstep, each branch of run_segment computed for every
    lane and kept where the lane's opcode takes it.  Returns ``out`` [L, 5]
    and ``seg_out`` [n_seg, L, 5] (:data:`OUT_FIELDS`)."""
    dev = code.device
    n = lane_f.shape[0]
    lo, hi, sh_lo, sh_n = lane_i.unbind(1)
    lanes = PlainLanes(lane_f, shares, sh_lo, sh_n, bucket=bucket)
    burst = lanes.f["burst"]
    s = plain_state(burst)
    walks_done = torch.zeros(n, dtype=torch.float64, device=dev)
    li = torch.zeros(n, dtype=torch.float64, device=dev)   # segment-local index
    seg = torch.zeros(n, dtype=torch.int64, device=dev)
    err = torch.zeros(n, dtype=torch.int32, device=dev)
    seg_out = torch.zeros((n_seg, n, len(OUT_FIELDS)), dtype=torch.float64, device=dev)
    steps = int((hi - lo).max()) if n else 0
    for k in range(steps):
        pos = lo + k
        act = (pos < hi) & (err == 0)
        at = torch.where(act, pos, 0)
        c, v = code[at], val[at]
        err = lanes.step(s, c, v, li, act, err)
        li = torch.where(act, li + 1.0, li)
        is_end = act & ((c & 7) == OP_END) if n_seg else None
        if n_seg and bool(is_end.any()):   # ---- OP_END: emit, reset -----
            row = torch.stack([s[key] for key in OUT_KEYS], 1)
            seg_out[seg[is_end], lanes.lanes[is_end]] = row[is_end]
            seg = seg + is_end.to(torch.int64)
            walks_done = walks_done + torch.where(is_end, s["walks"], 0.0)
            new = plain_state(burst)
            for key in s:
                mask = is_end[:, None] if s[key].dim() == 2 else is_end
                s[key] = torch.where(mask, new[key], s[key])
            li = torch.where(is_end, 0.0, li)
    _raise_on(err)
    out = torch.stack([s[key] for key in OUT_KEYS], 1)
    out[:, 4] += walks_done
    return out, seg_out


def fastsim_events_plain(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                         lane_i: torch.Tensor, shares: torch.Tensor, *,
                         bucket: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the event replay: the plain full-stream lanes
    (one segment each, :class:`PlainLanes`) stepped in lockstep, each step's
    events kept in the row of its position.  Returns ``rows`` [N, 5] (a
    TL's or TS's (start, stall), an MM's window: :data:`EVENT_FIELDS`; 0 at
    other opcodes and outside the lanes) and ``out`` [L, 3]
    (:data:`EVENT_OUT_FIELDS`)."""
    dev = code.device
    n = lane_f.shape[0]
    lo, hi, sh_lo, sh_n = lane_i.unbind(1)
    lanes = PlainLanes(lane_f, shares, sh_lo, sh_n, bucket=bucket)
    s = plain_state(lanes.f["burst"])
    err = torch.zeros(n, dtype=torch.int32, device=dev)
    # one spare row at the end: the lanes that write nothing at a step write it
    n_col = code.numel()
    rows = torch.zeros((n_col + 1, 5), dtype=torch.float64, device=dev)
    rec = torch.zeros((n, 5), dtype=torch.float64, device=dev)
    steps = int((hi - lo).max()) if n else 0
    for k in range(steps):
        pos = lo + k
        act = (pos < hi) & (err == 0)
        at = torch.where(act, pos, 0)
        c, v = code[at], val[at]
        li = torch.full((n,), float(k), dtype=torch.float64, device=dev)
        rec.zero_()                 # a TL's or TS's row ends in three zeros
        err = lanes.step(s, c, v, li, act, err, rec)
        wrote = act & (err == 0) & ((c & 7) <= OP_MM)
        rows.index_copy_(0, torch.where(wrote, at, n_col), rec)
    _raise_on(err)
    return rows[:n_col], torch.stack([s["t_end"], s["stall"], s["skips"]], 1)


def fastsim_mm_scan_plain(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                          lane_rows: torch.Tensor) -> torch.Tensor:
    """The plain version of the MM-only scan; ``out`` [L, 2]: t_end,
    wl_skips."""
    dev = code.device
    n = lane_f.shape[0]
    f = dict(zip(MM_LANE_FIELDS, lane_f.unbind(1)))
    wlbp, wls, pipe = (f[k] != 0 for k in ("wlbp", "wls", "pipe"))
    lo, hi = lane_rows.unbind(1)
    lanes = torch.arange(n, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    rr = torch.zeros((n, NUM_TREGS), **f64)
    pffs = torch.full((n,), -1.0, **f64)
    pffe = pfse = pdre = wlfree = t_end = skips = torch.zeros(n, **f64)
    hp = torch.zeros(n, dtype=torch.bool, device=dev)
    steps = int((hi - lo).max()) if n else 0
    for k in range(steps):
        pos = lo + k
        act = pos < hi
        at = torch.where(act, pos, 0)
        c, v = code[at], val[at]
        cr, ar, br = c & 15, (c >> 4) & 15, (c >> 8) & 15
        bit = [((c >> (12 + j)) & 1) != 0 for j in range(5)]
        ra = torch.where(bit[0], rr[lanes, ar], v[:, 0])
        rb = torch.where(bit[1], rr[lanes, br], v[:, 1])
        rc = torch.where(bit[2], rr[lanes, cr], v[:, 2])
        t_issue = v[:, 4]
        t_ready_ac = _pymax(t_issue, ra, rc)
        t_ready_b = _pymax(t_issue, rb)
        reuse = wlbp & bit[3]
        pffs_e, pffe_e, pfse_e, pdre_e = (torch.where(hp, x, 0.0)
                                          for x in (pffs, pffe, pfse, pdre))
        ff_reuse = _pymax(t_ready_ac, pffe_e)
        wls_wl = _pymax(t_ready_b, pffs_e, wlfree)
        hidden = hp & (wls_wl <= pfse)
        w_ready = torch.where(hidden, wls_wl + 1.0, wls_wl + f["wl"])
        ff_wls = _pymax(t_ready_ac, pffe_e, w_ready)
        pipe_wl = _pymax(t_ready_b, pfse_e, wlfree)
        ff_pipe = _pymax(t_ready_ac, pipe_wl + f["wl"], pdre_e)
        base_wl = _pymax(t_ready_b, pdre_e, wlfree)
        ff_base = _pymax(t_ready_ac, base_wl + f["wl"])
        wl_start = torch.where(wls, wls_wl, torch.where(pipe, pipe_wl, base_wl))
        ff_start = torch.where(reuse, ff_reuse,
                               torch.where(wls, ff_wls, torch.where(pipe, ff_pipe, ff_base)))
        ff_end = ff_start + v[:, 3]
        fs_end = ff_end + f["fs"]
        dr_end = fs_end + f["dr"]
        rr = rr.clone()
        rr[lanes, cr] = torch.where(act, dr_end, rr[lanes, cr])
        te = torch.where(act & (dr_end > t_end), dr_end, t_end)
        ts_end = _pymax(v[:, 5], dr_end) + 1.0
        t_end = torch.where(act & bit[4] & (ts_end > te), ts_end, te)
        pffs = torch.where(act, ff_start, pffs)
        pffe = torch.where(act, ff_end, pffe)
        pfse = torch.where(act, fs_end, pfse)
        pdre = torch.where(act, dr_end, pdre)
        hp = hp | act
        wlfree = torch.where(act & ~reuse, wl_start + f["wl"], wlfree)
        skips = skips + (act & reuse).to(torch.float64)
    return torch.stack([t_end, skips], 1)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _lib():
    lib = _build.load("fastsim")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.fastsim_scan.argtypes = [i, p, p, ll, p, p, p, p, i, i, ll, p, p, p,
                                     ctypes.POINTER(i), p]
        lib.fastsim_scan.restype = i
        lib.fastsim_mm_scan.argtypes = [p, p, ll, p, p, i, p, p]
        lib.fastsim_mm_scan.restype = i
        lib.fastsim_events.argtypes = [i, p, p, ll, p, p, p, i, ll, p, p, p, p]
        lib.fastsim_events.restype = i
        lib.fastsim_error_string.argtypes = [i]
        lib.fastsim_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_tensors(what: str, tensors: dict, dtypes: dict) -> torch.device:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what} needs tensors on one CUDA device, got "
                         + ", ".join(f"{k} {t.device}" for k, t in tensors.items()))
    for key, t in tensors.items():
        if t.dtype != dtypes[key] or not t.is_contiguous():
            raise TypeError(f"{what}: {key} must be a contiguous {dtypes[key]} tensor, "
                            f"got {t.dtype}")
    return dev


def _check_ranges(what: str, ranges: torch.Tensor, length: int) -> None:
    lo, hi = ranges.unbind(1)
    if ranges.numel() and bool(((lo < 0) | (hi < lo) | (hi > length)).any()):
        raise ValueError(f"{what}: a lane's range lies outside [0, {length}]")


def _check_stream_inputs(what: str, code: torch.Tensor, val: torch.Tensor,
                         lane_f: torch.Tensor, lane_i: torch.Tensor,
                         shares: torch.Tensor) -> torch.device:
    """The full stream's columns and lane tables as the kernels read them:
    on one CUDA device, their dtypes and shapes, the lanes' ranges inside
    the columns and the shares, register ids inside the register file.
    Returns the device."""
    dev = _check_tensors(what, dict(code=code, val=val, lane_f=lane_f, lane_i=lane_i,
                                    shares=shares),
                         dict(code=torch.int32, val=torch.float64, lane_f=torch.float64,
                              lane_i=torch.int64, shares=torch.float64))
    n = lane_f.shape[0]
    if (code.dim() != 1 or val.shape != code.shape or tuple(lane_f.shape) != (n, len(LANE_FIELDS))
            or tuple(lane_i.shape) != (n, 4) or shares.dim() != 1 or not shares.numel()):
        raise ValueError(f"{what}: want code/val [N], lane_f [L, {len(LANE_FIELDS)}], "
                         f"lane_i [L, 4], shares [S >= 1]; got {tuple(code.shape)}, "
                         f"{tuple(val.shape)}, {tuple(lane_f.shape)}, {tuple(lane_i.shape)}, "
                         f"{tuple(shares.shape)}")
    _check_ranges(what, lane_i[:, :2], code.numel())
    _check_ranges(what, torch.stack([lane_i[:, 2], lane_i[:, 2] + lane_i[:, 3]], 1),
                  shares.numel())
    regs = torch.stack([(code >> s) & 15 for s in (4, 8, 12)])
    if code.numel() and int(regs.max()) >= NUM_TREGS:
        raise ValueError(f"{what}: register ids outside [0, {NUM_TREGS})")
    return dev


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on a 16-byte
    edge (the kernel's bulk copies read 16-byte pieces from the start)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _spread(flags: np.ndarray) -> str:
    return "all" if flags.all() else ("none" if not flags.any() else "some")


def fastsim_scan_cuda(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                      lane_i: torch.Tensor, shares: torch.Tensor, *, bucket: bool,
                      n_seg: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-stream scan through ``fastsim_scan_kernel``, on the current
    stream: one CTA per chain of :func:`chain_table` (a lane, or with
    ``n_seg`` each packed segment of a lane).  Raises on a CPU tensor, on
    lanes outside the columns, on register ids outside the register file,
    on more ``OP_END`` markers than ``n_seg`` rows, and on a lane the bucket
    can never grant.  Columns whose data does not start on a 16-byte edge
    are copied first."""
    what = "fastsim_scan"
    dev = _check_stream_inputs(what, code, val, lane_f, lane_i, shares)
    n = lane_f.shape[0]
    lanes = lane_i.cpu().numpy()
    markers = None
    if n_seg:
        markers = torch.nonzero((code & 7) == OP_END).flatten().cpu().numpy()
        per_lane = (np.searchsorted(markers, lanes[:, 1])
                    - np.searchsorted(markers, lanes[:, 0]))
        if n and int(per_lane.max()) > n_seg:
            raise ValueError(f"{what}: a lane has more OP_END markers than n_seg={n_seg}")
    chains = chain_table(lanes[:, :2], markers)
    out = torch.zeros((n, len(OUT_FIELDS)), dtype=torch.float64, device=dev)
    seg_out = torch.zeros((max(n_seg, 1), n, len(OUT_FIELDS)), dtype=torch.float64,
                          device=dev)
    err = torch.full((n,), _NO_ERROR, dtype=torch.int32, device=dev)
    if n == 0:
        return out, seg_out[:n_seg]
    code, val = _aligned(code), _aligned(val)
    chains_t = torch.as_tensor(chains, device=dev)
    lib = _lib()
    slots = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fastsim_scan(int(bucket), code.data_ptr(), val.data_ptr(), code.numel(),
                              lane_f.data_ptr(), lane_i.data_ptr(), shares.data_ptr(),
                              chains_t.data_ptr(), len(chains), n, int(lanes[:, 3].max()),
                              out.data_ptr(), seg_out.data_ptr(), err.data_ptr(),
                              ctypes.byref(slots), stream)
    _build.raise_if(rc, lib.fastsim_error_string, "fastsim_scan launch")
    launches["scan"] += 1
    f = lane_f.cpu().numpy()
    staged = lanes[:, 3] <= slots.value
    launch_paths[(len(chains),
                  "none" if not bucket else {"all": "shared", "none": "global",
                                             "some": "mixed"}[_spread(staged)],
                  _spread(f[:, LANE_FIELDS.index("epoch_pow2")] != 0),
                  _spread(f[:, LANE_FIELDS.index("issue_pow2")] != 0))] += 1
    _raise_on(_lane_errors(err))
    return out, seg_out[:n_seg]


def fastsim_mm_scan_cuda(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                         lane_rows: torch.Tensor) -> torch.Tensor:
    """The MM-only scan through ``fastsim_mm_kernel``, on the current
    stream, one CTA per lane.  Raises on a CPU tensor, on rows outside the
    columns and on register ids outside the register file.  Columns whose
    data does not start on a 16-byte edge are copied first."""
    what = "fastsim_mm_scan"
    dev = _check_tensors(what, dict(code=code, val=val, lane_f=lane_f, lane_rows=lane_rows),
                         dict(code=torch.int32, val=torch.float64, lane_f=torch.float64,
                              lane_rows=torch.int64))
    n = lane_f.shape[0]
    if (code.dim() != 1 or tuple(val.shape) != (code.numel(), len(MM_VAL_FIELDS))
            or tuple(lane_f.shape) != (n, len(MM_LANE_FIELDS))
            or tuple(lane_rows.shape) != (n, 2)):
        raise ValueError(f"{what}: want code [R], val [R, {len(MM_VAL_FIELDS)}], lane_f "
                         f"[L, {len(MM_LANE_FIELDS)}], lane_rows [L, 2]; got "
                         f"{tuple(code.shape)}, {tuple(val.shape)}, {tuple(lane_f.shape)}, "
                         f"{tuple(lane_rows.shape)}")
    _check_ranges(what, lane_rows, code.numel())
    regs = torch.stack([(code >> s) & 15 for s in (0, 4, 8)])
    if code.numel() and int(regs.max()) >= NUM_TREGS:
        raise ValueError(f"{what}: register ids outside [0, {NUM_TREGS})")
    out = torch.empty((n, 2), dtype=torch.float64, device=dev)
    if n == 0:
        return out
    code, val = _aligned(code), _aligned(val)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fastsim_mm_scan(code.data_ptr(), val.data_ptr(), code.numel(),
                                 lane_f.data_ptr(), lane_rows.data_ptr(), n, out.data_ptr(),
                                 stream)
    _build.raise_if(rc, lib.fastsim_error_string, "fastsim_mm_scan launch")
    launches["mm_scan"] += 1
    return out


def fastsim_events_cuda(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                        lane_i: torch.Tensor, shares: torch.Tensor, *,
                        bucket: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The event replay through ``fastsim_events_kernel``, on the current
    stream, one CTA a lane (one segment each; its shares in shared memory
    where they fit).  Raises on a CPU tensor, on lanes outside the columns
    or overlapping each other, on register ids outside the register file,
    and on a lane the bucket can never grant.  Columns whose data does not
    start on a 16-byte edge are copied first.  Returns what
    :func:`fastsim_events_plain` returns."""
    what = "fastsim_events"
    dev = _check_stream_inputs(what, code, val, lane_f, lane_i, shares)
    n = lane_f.shape[0]
    lanes = lane_i.cpu().numpy()
    ranges = lanes[lanes[:, 0] < lanes[:, 1], :2]
    ranges = ranges[np.argsort(ranges[:, 0], kind="stable")]
    if (ranges[1:, 0] < ranges[:-1, 1]).any():
        raise ValueError(f"{what}: two lanes overlap (each writes its own positions' rows)")
    rows = torch.zeros((code.numel(), 5), dtype=torch.float64, device=dev)
    out = torch.zeros((n, len(EVENT_OUT_FIELDS)), dtype=torch.float64, device=dev)
    err = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0:
        return rows, out
    code, val = _aligned(code), _aligned(val)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fastsim_events(int(bucket), code.data_ptr(), val.data_ptr(), code.numel(),
                                lane_f.data_ptr(), lane_i.data_ptr(), shares.data_ptr(), n,
                                int(lanes[:, 3].max()), rows.data_ptr(), out.data_ptr(),
                                err.data_ptr(), stream)
    _build.raise_if(rc, lib.fastsim_error_string, "fastsim_events launch")
    launches["events"] += 1
    _raise_on(err)
    return rows, out


def fastsim_scan(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                 lane_i: torch.Tensor, shares: torch.Tensor, *, bucket: bool,
                 n_seg: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-stream scan: the plain version for tensors on the CPU, the
    kernel for tensors on the card."""
    if code.device.type == "cpu":
        return fastsim_scan_plain(code, val, lane_f, lane_i, shares, bucket=bucket,
                                  n_seg=n_seg)
    return fastsim_scan_cuda(code, val, lane_f, lane_i, shares, bucket=bucket, n_seg=n_seg)


def fastsim_mm_scan(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                    lane_rows: torch.Tensor) -> torch.Tensor:
    """The MM-only scan: the plain version for tensors on the CPU, the
    kernel for tensors on the card."""
    if code.device.type == "cpu":
        return fastsim_mm_scan_plain(code, val, lane_f, lane_rows)
    return fastsim_mm_scan_cuda(code, val, lane_f, lane_rows)


def fastsim_events(code: torch.Tensor, val: torch.Tensor, lane_f: torch.Tensor,
                   lane_i: torch.Tensor, shares: torch.Tensor, *,
                   bucket: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The event replay: the plain version for tensors on the CPU, the
    kernel for tensors on the card."""
    if code.device.type == "cpu":
        return fastsim_events_plain(code, val, lane_f, lane_i, shares, bucket=bucket)
    return fastsim_events_cuda(code, val, lane_f, lane_i, shares, bucket=bucket)
