"""Shared plumbing of the simulator's parity tests (tests/test_torch_sim_*.py):
the reference's random streams and load models, and the same objects built
from the port's own classes."""

import math
import random

import _sim_streams
from repro.core import isa as r_isa
from repro.core.isa import Instr
from repro.core.timing import LoadStreamModel
from repro.multicore.chip import EpochBandwidthLoadModel
from repro_torch.core import fastsim as t_fastsim
from repro_torch.core import isa as t_isa
from repro_torch.core import timing as t_timing
from repro_torch.multicore import chip as t_chip

REL = 1e-6          # the reference's parity bound (tests/test_fastsim.py:30)
SHARES = (8.0, 16.0, 48.0)
MODELS = ("port", "epoch", "static")


def random_stream(rng: random.Random, n: int) -> list[Instr]:
    """The reference's random stream (tests/_sim_streams.py), from the
    reference's classes."""
    return _sim_streams.random_stream(rng, n, r_isa)


def to_port(stream) -> list:
    """The same stream as the port's Instr objects."""
    return [t_isa.Instr(t_isa.Op[i.op.name], i.dst, i.src1, i.src2, i.addr,
                        i.tm, i.tk, i.tn) for i in stream]


def ref_model(name: str, load_ports: int):
    """The reference's live load model of tests/test_fastsim.py's three."""
    if name == "port":
        return LoadStreamModel(load_ports)
    if name == "epoch":
        return EpochBandwidthLoadModel(load_ports, SHARES, 256.0, tail_share=64.0,
                                       burst_bytes=2048.0, store_ports=1,
                                       charge_store_bytes=True)
    return EpochBandwidthLoadModel(load_ports, (), math.inf, tail_share=12.0,
                                   burst_bytes=1024.0, store_ports=1,
                                   charge_store_bytes=True)


def port_model(name: str, load_ports: int):
    """The same model from the port's classes."""
    if name == "port":
        return t_timing.LoadStreamModel(load_ports)
    if name == "epoch":
        return t_chip.EpochBandwidthLoadModel(load_ports, SHARES, 256.0, tail_share=64.0,
                                              burst_bytes=2048.0, store_ports=1,
                                              charge_store_bytes=True)
    return t_chip.EpochBandwidthLoadModel(load_ports, (), math.inf, tail_share=12.0,
                                          burst_bytes=1024.0, store_ports=1,
                                          charge_store_bytes=True)


def port_params(p):
    """A reference StreamModelParams as the port's."""
    return t_fastsim.StreamModelParams(p.load_ports, p.store_ports, p.shares,
                                       p.epoch_cycles, p.tail_share, p.burst_bytes,
                                       p.charge_store_bytes)


def result_key(res, last_grant=None):
    """Everything a lane reports, for == across packages."""
    key = (res.cycles, res.n_mm, res.n_tl, res.n_ts, res.wl_skips, res.useful_macs,
           res.peak_macs_per_cycle, res.bw_stall_cycles)
    return key if last_grant is None else key + (last_grant,)
