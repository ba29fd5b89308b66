"""Shared plumbing of the whole-trace program's parity tests
(tests/test_torch_batcher_program*.py): the port's batcher on a ``torch``
chip (the program's plain version on the CPU) against the JAX package's
numpy client, on the same requests."""

from _torch_chip import PORT, REF, fields_key, to_port_requests
from repro_torch.multicore import jitarb

ALL_DESIGNS = ("BASE", "RASA-DB-WLBP", "RASA-DB-WLS", "RASA-DM-PIPE", "RASA-DM-WLBP",
               "RASA-DMDB-WLS", "RASA-PIPE", "RASA-WLBP")
REACTIVE = ("occupancy", "bandwidth", "predicted")


def trace(n=10, seed=1, mean_gap=2, **kw):
    """The reference suite's synthetic trace (d_model 128), as the
    reference's requests."""
    kw.setdefault("prompt_lens", (16, 32))
    kw.setdefault("decode_steps", (1, 2))
    kw.setdefault("decode_batch", 8)
    return REF.synthetic_trace(n, seed=seed, mean_gap=mean_gap, d_model=128, **kw)


def chip_pair(**kw):
    """(reference numpy chip, port torch chip on the CPU)."""
    kw.setdefault("n_cores", 2)
    kw.setdefault("design", "RASA-WLBP")
    kw.setdefault("bw_bytes_per_cycle", 32.0)
    return (REF.ChipConfig(backend="numpy", **kw),
            PORT.ChipConfig(backend="torch", device="cpu", **kw))


def hetero_pair(cores=("BASE", "RASA-WLBP"), **kw):
    return chip_pair(n_cores=None, design=None, cores=cores, **kw)


def traffic(requests):
    return [(r.arrival_epoch, r.specs) for r in requests]


def in_domain(requests, port_chip, **plan_kw):
    p, why = jitarb.plan_ex(traffic(to_port_requests(requests)), port_chip, **plan_kw)
    assert p is not None, f"unexpected gate: {why}"
    return p


def assert_program(requests, ref_chip, port_chip, **kw):
    """The program's BatchReport equals the numpy client's, every field,
    and the program served it (no gate)."""
    kw.setdefault("policy", "fixed")
    kw.setdefault("batch_size", 1)
    want = REF.run_batcher(requests, ref_chip, **kw)
    got = PORT.run_batcher(to_port_requests(requests), port_chip, **kw)
    assert fields_key(got) == fields_key(want)
    assert got.jit_gate is None
    return got
