"""The simulator's random test stream, free of jax and of both packages, so
that the parity tests (over the reference's classes), the card tests and
chip_smoke.py (over the port's) draw the same streams from one copy.

A copy of the reference's ``random_stream`` (tests/test_fastsim.py:33-62);
``isa`` is the module whose ``Instr`` and ``Op`` build it
(``repro.core.isa`` or ``repro_torch.core.isa``).
"""

import random


def random_stream(rng: random.Random, n: int, isa) -> list:
    """Random but well-defined stream: all registers TL-defined up front,
    then a mix of loads, stores and MMs (including reuse runs, C-chains,
    and MMs whose destination aliases their B register)."""
    Instr, Op = isa.Instr, isa.Op
    stream = [Instr(Op.TL, dst=r, addr=("B", 0, r)) for r in range(8)]
    for _ in range(n):
        x = rng.random()
        if x < 0.3:
            stream.append(Instr(
                Op.TL, dst=rng.randrange(8),
                addr=(rng.choice("ABC"), rng.randrange(4), rng.randrange(4)),
                tm=rng.choice((1, 7, 16)), tk=rng.choice((8, 32)),
                tn=rng.choice((3, 16))))
        elif x < 0.45:
            stream.append(Instr(
                Op.TS, src1=rng.randrange(8),
                addr=("C", rng.randrange(4), 0),
                tm=rng.choice((1, 16)), tn=rng.choice((3, 16))))
        else:
            b = rng.randrange(8)
            # bias toward repeating B registers so WLBP reuse fires
            if rng.random() < 0.5 and stream[-1].op is Op.MM:
                b = stream[-1].src2
            stream.append(Instr(
                Op.MM, dst=rng.randrange(8), src1=rng.randrange(8),
                src2=b, tm=rng.choice((1, 8, 16))))
    return stream
