"""Weights drawn from the seed, on the device, in the type they are served
in, in the layout ``repro_torch.models.model_of`` takes.

Every parameter is a view of one buffer filled by a single normal draw
from a ``torch.Generator`` on the device; one multiply a group then gives
each group its scale (He for the products, 0.02 for the embedding, 0.1 for
the norm offsets, which the port applies as ``1 + scale``).  The same seed
gives the same tensors on every run, so the reference can be handed the
very tensors the program serves, or draw them again.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: the sub-stream of the seed that draws the weights
WEIGHTS_STREAM = 1


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run's ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, stream])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64) @ [1, 2**32]) % 2**63


def layer_shapes(spec: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """{name: (shape, scale group)} of one decoder layer (the port's names)."""
    d, hd = spec["d_model"], spec["head_dim"]
    h, hkv = spec["n_heads"], spec["n_kv_heads"]
    out = {"norm1": ((d,), "norm"), "wq": ((d, h * hd), "d"),
           "wk": ((d, hkv * hd), "d"), "wv": ((d, hkv * hd), "d"),
           "wo": ((h * hd, d), "attn_out"), "norm2": ((d,), "norm")}
    if spec["qk_norm"]:
        out["q_norm"] = ((hd,), "norm")
        out["k_norm"] = ((hd,), "norm")
    moe = spec.get("moe")
    if moe:
        e, fe = moe["n_experts"], moe["d_ff_expert"]
        out.update({"router": ((d, e), "d"), "experts_w_gate": ((e, d, fe), "d"),
                    "experts_w_up": ((e, d, fe), "d"),
                    "experts_w_down": ((e, fe, d), "ff")})
    else:
        f = spec["d_ff"]
        out.update({"w_gate": ((d, f), "d"), "w_up": ((d, f), "d"),
                    "w_down": ((f, d), "ff")})
    return out


def group_scales(spec: dict) -> dict[str, float]:
    moe = spec.get("moe")
    ff = moe["d_ff_expert"] if moe else spec["d_ff"]
    return {"embed": 0.02, "norm": 0.1, "d": math.sqrt(2 / spec["d_model"]),
            "attn_out": math.sqrt(2 / (spec["n_heads"] * spec["head_dim"])),
            "ff": math.sqrt(2 / ff)}


def draw(spec: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameters of a dense or MoE decoder: {"embedding", "layers":
    [dict a layer], "final_norm", and "lm_head" when the head is untied}."""
    d, v = spec["d_model"], spec["vocab"]
    entries = [("embedding", (v, d), "embed")]
    for i in range(spec["n_layers"]):
        entries += [(f"layers.{i}.{n}", s, g) for n, (s, g) in layer_shapes(spec).items()]
    entries.append(("final_norm", (d,), "norm"))
    if not spec["tie_embeddings"]:
        entries.append(("lm_head", (d, v), "d"))
    # one buffer, laid out group by group, so each group scales in one call
    order = sorted(range(len(entries)), key=lambda i: entries[i][2])
    sizes = [math.prod(entries[i][1]) for i in order]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS_STREAM))
    flat = torch.randn(sum(sizes), dtype=dtype, device=device, generator=gen)
    views, start, groups = {}, 0, {}
    for i, n in zip(order, sizes):
        name, shape, group = entries[i]
        views[name] = flat[start:start + n].view(shape)
        lo, hi = groups.get(group, (start, start))
        groups[group] = (min(lo, start), start + n)
        start += n
    for group, scale in group_scales(spec).items():
        if group in groups:
            lo, hi = groups[group]
            flat[lo:hi].mul_(scale)
    params = {"embedding": views["embedding"], "final_norm": views["final_norm"],
              "layers": [{n: views[f"layers.{i}.{n}"] for n in layer_shapes(spec)}
                         for i in range(spec["n_layers"])]}
    if "lm_head" in views:
        params["lm_head"] = views["lm_head"]
    return params

