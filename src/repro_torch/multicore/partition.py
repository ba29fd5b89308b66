"""GEMM partitioners: shard one GemmSpec into per-core sub-GEMMs.

The output-space strategies shard the C space only -- every core runs an
independent ``C_i += A_i @ B_i`` lowered by the unmodified register-aware
tiler.  The unit of distribution is the hardware tile (``TILE_M`` rows x
``TILE_N`` cols): edge tiles go to whichever core owns them, so shard dims
track the exact row/col extents and the simulated FF stages of edge tiles
stay exact.

Strategies (``PARTITIONERS``):

  m_split  -- contiguous blocks of tile-rows (classic batch/row parallelism;
              every core re-streams all of B).
  n_split  -- contiguous blocks of tile-cols (every core re-streams all of A;
              weight-register reuse per core is unchanged).
  block2d  -- block-cyclic over a pm x pn core grid chosen to minimize the
              per-core tile count; core (i, j) owns tile-rows i, i+pm, ...
              and tile-cols j, j+pn, ...  The cyclically gathered tiles are
              modelled as one dense sub-GEMM per core (tile counts -- the
              quantity the cycle model sees -- are identical).
  k_split  -- contiguous blocks of tile-*depths*: core *i* computes the full
              [M, N] partial product over its K-chunk, and the core owning
              the largest chunk (core 0) additionally runs the cross-core
              reduction (:class:`repro_torch.core.tiling.ReduceSpec`) that merges
              the ``w`` partials.  This is the only axis on which a decode
              GEMM (M = 1..16, a single tile row) can occupy more than one
              core -- and it is never a free lunch: the reduction's
              ``(w + 1) * M * N * 4`` bytes of fp32 partial traffic are
              charged against the shared bandwidth budget through the same
              arbiters as every tile load.  Timing note: the merge is
              modelled *in-stream* on the hosting core, which is exact when
              the K-chunks are symmetric (equal-share peers finish their
              identical partials simultaneously, so the host starts merging
              right when the last partial lands) and conservative-to-
              approximate when edge tiles skew the chunks.

Partitioners are core-design agnostic: shards are plain ``GemmSpec``s
(plus the one ``ReduceSpec`` of a K-split), so they flow unchanged onto
heterogeneous chips (each core lowers its shard under its own
:class:`~repro_torch.multicore.chip.CoreSpec`); balancing a split *across* a
BASE/RASA mix is the scheduler's job (``gang`` costs every shard on its
target core).
"""

from __future__ import annotations

from ..core.isa import TILE_K, TILE_M, TILE_N
from ..core.tiling import GemmSpec, ReduceSpec

PARTITIONERS = ("m_split", "n_split", "block2d", "k_split")


def _chunk_extents(n_items: int, full: int, tile: int, n_chunks: int) -> list[int]:
    """Split ``n_items`` tiles (covering ``full`` rows/cols of size ``tile``)
    into ``n_chunks`` balanced contiguous chunks; return element extents."""
    base, extra = divmod(n_items, n_chunks)
    extents, t0 = [], 0
    for i in range(n_chunks):
        t1 = t0 + base + (1 if i < extra else 0)
        extents.append(max(0, min(t1 * tile, full) - t0 * tile))
        t0 = t1
    return extents


def _cyclic_extents(n_items: int, full: int, tile: int, n_ways: int) -> list[int]:
    """Element extents when tiles are dealt cyclically across ``n_ways``."""
    extents = [0] * n_ways
    for t in range(n_items):
        extents[t % n_ways] += min(tile, full - t * tile)
    return extents


def _best_grid(n_cores: int, mt: int, nt: int) -> tuple[int, int]:
    """Factor ``n_cores`` into (pm, pn) minimizing the per-core tile count,
    tie-breaking toward a square grid."""
    best = None
    for pm in range(1, n_cores + 1):
        if n_cores % pm:
            continue
        pn = n_cores // pm
        per_core = -(-mt // pm) * -(-nt // pn)
        key = (per_core, abs(pm - pn))
        if best is None or key < best[0]:
            best = (key, (pm, pn))
    return best[1]


def split_ways(spec: GemmSpec, ways: int, strategy: str = "m_split",
               tile_m: int = TILE_M, tile_n: int = TILE_N) -> list[GemmSpec]:
    """The non-empty shards of ``spec`` split ``ways`` ways.

    Gang-scheduling helper: unlike :func:`partition_gemm` this drops empty
    shards (a gang never occupies a core it has no tiles for) and returns a
    flat list.  ``ways=1`` returns ``[spec]`` unchanged, so a gang of one is
    exactly the whole-GEMM placement.  Output-space strategies only: a
    K-split's reduction must ride the shard that hosts it, which the flat
    one-spec-per-core gang contract cannot express -- use
    :func:`partition_gemm` (``partitioned_chip_report``) for K-splits.
    """
    if strategy == "k_split":
        raise ValueError("k_split cannot gang-split: the reduction is tied "
                         "to its host shard; use partition_gemm instead")
    if ways == 1:
        return [spec]
    return [s for shard in partition_gemm(spec, ways, strategy,
                                          tile_m=tile_m, tile_n=tile_n)
            for s in shard]


def partition_gemm(spec: GemmSpec, n_cores: int, strategy: str = "m_split",
                   tile_m: int = TILE_M, tile_n: int = TILE_N
                   ) -> list[list]:
    """Shard ``spec`` across ``n_cores``; returns one shard list per core.

    Cores whose share of the tile grid is empty (more cores than tiles along
    the split axis) receive an empty list and sit idle.  Shards are
    ``GemmSpec``s; a ``k_split`` across >= 2 live chunks appends the
    :class:`~repro_torch.core.tiling.ReduceSpec` merging the partials to core 0's
    list.
    """
    if n_cores < 1:
        raise ValueError("n_cores must be >= 1")
    if strategy not in PARTITIONERS:
        raise ValueError(f"unknown partitioner {strategy!r}; "
                         f"available: {PARTITIONERS}")
    mt, kt, nt = spec.tiles(tile_m=tile_m, tile_n=tile_n)

    if strategy == "k_split":
        extents = _chunk_extents(kt, spec.K, TILE_K, n_cores)
        out = [[GemmSpec(f"{spec.name}@c{core}", M=spec.M, K=k, N=spec.N)]
               if k > 0 else []
               for core, (k) in enumerate(extents)]
        live = sum(1 for k in extents if k > 0)
        if live > 1:
            # core 0 owns the largest K-chunk (contiguous chunking hands
            # extras to early cores), so the merge rides its stream
            out[0].append(ReduceSpec(f"{spec.name}@reduce",
                                     M=spec.M, N=spec.N, ways=live))
        return out

    if strategy == "m_split":
        shards = [(m, spec.N) for m in _chunk_extents(mt, spec.M, tile_m, n_cores)]
    elif strategy == "n_split":
        shards = [(spec.M, n) for n in _chunk_extents(nt, spec.N, tile_n, n_cores)]
    else:  # block2d
        pm, pn = _best_grid(n_cores, mt, nt)
        rows = _cyclic_extents(mt, spec.M, tile_m, pm)
        cols = _cyclic_extents(nt, spec.N, tile_n, pn)
        shards = [(rows[i], cols[j]) for i in range(pm) for j in range(pn)]

    out: list[list[GemmSpec]] = []
    for core, (m, n) in enumerate(shards):
        if m > 0 and n > 0:
            out.append([GemmSpec(f"{spec.name}@c{core}", M=m, K=spec.K, N=n)])
        else:
            out.append([])
    return out
