"""Paper Table I: the nine MLPerf-derived layers used in the evaluation.

Convolutions are lowered to GEMM exactly as LIBXSMM does (im2col view):
M = batch * out_x * out_y, K = in_channels * R * S, N = filters.  FC layers:
M = batch, K = NIN, N = NON.  (Paper notation: N=batch, K=filters, C=input
channels, X/Y input dims, R/S filter dims.)
"""

from __future__ import annotations

import dataclasses

from .tiling import GemmSpec


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    batch: int
    filters: int
    channels: int
    x: int
    y: int
    r: int
    s: int
    stride: int = 1

    def to_gemm(self) -> GemmSpec:
        # ResNet 3x3 layers use 'same' padding -> output dims == input dims
        # for stride 1 (the paper's layers are all stride 1).
        out_x = self.x // self.stride
        out_y = self.y // self.stride
        return GemmSpec(self.name,
                        M=self.batch * out_x * out_y,
                        K=self.channels * self.r * self.s,
                        N=self.filters)


@dataclasses.dataclass(frozen=True)
class FCSpec:
    name: str
    batch: int
    nin: int
    non: int

    def to_gemm(self) -> GemmSpec:
        return GemmSpec(self.name, M=self.batch, K=self.nin, N=self.non)


#: Table I, verbatim.
TABLE_I: dict[str, GemmSpec] = {
    "ResNet50-1": ConvSpec("ResNet50-1", 32, 64, 64, 56, 56, 1, 1).to_gemm(),
    "ResNet50-2": ConvSpec("ResNet50-2", 32, 64, 64, 56, 56, 3, 3).to_gemm(),
    "ResNet50-3": ConvSpec("ResNet50-3", 32, 512, 1024, 14, 14, 1, 1).to_gemm(),
    "DLRM-1": FCSpec("DLRM-1", 512, 1024, 1024).to_gemm(),
    "DLRM-2": FCSpec("DLRM-2", 512, 1024, 64).to_gemm(),
    "DLRM-3": FCSpec("DLRM-3", 512, 2048, 2048).to_gemm(),
    "BERT-1": FCSpec("BERT-1", 256, 768, 768).to_gemm(),
    "BERT-2": FCSpec("BERT-2", 256, 3072, 768).to_gemm(),
    "BERT-3": FCSpec("BERT-3", 256, 768, 3072).to_gemm(),
}

#: Fig. 7 sweeps batch size on an FC layer (we use DLRM-1 dims as the base).
def batch_sweep(nin: int = 1024, non: int = 1024,
                batches: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128,
                                            256, 512, 1024, 2048)) -> dict[int, GemmSpec]:
    return {b: GemmSpec(f"FC-b{b}", M=b, K=nin, N=non) for b in batches}
