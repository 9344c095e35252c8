"""Encoder bit-accounting and statistics.

Reference: lib/jxl/enc_aux_out.h (AuxOut + LayerType: per-layer bit
totals assimilated across sections/threads) and the public
JxlEncoderStats surface (include/jxl/stats.h: JxlEncoderStatsCreate /
JxlEncoderCollectStats / JxlEncoderStatsGet).
"""

from __future__ import annotations

import dataclasses

# enc_aux_out.h:20-45 LayerType (snake-case names).
LAYERS = (
    "header", "toc", "dictionary", "splines", "noise", "quant",
    "modular_tree", "modular_global", "dc", "modular_dc_group",
    "control_fields", "coeff_order", "ac", "ac_tokens",
    "modular_ac_group",
)


@dataclasses.dataclass
class AuxOut:
    """Per-layer bit totals (AuxOut::layers / Assimilate)."""
    layers: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in LAYERS})
    num_blocks: int = 0
    num_small_blocks: int = 0
    num_dct4x8_blocks: int = 0
    num_dct8_blocks: int = 0
    num_dct16_blocks: int = 0
    num_dct32_blocks: int = 0

    def add(self, layer: str, bits: int) -> None:
        self.layers[layer] = self.layers.get(layer, 0) + int(bits)

    def assimilate(self, other: "AuxOut") -> None:
        for k, v in other.layers.items():
            self.layers[k] = self.layers.get(k, 0) + v
        self.num_blocks += other.num_blocks

    def total_bits(self) -> int:
        return sum(self.layers.values())

    def count_strategies(self, strategies) -> None:
        """EncoderStats block-type counters (stats.h
        JXL_ENC_STAT_NUM_DCT8_BLOCKS etc.)."""
        import numpy as np

        from libjxl_tpu_torch.vardct import ac_strategy as acs
        s = strategies[strategies >= 0]
        self.num_blocks += int(s.size)
        self.num_small_blocks += int(np.isin(
            s, (acs.DCT2X2, acs.DCT4X4, acs.IDENTITY)).sum())
        self.num_dct4x8_blocks += int(np.isin(
            s, (acs.DCT4X8, acs.DCT8X4)).sum())
        self.num_dct8_blocks += int((s == acs.DCT8X8).sum())
        self.num_dct16_blocks += int(np.isin(
            s, (acs.DCT16X16, acs.DCT16X8, acs.DCT8X16)).sum())
        self.num_dct32_blocks += int(np.isin(
            s, (acs.DCT32X32, acs.DCT32X16, acs.DCT16X32)).sum())

    def summary(self, num_pixels: int | None = None) -> dict:
        out = {"layers_bits": dict(self.layers),
               "total_bits": self.total_bits(),
               "num_blocks": self.num_blocks,
               "num_small_blocks": self.num_small_blocks,
               "num_dct4x8_blocks": self.num_dct4x8_blocks,
               "num_dct8_blocks": self.num_dct8_blocks,
               "num_dct16_blocks": self.num_dct16_blocks,
               "num_dct32_blocks": self.num_dct32_blocks}
        if num_pixels:
            out["bpp"] = self.total_bits() / num_pixels
        return out
