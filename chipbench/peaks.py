"""Data-sheet peaks of the card, and its power limit.

NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit: HBM3 at
3.35 TB/s and fp32 at 67 TFLOP/s outside the tensor cores (an FMA is two
FLOPs, so 33.5 T fp32 instructions a second). Every kernel this benchmark
counts runs on the fp32 pipes. A card set below 700 W runs slower under
load, so every share is printed beside the card's power limit.
"""
from __future__ import annotations

import subprocess
from typing import NamedTuple


class Peaks(NamedTuple):
    bytes_per_s: float
    fp32_flops: float

    @property
    def fp32_instr(self) -> float:
        """fp32 instructions a second (an FMA counts once)."""
        return self.fp32_flops / 2

    @property
    def sfu_instr(self) -> float:
        """Special-function (square root) instructions a second: an eighth
        of the fp32 instruction rate."""
        return self.fp32_flops / 16


H100_SXM = Peaks(3.35e12, 67e12)


def power_limit() -> str:
    """``nvidia-smi``'s power limit of card 0, or ``not read``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
