"""Published peaks of one NVIDIA H100 SXM and the roofline bound.

The peaks and ``bound`` are a frozen copy of ``chip_smoke.py`` (commit
3acaaec, ``PEAK_BYTES``, ``PEAK_OPS`` and ``bound``): NVIDIA's data sheet,
dense rates without sparsity, at the full power limit of 700 W.  A later
change to the program cannot move the yardstick.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16_tc": 989e12, "int8_tc": 1979e12, "tf32_tc": 495e12,
            "f32": 67e12}


def bound(nbytes: float, *ops: tuple[str, float]) -> tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes over the memory rate and the operations, given
    as (rate, count) pairs, over the peak rate of their type (summed)."""
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = sum(n / PEAK_OPS[kind] for kind, n in ops) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")
