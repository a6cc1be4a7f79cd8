"""C++-compatible number formatting (counterpart of ntsm_tpu/utils/formats.py).

The reference emits every floating-point column of ``eval`` through
``std::to_string`` (fixed, 6 decimals; src/CompareCounts.hpp:844-921) and
the count summary's site-coverage ratio through a ``std::setprecision``
stream (src/FingerPrint.hpp:313-349).  Byte-level output parity requires
matching both, including glibc's inf/nan spellings.
"""

from __future__ import annotations

import math

import numpy as np


def cpp_to_string(x) -> str:
    """Equivalent of C++ std::to_string.

    For integral inputs this is plain decimal; for floats it is
    vsnprintf("%f") — fixed notation with 6 decimals, correctly rounded,
    with glibc's "inf"/"-inf"/"nan"/"-nan" spellings.
    """
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    xf = float(x)
    if math.isnan(xf):
        # glibc prints the sign bit of the NaN; x86 0.0/0.0 produces -nan.
        return "-nan" if math.copysign(1.0, xf) < 0 else "nan"
    if math.isinf(xf):
        return "inf" if xf > 0 else "-inf"
    return f"{xf:.6f}"


def cpp_general(x, precision: int = 19) -> str:
    """Equivalent of ``stream << setprecision(p) << x`` (general format).

    C++ default float format with precision p: like printf("%.{p}g") —
    trailing zeros trimmed, scientific when the exponent is out of range.
    """
    xf = float(x)
    if math.isnan(xf):
        return "-nan" if math.copysign(1.0, xf) < 0 else "nan"
    if math.isinf(xf):
        return "inf" if xf > 0 else "-inf"
    return f"{xf:.{precision}g}"


def cpp_div(num: float, den: float) -> float:
    """IEEE double division with C++ semantics (x/0 -> +-inf, 0/0 -> nan),
    as the relatedness ratios need when a sample has no hets or homs
    (src/CompareCounts.hpp:1191-1194)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(num) / np.float64(den))
