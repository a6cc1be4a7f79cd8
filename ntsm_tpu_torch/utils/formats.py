"""C++-compatible number formatting (counterpart of ntsm_tpu/utils/formats.py).

The count summary prints its site-coverage ratio the way the reference's
``std::setprecision`` stream does (src/FingerPrint.hpp:313-349); byte-level
output parity requires matching it, including glibc's inf/nan spellings.
"""

from __future__ import annotations

import math


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
