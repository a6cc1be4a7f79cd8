"""Nucleotide -> 2-bit code translation.

The reference translates bytes through a 256-entry table mapping
A/a->0, C/c->1, G/g->2, T/t/U/u->3 and everything else to 4 ("not a base";
reference: vendor/KseqHashIterator.hpp:114-127).  We build the same table
once as a numpy array; encoding a read batch is then a single vectorized
``take``, which is also how the host feed pipeline packs batches for the
device kernels.
"""

from __future__ import annotations

import numpy as np

_NT4 = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("TtUu", 3)):
    for _c in _ch:
        _NT4[ord(_c)] = _code
NT4_TABLE = _NT4
del _NT4


def encode_bytes(seq: bytes | np.ndarray) -> np.ndarray:
    """Translate an ASCII sequence to 2-bit codes (4 = invalid base)."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(seq, dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    return NT4_TABLE[raw]

