"""Command-line interface of the PyTorch/CUDA port
(counterpart of ntsm_tpu/cli/__init__.py).

``python -m ntsm_tpu_torch count|eval ...`` take the flags of ntsmCount and
ntsmEval (src/ntSeqMatchCount.cpp, src/ntSeqMatchEval.cpp).  ``vcf`` and
``sitegen`` are not ported yet.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "Usage: ntsm <count|eval> [OPTIONS]\n"
            "Sample-swap detection on a GPU (ntsm-compatible).",
            file=sys.stderr,
        )
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "count":
        from ntsm_tpu_torch.cli.count_cmd import run

        return run(rest)
    if cmd == "eval":
        from ntsm_tpu_torch.cli.eval_cmd import run

        return run(rest)
    if cmd in ("vcf", "sitegen"):
        print(f"ntsm: {cmd} is not yet ported to ntsm_tpu_torch", file=sys.stderr)
        return 1
    print(f"ntsm: unknown command {cmd!r}", file=sys.stderr)
    return 1
