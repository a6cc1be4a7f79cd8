"""Command-line interface of the PyTorch/CUDA port
(counterpart of ntsm_tpu/cli/__init__.py).

``python -m ntsm_tpu_torch count|eval|vcf|sitegen ...`` take the flags of
ntsmCount, ntsmEval and ntsmVCF and the targets of ntsmSiteGen
(src/ntSeqMatchCount.cpp, src/ntSeqMatchEval.cpp, src/ntSeqMatchVCF.cpp,
ntsm-scripts/makefile).
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "Usage: ntsm <count|eval|vcf|sitegen> [OPTIONS]\n"
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
    if cmd == "vcf":
        from ntsm_tpu_torch.cli.vcf_cmd import run

        return run(rest)
    if cmd == "sitegen":
        from ntsm_tpu_torch.cli.sitegen_cmd import run

        return run(rest)
    print(f"ntsm: unknown command {cmd!r}", file=sys.stderr)
    return 1
