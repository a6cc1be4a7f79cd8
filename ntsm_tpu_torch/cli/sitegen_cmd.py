"""``ntsm sitegen`` — replaces the ntsmSiteGen make pipeline
(ntsmSiteGen:1-3, ntsm-scripts/makefile:32-34); counterpart of
ntsm_tpu/cli/sitegen_cmd.py.  Host only, as in the JAX package.
"""

from __future__ import annotations

import sys

HELP = """Usage:
    ntsm sitegen generate-sites name=prefix ref=ref.fa vcf=snps.vcf [w=31] [k=19] [mismatch=1] [indel=1]
    ntsm sitegen generate-pca-rot-mat name=prefix ref=ref.fa multivcf=m.vcf sites=prefix_n10.fa [dims=20]
"""


def _parse_kv(args):
    kv = {}
    for a in args:
        if "=" not in a:
            print(f"ntsm sitegen: expected key=value, got {a!r}", file=sys.stderr)
            raise SystemExit(1)
        k, v = a.split("=", 1)
        kv[k] = v
    return kv


def run(argv) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(HELP, file=sys.stderr)
        return 0 if argv else 1
    target, rest = argv[0], argv[1:]
    kv = _parse_kv(rest)

    if target == "generate-sites":
        for req in ("name", "ref", "vcf"):
            if req not in kv:
                print(f"missing required param '{req}'", file=sys.stderr)
                return 2
        from ntsm_tpu_torch.sitegen.pipeline import generate_sites

        generate_sites(
            kv["name"],
            kv["ref"],
            kv["vcf"],
            window=int(kv.get("w", 31)),
            k=int(kv.get("k", 19)),
            mismatch=bool(int(kv.get("mismatch", 1))),
            indel=bool(int(kv.get("indel", 1))),
        )
        return 0
    if target == "generate-pca-rot-mat":
        for req in ("name", "ref", "multivcf", "sites"):
            if req not in kv:
                print(f"missing required param '{req}'", file=sys.stderr)
                return 2
        from ntsm_tpu_torch.sitegen.pipeline import generate_pca_rotation

        generate_pca_rotation(
            kv["name"],
            kv["ref"],
            kv["multivcf"],
            kv["sites"],
            dims=int(kv.get("dims", 20)),
            window=int(kv.get("w", 31)),
            k=int(kv.get("k", 19)),
        )
        return 0
    print(f"ntsm sitegen: unknown target {target!r}", file=sys.stderr)
    return 1
