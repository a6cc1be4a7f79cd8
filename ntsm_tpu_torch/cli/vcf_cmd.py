"""``ntsm vcf`` — flag-compatible with ntsmVCF (src/ntSeqMatchVCF.cpp);
counterpart of ntsm_tpu/cli/vcf_cmd.py.

Faithful quirk: without -p the reference never writes count files
(ntSeqMatchVCF.cpp:201-204 only prints a message); the extension
--output-counts writes per-sample count files into the working directory.
The conversion runs on the host, as in the JAX package.
"""

from __future__ import annotations

import getopt
import os
import sys
import time

from ntsm_tpu_torch.options import Options

HELP = """Usage: ntsm vcf -s [FASTA] -r [FASTA] [VCF]
Converts a multi vcf file to a set of counts files.
Alternatively, you may also create a matrix to be used for PCA.
  -t, --threads = INT    Number of threads to run.[1]
  -d, --dupes            Allow shared k-mers between sites to
                         be counted.
  -s, --snp = STR        Interleaved fasta of SNP sites to
                         k-merize. [required]
  -p, --pca = STR        With multivcf generate rotation and
                         centering files with this prefix.
  -k, --kmer = INT       k-mer size used. [19]
  -m, --multi = INT      Value to multiply base counts [20]
  -w, --window = INT     Window size used. [31]
  -r, --ref = STR        Reference fasta. [required]
  -h, --help             Display this dialog.
  -v, --verbose          Display verbose output.
      --version          Print version information.
      --output-counts    extension: write per-sample count files.
"""


def run(argv) -> int:
    opts = Options()
    pca_prefix = ""
    output_counts = False
    try:
        parsed, files = getopt.gnu_getopt(
            argv,
            "s:t:vhk:dr:w:m:p:",
            [
                "threads=",
                "dupes",
                "snp=",
                "pca=",
                "kmer=",
                "multi=",
                "window=",
                "ref=",
                "help",
                "version",
                "verbose",
                "output-counts",
            ],
        )
    except getopt.GetoptError as e:
        print(f"ntsm vcf: {e}", file=sys.stderr)
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    for flag, val in parsed:
        if flag in ("-h", "--help"):
            print(HELP, file=sys.stderr)
            return 0
        elif flag == "--version":
            from ntsm_tpu_torch import __version__

            print(f"ntsm vcf (ntsm_tpu_torch) {__version__}", file=sys.stderr)
            return 0
        elif flag in ("-d", "--dupes"):
            opts = opts.replace(dupes=True)
        elif flag in ("-s", "--snp"):
            opts = opts.replace(snp=val)
        elif flag in ("-p", "--pca"):
            pca_prefix = val
        elif flag in ("-k", "--kmer"):
            opts = opts.replace(k=int(val))
        elif flag in ("-w", "--window"):
            opts = opts.replace(window=int(val))
        elif flag in ("-m", "--multi"):
            opts = opts.replace(multi=int(val))
        elif flag in ("-t", "--threads"):
            opts = opts.replace(threads=int(val))
        elif flag in ("-r", "--ref"):
            opts = opts.replace(ref=val)
        elif flag in ("-v", "--verbose"):
            opts = opts.replace(verbose=opts.verbose + 1)
        elif flag == "--output-counts":
            output_counts = True

    die = False
    if opts.k > 32:
        print("k cannot be greater than 32", file=sys.stderr)
        die = True
    if not opts.snp:
        # the reference has no explicit check and dies in MultiCount's
        # site-FASTA gzopen (src/MultiCount.hpp:216); a clean CLI error
        # beats replicating that crash
        print("Error: Missing variants (-s) file", file=sys.stderr)
        die = True
    elif not os.path.exists(opts.snp):
        print(
            f"Error: Unable to load variants (-s) file {opts.snp}",
            file=sys.stderr,
        )
        die = True
    if not files:
        print("Error: Need Input File", file=sys.stderr)
        die = True
    if not os.path.exists(opts.ref):
        print("Error: Unable to load reference file", file=sys.stderr)
        die = True
    if len(files) > 1:
        print("ntsm vcf: exactly one VCF expected", file=sys.stderr)
        die = True
    if die:
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    t0 = time.monotonic()
    from ntsm_tpu_torch.io.sites import load_site_table
    from ntsm_tpu_torch.vcf.convert import VCFConverter

    table = load_site_table(opts.snp, opts.k, allow_dupes=opts.dupes)
    conv = VCFConverter(table, opts)
    conv.count(files[0])
    if not pca_prefix:
        if opts.verbose > 1:
            print("Outputting counts", file=sys.stderr)
        if output_counts:
            conv.output_counts()
    else:
        if opts.verbose > 1:
            print(
                "Outputting matrix and normalization values for PCA",
                file=sys.stderr,
            )
        conv.output_matrix(pca_prefix)

    from ntsm_tpu_torch.cli.count_cmd import _rss_kb

    print(
        f"Time: {time.monotonic() - t0:g} s Memory: {_rss_kb()} kbytes",
        file=sys.stderr,
    )
    return 0
