"""``ntsm eval`` — flag-compatible with ntsmEval (src/ntSeqMatchEval.cpp);
counterpart of ntsm_tpu/cli/eval_cmd.py.

Dispatch: 1 file -> QC mode; --only_merge -> merge only; otherwise
all-vs-all, or with -p the PCA-filtered comparison (-b its debug-recall
harness); -e merges afterwards (ntSeqMatchEval.cpp:304-341).
"""

from __future__ import annotations

import contextlib
import getopt
import os
import shutil
import sys
import tempfile
import time

from ntsm_tpu_torch.options import Options

HELP = """Usage: ntsm eval [FILES...]
Processes sets of counts files and compares their similarity.
If only a single file is provided general QC information returned.
  -t, --threads              Number of threads to run.[1]
  -s, --score_thresh = FLOAT Score threshold [0.500000]
  -a, --all                  Output results of all tests tried, not just those that
                             pass the score threshold.
  -w, --skew = FLOAT         Divides the score by coverage. Formula: (cov1*cov2)^skew
                             Set to zero for no skew.[0.200000]
  -c, --min_cov = INT        Keep only sites with this coverage and above.[1]
  -g, --genome_size = INT    Diploid genome size for error rate estimation.
                             [6200000000]
  -e, --merge = STR          After analysis merge counts and output to file.
  -o, --only_merge           Do not perform an analysis. Only functions when
                             -e (--merge) option is specified.
  -p, --pca = STR            Use PCA information to speed up analysis. Input is a
                             set of rotational values from a PCA.
  -d, --dim = INT            Number of dimensions to consider in PCA. [20]
  -n, --norm = STR           Set of values use to center the data before rotation
                             during PCA. [Required if -p is enabled]
  -r, --error_rate = FLOAT   Error rate threshold for PCA based search [0.010000]
  -1, --miss_small = FLOAT   Missing site threshold small for PCA based search [0.010000]
  -2, --miss_large = FLOAT   Missing site threshold large PCA based search [0.300000]
  -S, --small = FLOAT        Search radius for small PCA based search [2.000000]
  -l, --large = FLOAT        Search radius for large PCA based search [15.000000]
  -b, --debug = STR          Debug output with ground-truth same-sample groups.
  -h, --help                 Display this dialog.
  -v, --verbose              Display verbose output.
      --version              Print version information.
      --engine = STR         extension: auto (default), exact or cuda. exact is
                             the float64 host engine; cuda the device engine
                             (the hand-written pair kernels on --device cuda,
                             their plain PyTorch versions on --device cpu);
                             auto is cuda wherever pairs are scored (-a, the
                             default all-vs-all, -p) and exact for the modes
                             that score none (one file, -o, -b).
      --device = STR         extension: cuda (default) or cpu, for the cuda
                             engine. cuda requires a CUDA device; the engine
                             never moves to the CPU on its own.
      --distributed          extension: several processes, one GPU each. Joins a
                             gloo process group (from JAX_COORDINATOR_ADDRESS /
                             JAX_NUM_PROCESSES / JAX_PROCESS_ID, or torchrun's
                             variables); every rank loads the count files, the
                             all-vs-all row blocks are dealt out to the ranks
                             and gathered on rank 0, which prints (and writes
                             -e); -p, QC and -b run whole on every rank. The
                             engine is cuda. NTSM_DISTRIBUTED=1 is equivalent.
"""

ENGINES = ("auto", "exact", "cuda")
DEVICES = ("cuda", "cpu")


class _Discard:
    """The table sink of the ranks other than 0 under --distributed."""

    def write(self, s) -> int:
        return len(s)


def run(argv) -> int:
    opts = Options()
    device = "cuda"
    distributed = bool(os.environ.get("NTSM_DISTRIBUTED"))
    try:
        parsed, files = getopt.gnu_getopt(
            argv,
            "t:vhs:c:m:aw:g:p:n:d:r:e:o1:2:S:l:b:",
            [
                "score_thresh=",
                "all",
                "min_cov=",
                "max_cov=",
                "skew=",
                "genome_size=",
                "threads=",
                "merge=",
                "only_merge",
                "help",
                "pca=",
                "norm=",
                "error_rate=",
                "miss_small=",
                "miss_large=",
                "small=",
                "large=",
                "debug=",
                "version",
                "verbose",
                "dim=",
                "engine=",
                "device=",
                "distributed",
            ],
        )
    except getopt.GetoptError as e:
        print(f"ntsm eval: {e}", file=sys.stderr)
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    for flag, val in parsed:
        if flag in ("-h", "--help"):
            print(HELP, file=sys.stderr)
            return 0
        elif flag == "--version":
            from ntsm_tpu_torch import __version__

            print(f"ntsm eval (ntsm_tpu_torch) {__version__}", file=sys.stderr)
            return 0
        elif flag in ("-a", "--all"):
            opts = opts.replace(all=True)
        elif flag in ("-s", "--score_thresh"):
            opts = opts.replace(score_thresh=float(val))
        elif flag in ("-w", "--skew"):
            opts = opts.replace(cov_skew=float(val))
        elif flag in ("-c", "--min_cov"):
            opts = opts.replace(min_cov=int(val))
        elif flag in ("-m", "--max_cov"):
            opts = opts.replace(max_cov=int(val))
        elif flag in ("-g", "--genome_size"):
            opts = opts.replace(genome_size=int(val))
        elif flag in ("-t", "--threads"):
            opts = opts.replace(threads=int(val))
        elif flag in ("-e", "--merge"):
            opts = opts.replace(merge=val)
        elif flag in ("-o", "--only_merge"):
            opts = opts.replace(only_merge=True)
        elif flag in ("-p", "--pca"):
            opts = opts.replace(pca=val)
        elif flag in ("-n", "--norm"):
            opts = opts.replace(norm=val)
        elif flag in ("-r", "--error_rate"):
            opts = opts.replace(pc_error_thresh=float(val))
        elif flag in ("-1", "--miss_small"):
            opts = opts.replace(pc_miss_site1=float(val))
        elif flag in ("-2", "--miss_large"):
            opts = opts.replace(pc_miss_site2=float(val))
        elif flag in ("-S", "--small"):
            opts = opts.replace(pc_search_radius1=float(val))
        elif flag in ("-l", "--large"):
            opts = opts.replace(pc_search_radius2=float(val))
        elif flag in ("-d", "--dim"):
            opts = opts.replace(dim=int(val))
        elif flag in ("-b", "--debug"):
            opts = opts.replace(debug=val)
        elif flag in ("-v", "--verbose"):
            opts = opts.replace(verbose=opts.verbose + 1)
        elif flag == "--engine":
            opts = opts.replace(engine=val)
        elif flag == "--device":
            device = val
        elif flag == "--distributed":
            distributed = True

    die = False
    for f in files:
        if not os.path.exists(f):
            print(f"ntsm eval: input file {f} does not exist", file=sys.stderr)
            die = True
    if not files:
        print("Error: Need Input File", file=sys.stderr)
        die = True
    if opts.pca and len(files) > 1 and not os.path.exists(opts.norm):
        print("Error: Need normalization file", file=sys.stderr)
        die = True
    if die:
        print("Try '--help' for more information.", file=sys.stderr)
        return 1
    # the port's own checks come after the reference's, whose texts they keep
    if opts.engine not in ENGINES or device not in DEVICES:
        print(f"Error: --engine must be one of {', '.join(ENGINES)} and "
              f"--device one of {', '.join(DEVICES)}", file=sys.stderr)
        return 1
    from ntsm_tpu_torch.eval.driver import run_eval, scores_pairs

    scores = scores_pairs(opts, len(files))
    if opts.engine == "auto":
        opts = opts.replace(engine="cuda" if scores else "exact")
    elif opts.engine == "exact" and len(files) > 1000 and not opts.only_merge:
        n_pairs = len(files) * (len(files) - 1) // 2
        print(
            f"ntsm eval: --engine exact scores {n_pairs} pairs one at a time "
            "on the host, which takes long at this size. The device engine "
            "(--engine cuda) produces identical integer columns and scores "
            "within ~1e-9.",
            file=sys.stderr,
        )
    if distributed:
        opts = opts.replace(engine="cuda")  # the distributed path is the device engine
    if opts.engine == "cuda" and device == "cuda" and scores:
        import torch

        if not torch.cuda.is_available():
            print("Error: --device cuda needs a CUDA device and none is available "
                  "(--device cpu runs the plain PyTorch path)", file=sys.stderr)
            return 1

    t0 = time.monotonic()
    from ntsm_tpu_torch.cli.count_cmd import _rss_kb
    from ntsm_tpu_torch.eval.model import load_count_data
    from ntsm_tpu_torch.utils import spans

    shield = contextlib.nullcontext()
    out = sys.stdout
    spool = None
    if distributed:
        from ntsm_tpu_torch.parallel import distributed as dist

        dist.init_distributed()
        if device == "cuda" and scores:
            device = dist.local_device()
        # every rank loads all count files and runs the same dispatch; the
        # table is buffered on rank 0 (spooled to disk past 16 MB: an
        # all-vs-all table is ~1 GB at N = 3202) and copied to stdout at
        # the end, and the other ranks write into a discarding sink
        shield = dist.stdout_shield()
        if dist.rank() == 0:
            out = spool = tempfile.SpooledTemporaryFile(
                max_size=16 << 20, mode="w+", encoding="utf-8")
        else:
            out = _Discard()

    if opts.verbose > 0:
        print("Reading count files", file=sys.stderr)
    with spans.recording("eval"):  # the load's stages, spans while torch.profiler traces
        data = load_count_data(files, opts)
    with shield:
        run_eval(data, opts, out, device=device)
    if distributed and dist.rank() != 0:
        return 0
    if spool is not None:
        spool.seek(0)
        shutil.copyfileobj(spool, sys.stdout, 1 << 20)
        spool.close()
    print(
        f"Time: {time.monotonic() - t0:g} s Memory: {_rss_kb()} kbytes",
        file=sys.stderr,
    )
    return 0
