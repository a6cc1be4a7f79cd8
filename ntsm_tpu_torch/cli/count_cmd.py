"""``ntsm count`` — flag-compatible with ntsmCount (src/ntSeqMatchCount.cpp);
counterpart of ntsm_tpu/cli/count_cmd.py.

Output contract (byte-compatible):
  stdout: #@TK/#@KS header + per-site count table
          (FingerPrint.hpp:261-311)
  stderr: info summary + "Time: ... Memory: ..." line
          (ntSeqMatchCount.cpp:181-183)
"""

from __future__ import annotations

import contextlib
import getopt
import glob
import os
import sys
import time

import torch

from ntsm_tpu_torch.options import Options

HELP = """Usage: ntsm count -s [FASTA] [OPTION]... [FILES...]
  -t, --threads = INT    Number of threads to run.[1]
  -m, --maxCov = INT     k-mer coverage threshold for early
                         termination. [inf]
  -o, --output = STR     Output for summary file.
  -d, --dupes            Allow shared k-mers between sites to
                         be counted.
  -s, --snp = STR        Interleaved fasta of SNP sites to
                         k-merize. [required]
  -k, --kmer = INT       k-mer size used. [19]
  -h, --help             Display this dialog.
  -v, --verbose          Display verbose output.
      --version          Print version information.
      --engine = STR     extension: cuda (default) or golden. cuda runs the
                         batched engine (hand-written CUDA kernels on
                         --device cuda, their plain PyTorch versions on
                         --device cpu); golden is the sequential numpy
                         oracle.
      --device = STR     extension: cuda (default) or cpu. cuda requires a
                         CUDA device; the engine never moves to the CPU on
                         its own.
      --checkpoint = STR extension: restartable snapshot file; an
                         interrupted run resumes from it automatically.
      --checkpoint-every = INT
                         batches between snapshots [64].
      --trace = STR      extension: write a torch.profiler trace of the
                         count pipeline (its stages, and the card's kernels
                         and copies) to this directory, as a *.pt.trace.json
                         that TensorBoard and Perfetto open.
      --seglen = INT     extension: device segment length [256]; batch rows
                         scale inversely so the bases per batch stay
                         constant.
      --distributed      extension: several processes, one GPU each. Joins a
                         gloo process group (from JAX_COORDINATOR_ADDRESS /
                         JAX_NUM_PROCESSES / JAX_PROCESS_ID, or torchrun's
                         MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK),
                         shards the input files across the ranks, sums the
                         count vectors, and prints from rank 0 only.
                         NTSM_DISTRIBUTED=1 is equivalent.
"""

ENGINES = ("cuda", "golden")
DEVICES = ("cuda", "cpu")


def run(argv) -> int:
    opts = Options()
    engine = "cuda"
    device = "cuda"
    distributed = bool(os.environ.get("NTSM_DISTRIBUTED"))
    try:
        parsed, files = getopt.gnu_getopt(
            argv,
            "s:t:vhk:m:do:",
            [
                "threads=",
                "maxCov=",
                "output=",
                "dupes",
                "snp=",
                "kmer=",
                "help",
                "version",
                "verbose",
                "engine=",
                "device=",
                "checkpoint=",
                "checkpoint-every=",
                "trace=",
                "seglen=",
                "distributed",
            ],
        )
    except getopt.GetoptError as e:
        print(f"ntsm count: {e}", file=sys.stderr)
        print("Try '--help' for more information.", file=sys.stderr)
        return 1

    for flag, val in parsed:
        if flag in ("-h", "--help"):
            print(HELP, file=sys.stderr)
            return 0
        elif flag == "--version":
            from ntsm_tpu_torch import __version__

            print(f"ntsm count (ntsm_tpu_torch) {__version__}", file=sys.stderr)
            return 0
        elif flag in ("-t", "--threads"):
            opts = opts.replace(threads=int(val))
        elif flag in ("-m", "--maxCov"):
            opts = opts.replace(cov_thresh=float(val))
        elif flag in ("-o", "--output"):
            opts = opts.replace(summary=val)
        elif flag in ("-d", "--dupes"):
            opts = opts.replace(dupes=True)
        elif flag in ("-s", "--snp"):
            opts = opts.replace(snp=val)
        elif flag in ("-k", "--kmer"):
            opts = opts.replace(k=int(val))
        elif flag in ("-v", "--verbose"):
            opts = opts.replace(verbose=opts.verbose + 1)
        elif flag == "--engine":
            engine = val
        elif flag == "--device":
            device = val
        elif flag == "--checkpoint":
            opts = opts.replace(checkpoint=val)
        elif flag == "--checkpoint-every":
            opts = opts.replace(checkpoint_every=int(val))
        elif flag == "--seglen":
            L = int(val)
            if L < 64 or L % 8:
                print("ntsm count: --seglen must be a multiple of 8, >= 64",
                      file=sys.stderr)
                return 1
            opts = opts.replace(
                segment_len=L,
                batch_reads=max(1, opts.batch_reads * 256 // L),
            )
        elif flag == "--trace":
            opts = opts.replace(trace=val)
        elif flag == "--distributed":
            distributed = True

    die = False
    if opts.k > 32:
        print("Error: k cannot be greater than 32", file=sys.stderr)
        die = True
    if not opts.snp:
        print("Error: Missing variants (-s) file", file=sys.stderr)
        die = True
    for f in files:
        if not os.path.exists(f):
            print(f"ntsm count: input file {f} does not exist", file=sys.stderr)
            die = True
    if not files:
        print("Error: Need input files", file=sys.stderr)
        die = True
    if die:
        print("Try '--help' for more information.", file=sys.stderr)
        return 1
    # the port's own checks come after the reference's, whose texts they keep
    if engine not in ENGINES or device not in DEVICES:
        print(f"Error: --engine must be one of {', '.join(ENGINES)} and "
              f"--device one of {', '.join(DEVICES)}", file=sys.stderr)
        return 1
    if engine == "cuda" and device == "cuda" and not torch.cuda.is_available():
        print("Error: --device cuda needs a CUDA device and none is available "
              "(--device cpu runs the plain PyTorch path)", file=sys.stderr)
        return 1

    t0 = time.monotonic()
    from ntsm_tpu_torch.count.engine import format_info_summary, run_count
    from ntsm_tpu_torch.io.countfile import format_counts
    from ntsm_tpu_torch.io.sites import load_site_table

    shield = contextlib.nullcontext()
    my_files = files
    if distributed:
        from ntsm_tpu_torch.parallel import distributed as dist

        dist.init_distributed()
        rank, world = dist.rank(), dist.world_size()
        if engine == "cuda" and device == "cuda":
            device = dist.local_device()
        shield = dist.stdout_shield()
        my_files = dist.host_file_shard(files)
        if opts.checkpoint:
            # per-rank snapshots: each rank checkpoints its own file shard
            # under a rank-tagged path (the shard's filenames are in the
            # snapshot signature).  A resume with another world size would
            # never match the tagged names and would count from zero, so
            # stale tags are an error.
            tag = f".rank{rank}of{world}"
            stale = [p for p in glob.glob(f"{opts.checkpoint}.rank*of*")
                     if not p.endswith(f"of{world}")]
            if stale:
                print(
                    f"ntsm count: checkpoint {opts.checkpoint} has "
                    f"snapshots from a different world size "
                    f"({os.path.basename(stale[0])}); resume with the "
                    "original process count or delete them",
                    file=sys.stderr,
                )
                return 1
            opts = opts.replace(checkpoint=opts.checkpoint + tag)
        if opts.verbose:
            print(f"ntsm count: process {rank}/{world} counting {len(my_files)}/"
                  f"{len(files)} files", file=sys.stderr)

    with shield:
        if opts.verbose:
            print(f"Opening {opts.snp}", file=sys.stderr)
        table = load_site_table(opts.snp, opts.k, allow_dupes=opts.dupes)

        if engine == "golden":
            from ntsm_tpu_torch.count.golden import count_files

            result = count_files(table, my_files, cov_thresh=opts.cov_thresh)
            if result.early_term:
                print("Reached desired (-m) threshold", file=sys.stderr)
        else:
            result = run_count(table, my_files, opts, device=device)

        if distributed:
            from ntsm_tpu_torch.count.golden import max_counts_threshold

            local_early = result.early_term
            result = dist.merge_count_results(
                result, max_counts_thresh=max_counts_threshold(table.n_kmers, opts.cov_thresh))
            if result.early_term and not local_early:
                # the merged total crossed -m where this rank's own did not
                print("Reached desired (-m) threshold", file=sys.stderr)

    if distributed and rank != 0:
        return 0  # rank 0 owns stdout and the summary

    mx, sm = result.site_max_sum(table)
    sys.stdout.write(
        format_counts(table.site_ids, mx, sm, table.distinct, result.total_kmers, opts.k)
    )

    summary, warning = format_info_summary(table, result, opts)
    if opts.summary:
        with open(opts.summary, "w") as fh:
            fh.write(summary)
    if warning:
        print(warning, file=sys.stderr)
    print(summary, file=sys.stderr)
    print(
        f"Time: {time.monotonic() - t0:g} s Memory: {_rss_kb()} kbytes", file=sys.stderr
    )
    return 0


def _rss_kb() -> int:
    """VmRSS in kB, like Util::getRSS (src/Util.h:32-49)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1
