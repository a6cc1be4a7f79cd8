"""Public Python API (counterpart of ntsm_tpu/api.py).

The CLIs (`ntsm count|eval|vcf|sitegen`) wrap these. For pipelines that
want results as arrays/objects instead of files:

    import ntsm_tpu_torch.api as ntsm

    table = ntsm.load_sites("human_sites_n10.fa")
    result = ntsm.count(table, ["sample_R1.fq.gz", "sample_R2.fq.gz"])
    print(result.coverage(table), result.error_rate(table))
    ntsm.write_counts("sample_counts.txt", table, result)

    pairs = ntsm.evaluate(["a_counts.txt", "b_counts.txt"])  # -> list of rows

The device engines run on the card (`device="cuda"`, the default), which
must be there: without one they raise, and never move to the CPU on their
own.  `device="cpu"` runs their plain PyTorch versions.
"""

from __future__ import annotations

import io as _io

from ntsm_tpu_torch.count.golden import CountResult
from ntsm_tpu_torch.io.sites import SiteTable
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils import spans

__all__ = [
    "load_sites",
    "count",
    "write_counts",
    "evaluate",
    "merge_counts",
    "CountResult",
    "SiteTable",
    "Options",
]

COUNT_ENGINES = ("cuda", "golden")
EVAL_ENGINES = ("auto", "exact", "cuda")
DEVICES = ("cuda", "cpu")


def _check(engine: str, engines: tuple, device: str, on_device: bool) -> None:
    """The CLIs' checks: a known engine and device, and a card for a
    device engine on device "cuda"."""
    if engine not in engines or device not in DEVICES:
        raise ValueError(f"engine must be one of {', '.join(engines)} and device one of "
                         f"{', '.join(DEVICES)}, not {engine!r} and {device!r}")
    if on_device and device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("device cuda needs a CUDA device and none is available "
                               "(device cpu runs the plain PyTorch path)")


def load_sites(path: str, k: int = 19, allow_dupes: bool = False) -> SiteTable:
    """Load an interleaved site FASTA (REF/VAR entry per SNP site)."""
    from ntsm_tpu_torch.io.sites import load_site_table

    return load_site_table(path, k=k, allow_dupes=allow_dupes)


def count(
    table: SiteTable,
    fastx_files,
    *,
    max_cov: float | None = None,
    threads: int | None = None,
    checkpoint: str | None = None,
    engine: str = "cuda",
    device: str = "cuda",
    opts: Options | None = None,
) -> CountResult:
    """Count site k-mers in FASTA/FASTQ(.gz) reads (= ntsmCount).

    engine: "cuda" (default; the batched engine on `device`) or "golden"
    (the sequential numpy oracle, on the host).  Keyword conveniences are
    applied on top of `opts` when both are given."""
    _check(engine, COUNT_ENGINES, device, on_device=engine == "cuda")
    opts = opts or Options()
    if max_cov is not None:
        opts = opts.replace(cov_thresh=max_cov)
    if threads is not None:
        opts = opts.replace(threads=threads)
    if checkpoint is not None:
        opts = opts.replace(checkpoint=checkpoint)
    if engine == "golden":
        from ntsm_tpu_torch.count.golden import count_files

        return count_files(table, list(fastx_files), cov_thresh=opts.cov_thresh)
    from ntsm_tpu_torch.count.engine import run_count

    return run_count(table, list(fastx_files), opts, device=device)


def write_counts(path_or_file, table: SiteTable, result: CountResult) -> None:
    """Write a reference-byte-compatible counts.txt."""
    from ntsm_tpu_torch.io.countfile import format_counts

    mx, sm = result.site_max_sum(table)
    text = format_counts(
        table.site_ids, mx, sm, table.distinct, result.total_kmers, table.k
    )
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
    else:
        with open(path_or_file, "w") as fh:
            fh.write(text)


def evaluate(
    count_files,
    *,
    all_pairs: bool = True,
    engine: str = "auto",
    device: str = "cuda",
    opts: Options | None = None,
) -> list[dict]:
    """All-vs-all sample comparison (= ntsmEval -a): list of row dicts
    keyed by the reference's 26 column names.

    engine: "auto" (default: "cuda" wherever pairs are scored, as in the
    CLI), "exact" (the float64 host engine) or "cuda" (the device engine on
    `device`)."""
    from ntsm_tpu_torch.eval.driver import run_eval, scores_pairs
    from ntsm_tpu_torch.eval.model import load_count_data

    files = list(count_files)
    opts = (opts or Options()).replace(all=all_pairs)
    scores = scores_pairs(opts, len(files))
    if engine == "auto":
        engine = "cuda" if scores else "exact"
    _check(engine, EVAL_ENGINES, device, on_device=engine == "cuda" and scores)
    opts = opts.replace(engine=engine)
    with spans.recording("eval"):
        data = load_count_data(files, opts)
    buf = _io.StringIO()
    run_eval(data, opts, buf, device=device)
    return table_rows(buf.getvalue())


def table_rows(text: str) -> list[dict]:
    """The rows of an eval table (the CLI's stdout) as evaluate returns
    them: dicts keyed by the column names, numbers parsed."""
    from ntsm_tpu_torch.eval.exact import HEADER

    cols = HEADER.split("\t")
    out = []
    for line in text.splitlines()[1:]:
        vals = line.split("\t")
        row = dict(zip(cols, vals))
        for key in row:
            if key in ("sample1", "sample2"):
                continue  # filenames stay strings even if numeric
            try:
                row[key] = int(row[key])
            except ValueError:
                try:
                    row[key] = float(row[key])
                except ValueError:
                    pass
        out.append(row)
    return out


def merge_counts(count_files, out_path: str) -> None:
    """Merge sharded count files (= ntsmEval --merge): counts and #@TK sum,
    distinct columns kept."""
    from ntsm_tpu_torch.eval.merge import merge_counts as _merge
    from ntsm_tpu_torch.eval.model import load_count_data

    opts = Options(merge=out_path)
    with spans.recording("eval"):
        data = load_count_data(list(count_files), opts)
    _merge(data, out_path)
