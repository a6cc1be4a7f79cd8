"""eval_pca.search_radius_s (s/pass): the program's
ntsm.eval.candidates.search.radius spans a -p pass (eval/search_kernel.py:
each row block's radius kernel passes, csrc/pca_radius.cu, the offsets of
each row's matches and their compaction).  None for a program without the
span (a search on the host)."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.eval.candidates.search.radius")
