"""eval_pca.search_order_s (s/pass): the program's
ntsm.eval.candidates.search.order spans a -p pass (eval/search_kernel.py:
the pruning rules, each row's matches by distance, the exhaustive rows'
lists, the list by row and its host copy).  None for a program without
the span."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.eval.candidates.search.order")
