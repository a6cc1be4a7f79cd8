"""eval_pca.search_roofline (%): the radius kernel of the -p candidate
search (pca_radius_kernel: csrc/pca_radius.cu, both its passes) against
the least work of any search on the pass's inputs
(portbench/roofline_search.py: the reference's cloud and radii read once,
3 dim f64 operations and 12 bytes written for each pair inside a finite
radius), over the kernel's device time in the benchmark's torch.profiler
trace.  None without the kernel (a CPU run, or a program
that searches on the host)."""

from portbench.tracefile import kernel_share


def read(ctx):
    if "search_least_s" not in ctx:
        return None
    return kernel_share(ctx, "pca_radius", ctx["search_least_s"])
