"""count.step_roofline (%): the fused count step (count_step_kernel,
csrc/hash_probe_count.cu): the least time of the bytes and operations a
pass's batches need (portbench/roofline.py, from the reference's totals)
over the kernel's device time in the trace."""

from portbench import roofline


def read(ctx):
    dev = least = 0.0
    tot = ctx["totals"]
    for t in ctx["traces"]:
        launches = sum(1 for n, _, _, c in t.device if c == "kernel" and "count_step_kernel" in n)
        dev += t.kernel_s("count_step_kernel")
        least += roofline.count_step_least_s(
            3 / 8 * tot["total_bases"], tot["total_kmers"], tot["total_kmers"],
            tot["total_hits"], ctx["n_buckets"], launches)
    return 100.0 * least / dev if dev > 0 else None
