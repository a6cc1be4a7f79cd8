"""count.pack_s (s/pass): the producer thread's ntsm.count.pack spans a
pass (count/engine.py:_count_v3._producer: each batch's 2-bit pack and
valid bits into its pinned buffer, kernel_v2.pack_batch_fast); None where
the program opens no such span."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.count.pack")
