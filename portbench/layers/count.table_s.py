"""count.table_s (s/pass): the engine's ntsm.count.table span a pass
(count/engine.py:_count_v3, before the first batch: the site table's
build, kernel_v3.TableV3.from_hashes: the bucket count sized on the host,
the hashes uploaded, sorted and scattered into the planes on the device);
None where the program opens no such span."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.count.table")
