"""count.parse_s (s/pass): the reader threads' ntsm.count.parse spans a
pass, summed over the threads (io/fastx.py:ParallelFileReader, one thread
a file group: the native parse of each batch; utils/spans.py writes them
into the trace on their own thread ids); None where the program opens no
such span."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.count.parse")
