"""eval_cli.load_mb_s (MB/s): the count-file loader's rate, the bytes it
read in the traced passes (the program's counter
io/countfile.py:counters["bytes"], taken before and after each pass) over
the seconds of their ntsm.eval.load spans; None where the program has no
such counter or span."""


def read(ctx):
    read_bytes, seconds = 0, 0.0
    for t, b in zip(ctx["traces"], ctx["bytes_read"]):
        s, _ = t.span_total("ntsm.eval.load")
        if b is None or s <= 0:
            return None
        read_bytes += b
        seconds += s
    return read_bytes / 1e6 / seconds if seconds > 0 else None
