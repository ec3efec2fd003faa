"""The whole query's share of the card's int8 peak: the frozen ring-product
work of its linear layers (counts.py) over the mean time of the window's
queries before the profiled slice times 1,979 TOP/s.  Read in the traced
run beside the kernels' rooflines."""
from cbnn_bench import peaks

READS = ("trace", "count", "query_s")


def read(rec):
    if rec["trace"] is None or not rec["query_s"]:
        return None
    return 100 * rec["count"]["ops"] / (rec["query_s"] * peaks.INT8_OPS)
