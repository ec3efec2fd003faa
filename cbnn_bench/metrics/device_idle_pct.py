"""The share of a query's time in which no operation ran on the device:
100 less the device's busy time a query in the profiled slice (device
trace) over the mean time of the window's queries before the slice (host
clock), which the profiler has not slowed."""
READS = ("trace", "query_s")


def read(rec):
    t = rec["trace"]
    if t is None or not rec["query_s"]:
        return None
    return 100 * (1 - t["busy_s"] / t["queries"] / rec["query_s"])
