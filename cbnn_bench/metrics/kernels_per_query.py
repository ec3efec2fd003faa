"""Device kernels in the profiled slice over its queries (device trace)."""
READS = ("trace",)


def read(rec):
    t = rec["trace"]
    if t is None:
        return None
    return t["kernels"] / t["queries"]
