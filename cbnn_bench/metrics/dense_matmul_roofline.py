"""The dense ring products' share of their roofline: the frozen bound of
the slice's dense launches (counts.py: B1 with shared weights, B3 with
public ones) over the device time of every operation launched inside
them (device trace)."""
READS = ("trace", "count")


def read(rec):
    t = rec["trace"]
    if t is None or t["dense_s"] <= 0 or rec["count"]["dense_bound_s"] <= 0:
        return None
    return 100 * rec["count"]["dense_bound_s"] * t["queries"] / t["dense_s"]
