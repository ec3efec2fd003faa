"""The grouped depthwise ring products' share of their roofline (B2 with
shared weights, B4 with public ones), as ``dense_matmul_roofline``."""
READS = ("trace", "count")


def read(rec):
    t = rec["trace"]
    if t is None or t["depthwise_s"] <= 0 \
            or rec["count"]["depthwise_bound_s"] <= 0:
        return None
    return (100 * rec["count"]["depthwise_bound_s"] * t["queries"]
            / t["depthwise_s"])
