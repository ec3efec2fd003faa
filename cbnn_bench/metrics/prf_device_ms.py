"""Device milliseconds a query of the operations launched inside the
system's threefry PRF draws (``core.prf._threefry_tensor``): the
protocols' randomness, the client's sharing and, in a pool cell, the
plant's share (device trace)."""
READS = ("trace",)


def read(rec):
    t = rec["trace"]
    if t is None:
        return None
    return 1e3 * t["prf_s"] / t["queries"]
