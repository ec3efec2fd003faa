"""The 90th percentile of every window query's latency, from its issue
(secret sharing, a tape slice in a pool cell) to its logits on the host
(host clock)."""
import statistics

READS = ("latencies_s",)


def read(rec):
    lat = rec["latencies_s"]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[8]
