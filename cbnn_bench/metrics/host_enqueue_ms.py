"""Median host time from the call into the runner to its return, before
the logits' copy waits for the device, over the window's queries before
the profiled slice (host clock)."""
import statistics

READS = ("enqueue_s",)


def read(rec):
    if not rec["enqueue_s"]:
        return None
    return 1e3 * statistics.median(rec["enqueue_s"])
