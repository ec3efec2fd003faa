"""Images of every query completed in the window over the window's
seconds (host clock; the window ends when its last query's logits reach
the host)."""
READS = ("queries", "batch", "window_s")


def read(rec):
    return rec["queries"] * rec["batch"] / rec["window_s"]
