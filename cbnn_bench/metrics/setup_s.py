"""Seconds from the process's start to the window's first query: imports,
the weights, compiling the secure model, kernel builds on a first run,
the tape pool's first buffers and the warm-up queries (host clock)."""
READS = ("setup_s",)


def read(rec):
    return rec["setup_s"]
