"""Kilobytes the three parties exchange for one image: one query's online
and offline ledger bytes (in a pool cell the online ledger and the
plant's ledger of one slice) over the batch (the system's comm ledger)."""
READS = ("ledger", "batch")


def read(rec):
    led = rec["ledger"]
    return (led["online_bytes"] + led["offline_bytes"]) / rec["batch"] / 1e3
