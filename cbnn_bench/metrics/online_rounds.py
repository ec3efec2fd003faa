"""Online communication rounds of one query (the system's comm ledger)."""
READS = ("ledger",)


def read(rec):
    return rec["ledger"]["online_rounds"]
