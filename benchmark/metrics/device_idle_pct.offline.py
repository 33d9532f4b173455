"""The card's idle share of the traced window (the offline path)."""
from benchmark.readers import idle_pct


def read(record):
    return idle_pct(record, "offline")
