"""The card's idle share of the traced window (the online path)."""
from benchmark.readers import idle_pct


def read(record):
    return idle_pct(record, "online")
