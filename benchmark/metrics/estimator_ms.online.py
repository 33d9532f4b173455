"""ms a call of the step's estimator stage, captured alone (the online path)."""
from benchmark.readers import stage_ms


def read(record):
    return stage_ms(record, "online", "estimator")
