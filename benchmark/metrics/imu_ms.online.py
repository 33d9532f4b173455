"""ms a call of the step's imu stage, captured alone (the online path)."""
from benchmark.readers import stage_ms


def read(record):
    return stage_ms(record, "online", "imu")
