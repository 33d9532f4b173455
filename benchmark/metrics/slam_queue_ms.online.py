"""Mean ms a submitted SLAM frame waits for the worker (``slam.queue``:
submission to the worker's start) over the untraced window."""


def read(record):
    return ((record.get("recorder") or {}).get("ms") or {}).get("slam.queue")
