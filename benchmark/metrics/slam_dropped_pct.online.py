"""The share, in %, of the untraced window's SLAM keyframe candidates that
the coupling dropped because the worker was behind (``slam.dropped`` over
``slam.candidates``)."""


def read(record):
    counters = (record.get("recorder") or {}).get("counters") or {}
    if not counters.get("slam.candidates"):
        return None
    return 100.0 * counters.get("slam.dropped", 0) / counters["slam.candidates"]
