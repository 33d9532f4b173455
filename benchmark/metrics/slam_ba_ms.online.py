"""Mean device ms of the keyframe-rate local BA's program call
(``slam.local_ba_device``: CUDA events on the SLAM worker's stream around
it) over the untraced window."""


def read(record):
    return ((record.get("recorder") or {}).get("ms") or {}).get("slam.local_ba_device")
