"""Mean host ms of the SLAM worker's ``slam.frame`` span over the untraced
window: a submitted frame's conversion, its features' pixels and
``Slam.add_frame`` (the session's stages)."""


def read(record):
    return ((record.get("recorder") or {}).get("ms") or {}).get("slam.frame")
