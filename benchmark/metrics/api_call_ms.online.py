"""Host ms a frame inside the API's calls (``add_gyro``, ``add_acc``,
``add_frame_stereo``) over the window, the wait on the previous frame's
copy included."""


def read(record):
    return record.get("api_call_ms") if record.get("path") == "online" else None
