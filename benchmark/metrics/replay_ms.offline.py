"""Device ms a step of the window, copy-in and copy-out included: CUDA
events around each call of the captured batched step, summed over the
window's steps and divided by them."""


def read(record):
    return record.get("replay_ms") if record.get("path") == "offline" else None
