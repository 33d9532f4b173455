"""What the per-layer metrics' readers (``metrics/<name>.py``) share: each
reads one number from a run's record, or None where the record has
nothing for it (another path, or no trace)."""
from __future__ import annotations

from . import roofline


def on_path(record: dict, path: str) -> bool:
    """Whether the record is of the path (``offline`` or ``online``)."""
    return record.get("path") == path


def stage_ms(record: dict, path: str, stage: str):
    """ms a call of a stage of the step, captured alone at the window's
    shapes on the state the window reached."""
    if not on_path(record, path):
        return None
    return (record.get("stages_ms") or {}).get(stage)


def idle_pct(record: dict, path: str):
    """The share of the traced window in which no kernel or copy ran on
    the card."""
    tr = record.get("trace")
    if not on_path(record, path) or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernels_roofline(record: dict, path: str):
    """The summed least time of the five kernels' launches in the traced
    window over their summed device time there, in %."""
    tr = record.get("trace")
    if not on_path(record, path) or not tr or not record.get("launches"):
        return None
    return roofline.share_pct(record["launches"], tr["kernel_s"])
