"""Layered configuration loading with reference-compatible precedence (a
copy of the reference package's ``config/loader.py``).

The reference loads parameters from several sources in a fixed precedence order
(reference: src/commandline/main.cpp:298-327, src/util/parameter_parser.cpp):
  data/cmd.json -> values embedded in data.jsonl -> parameters.txt / vio_config.yaml
  -> calibration.json -> argv (re-parsed last, highest precedence).

This module implements the same key/value surface:
  * ``parameters.txt``: lines of ``key value;`` or ``key value`` pairs separated by
    semicolons/whitespace, keys like ``cameraTrailLength`` (group inferred) or
    ``odometry.cameraTrailLength``.
  * YAML subset (``key: value`` lines) -- full YAML via pyyaml when available.
  * JSON (calibration.json style: focalLength, principalPointX, ...).
  * argv style ``-key=value`` flags.
"""
from __future__ import annotations

import json
import re
from dataclasses import fields
from typing import Dict, List, Optional, Tuple

from .params_generated import Parameters


def _group_index(params: Parameters) -> Dict[str, List[str]]:
    """map bare parameter name -> list of groups defining it"""
    idx: Dict[str, List[str]] = {}
    for g in ("odometry", "tracker", "slam"):
        for f in fields(getattr(params, g)):
            idx.setdefault(f.name, []).append(g)
    return idx


class UnknownParameterError(KeyError):
    pass


_VIDEO_ROTATIONS = {
    "NONE": ((1.0, 0.0), (0.0, 1.0)),
    "CW90": ((0.0, 1.0), (-1.0, 0.0)),
    "CW180": ((-1.0, 0.0), (0.0, -1.0)),
    "CW270": ((0.0, -1.0), (1.0, 0.0)),
}


def apply_video_rotation(params: Parameters, value: str) -> None:
    """videoRotation=NONE|CW90|CW180|CW270: premultiply the top-left 2x2 of
    imuToCamera by the image rotation (reference: parameters_base.cpp:38-66;
    like the reference, repeated application cumulates). The frame source must
    rotate the images correspondingly (cli reads params.videoRotationSteps)."""
    import numpy as np

    if value not in _VIDEO_ROTATIONS:
        raise ValueError(f"unknown videoRotation: {value!r}")
    from ..geometry.poses import vec2matrix

    rot = np.asarray(_VIDEO_ROTATIONS[value])
    m = np.array(vec2matrix(params.odometry.imuToCameraMatrix), dtype=float)
    m[:2, :2] = rot @ m[:2, :2]
    params.odometry.imuToCameraMatrix = tuple(m.T.flatten())
    steps = {"NONE": 0, "CW90": 1, "CW180": 2, "CW270": 3}[value]
    params.videoRotationSteps = (getattr(params, "videoRotationSteps", 0)
                                 + steps) % 4


def set_key_value(params: Parameters, key: str, value) -> None:
    """Set ``group.name`` or bare ``name`` (group inferred; ambiguous -> error)."""
    if key == "videoRotation":
        apply_video_rotation(params, str(value))
        return
    if "." in key:
        group, name = key.split(".", 1)
        params.set_parameter(group, name, value)
        return
    idx = _group_index(params)
    groups = idx.get(key)
    if not groups:
        raise UnknownParameterError(key)
    if len(groups) > 1:
        raise UnknownParameterError(f"ambiguous parameter {key!r} in groups {groups}")
    params.set_parameter(groups[0], key, value)


def apply_parameters_text(params: Parameters, text: str) -> None:
    """Parse the reference's delimited ``parameters.txt`` format.

    Format: whitespace/semicolon-delimited ``key value`` pairs
    (reference: src/util/parameter_parser.cpp parseDelimited).
    """
    tokens = [t for t in re.split(r"[;\s]+", text) if t and not t.startswith("#")]
    if len(tokens) % 2 != 0:
        raise ValueError("odd number of tokens in parameters.txt input")
    for k, v in zip(tokens[::2], tokens[1::2]):
        set_key_value(params, k, v)


def apply_yaml(params: Parameters, text: str) -> None:
    """Parse a vio_config.yaml. Uses pyyaml if available, else a flat subset."""
    try:
        import yaml  # type: ignore

        data = yaml.safe_load(text) or {}
    except ImportError:
        data = {}
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            data[k.strip()] = v.strip()
    for k, v in _flatten(data):
        set_key_value(params, k, v)


def _flatten(data, prefix="") -> List[Tuple[str, object]]:
    out = []
    for k, v in data.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_flatten(v, key + "."))
        else:
            out.append((key, v))
    return out


def apply_argv(params: Parameters, argv: List[str]) -> List[str]:
    """Apply ``-key=value`` / ``-flag`` (bool true) args; returns unrecognized ones."""
    rest = []
    for arg in argv:
        if not arg.startswith("-"):
            rest.append(arg)
            continue
        body = arg.lstrip("-")
        if "=" in body:
            k, v = body.split("=", 1)
        else:
            k, v = body, "true"
        try:
            set_key_value(params, k, v)
        except (UnknownParameterError, AttributeError):
            rest.append(arg)
    return rest


# --- calibration.json (reference: src/commandline/parameters.hpp:49-91) ---

_CALIB_KEYS = {
    "focalLengthX": ("tracker", "focalLengthX"),
    "focalLengthY": ("tracker", "focalLengthY"),
    "focalLength": ("tracker", "focalLength"),
    "principalPointX": ("tracker", "principalPointX"),
    "principalPointY": ("tracker", "principalPointY"),
    "distortionCoefficients": ("tracker", "distortionCoeffs"),
    "imuToCameraMatrix": ("odometry", "imuToCameraMatrix"),
}
_CALIB_KEYS_SECOND = {
    "focalLengthX": ("tracker", "secondFocalLengthX"),
    "focalLengthY": ("tracker", "secondFocalLengthY"),
    "focalLength": ("tracker", "secondFocalLength"),
    "principalPointX": ("tracker", "secondPrincipalPointX"),
    "principalPointY": ("tracker", "secondPrincipalPointY"),
    "distortionCoefficients": ("tracker", "secondDistortionCoeffs"),
    "imuToCameraMatrix": ("odometry", "secondImuToCameraMatrix"),
}


def apply_calibration_json(params: Parameters, text: str) -> None:
    data = json.loads(text)
    cameras = data.get("cameras", [data])
    for i, cam in enumerate(cameras[:2]):
        keymap = _CALIB_KEYS if i == 0 else _CALIB_KEYS_SECOND
        model = cam.get("model", "")
        if model in ("kannala-brandt4", "KANNALA_BRANDT4", "fisheye"):
            params.tracker.fisheyeCamera = True
        for k, (g, n) in keymap.items():
            if k in cam:
                v = cam[k]
                if isinstance(v, list) and v and isinstance(v[0], list):
                    # row-major nested matrix -> column-major flat (reference convention)
                    import numpy as np

                    v = list(np.asarray(v, dtype=float).T.flatten())
                params.set_parameter(g, n, v)


def load_parameters(
    parameters_txt: Optional[str] = None,
    yaml_text: Optional[str] = None,
    calibration_json: Optional[str] = None,
    argv: Optional[List[str]] = None,
    base: Optional[Parameters] = None,
) -> Parameters:
    """Apply configuration sources in the reference precedence order."""
    params = base if base is not None else Parameters()
    if parameters_txt:
        apply_parameters_text(params, parameters_txt)
    if yaml_text:
        apply_yaml(params, yaml_text)
    if calibration_json:
        apply_calibration_json(params, calibration_json)
    if argv:
        apply_argv(params, argv)
    return params
