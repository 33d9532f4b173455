"""A EuRoC ASL (mav0) tree writer for the port's tests and ``chip_smoke.py``:
a synthetic world rendered by ``hybvio_tpu_torch.io.synthetic``, its frames
optionally warped through a radial lens, written as the layout that
``hybvio_tpu_torch.io.euroc`` reads (sensor.yaml files, PNG or PGM frames,
imu0 and the ground truth). PNG is encoded with the standard library's
zlib. Imports neither jax nor ``hybvio_tpu``: ``chip_smoke.py`` runs it on
a machine without them.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from hybvio_tpu_torch.frontend.rectify import build_remap, remap
from hybvio_tpu_torch.geometry.cameras import build_pinhole
from hybvio_tpu_torch.io.synthetic import render_view

def encode_png_gray(img: np.ndarray) -> bytes:
    """An 8-bit grayscale (H, W) uint8 image as PNG bytes (no filtering,
    zlib from the standard library)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)  # filter byte 0 a row
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def encode_pgm(img: np.ndarray) -> bytes:
    """An 8-bit grayscale (H, W) uint8 image as binary PGM (P5) bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode() + img.tobytes()


def sensor_yaml(width: int, height: int, fx: float, fy: float, cx: float, cy: float,
                distortion, imu_to_camera, rate_hz: float = 20.0) -> str:
    """A camera's sensor.yaml in EuRoC's format: T_BS = imu_to_camera^-1,
    radial-tangential distortion (k1, k2, p1, p2)."""
    T_BS = np.linalg.inv(np.asarray(imu_to_camera, np.float64))
    data = ",\n        ".join(", ".join(f"{v:.15g}" for v in row) for row in T_BS)
    dist = ", ".join(f"{v:.15g}" for v in (list(distortion) + [0.0] * 4)[:4])
    return ("%YAML:1.0\nsensor_type: camera\nT_BS:\n  rows: 4\n  cols: 4\n"
            f"  data: [{data}]\nrate_hz: {rate_hz:g}\nresolution: [{width}, {height}]\n"
            f"camera_model: pinhole\nintrinsics: [{fx:.15g}, {fy:.15g}, {cx:.15g}, {cy:.15g}]\n"
            f"distortion_model: radial-tangential\ndistortion_coefficients: [{dist}]\n")


def write_euroc(mav_dir: str, yamls, frame_ns, frames, imu_rows, gt_rows, fmt: str = "png"):
    """Write a mav0 tree: per camera c its ``yamls[c]`` sensor.yaml,
    data.csv and data/<ns>.<fmt> for every ``frame_ns`` (``frames(c, k)``
    gives frame k as (H, W) uint8), imu0/data.csv from ``imu_rows`` (ns, w
    xyz, a xyz) and the ground truth from ``gt_rows`` (ns, p xyz, q wxyz).
    ``fmt`` is "png" or "pgm". Returns the number of image files."""
    encode = {"png": encode_png_gray, "pgm": encode_pgm}[fmt]
    n = 0
    for c, yaml in enumerate(yamls):
        cdir = os.path.join(mav_dir, f"cam{c}")
        os.makedirs(os.path.join(cdir, "data"), exist_ok=True)
        with open(os.path.join(cdir, "sensor.yaml"), "w") as f:
            f.write(yaml)
        with open(os.path.join(cdir, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for k, ns in enumerate(frame_ns):
                name = f"{int(ns)}.{fmt}"
                with open(os.path.join(cdir, "data", name), "wb") as img:
                    img.write(encode(frames(c, k)))
                f.write(f"{int(ns)},{name}\n")
                n += 1
    os.makedirs(os.path.join(mav_dir, "imu0"), exist_ok=True)
    with open(os.path.join(mav_dir, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for ns, *v in imu_rows:
            f.write(f"{int(ns)}," + ",".join(repr(float(x)) for x in v) + "\n")
    gdir = os.path.join(mav_dir, "state_groundtruth_estimate0")
    os.makedirs(gdir, exist_ok=True)
    with open(os.path.join(gdir, "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for ns, *v in gt_rows:
            f.write(f"{int(ns)}," + ",".join(repr(float(x)) for x in v) + "\n")
    return n


def write_euroc_sequence(mav_dir, seq, exts, fx, fy, cx, cy, width, height, coeffs=(),
                         n_frames=None, fmt="png", blob_sigma=1.4):
    """Write ``seq`` as a EuRoC mav0 tree (``write_euroc``): the
    first ``n_frames`` frames of one camera per extrinsic of ``exts``, each
    rendered pinhole and, with radial ``coeffs`` (k1, k2), warped through
    that distorted lens (frontend/rectify.py ``build_remap`` / ``remap`` on
    the CPU) as a real lens records it, then quantized to uint8; every IMU
    sample of the sequence and the ground truth at every frame; the
    sensor.yaml files carry the intrinsics, ``coeffs`` and the extrinsics.
    Returns the number of frames."""
    idx = seq.frame_sample_idx[:n_frames] if n_frames else seq.frame_sample_idx
    warp = None
    if any(c != 0.0 for c in coeffs):
        pin = build_pinhole(fx, fy, cx, cy, width=width, height=height)
        lens = build_pinhole(fx, fy, cx, cy, coeffs=tuple(coeffs) + (0.0,), width=width,
                             height=height)
        warp = build_remap(pin, lens, width, height, torch.float64, device="cpu")

    def frame(c, k):
        s = idx[k]
        img = render_view(seq.landmarks, seq.pos[s], seq.quat[s], exts[c], fx, fy, cx, cy,
                          width, height, blob_sigma=blob_sigma)
        if warp is not None:
            img = remap(torch.as_tensor(img), warp).numpy()
        return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)

    ns = lambda t: int(round(t * 1e9))
    write_euroc(
        mav_dir, [sensor_yaml(width, height, fx, fy, cx, cy, coeffs, e) for e in exts],
        [ns(seq.times[k]) for k in idx], frame,
        [(ns(seq.times[k]), *seq.gyro[k], *seq.acc[k]) for k in range(len(seq.times))],
        [(ns(seq.times[k]), *seq.pos[k], *seq.quat[k]) for k in idx], fmt=fmt)
    return len(idx)
