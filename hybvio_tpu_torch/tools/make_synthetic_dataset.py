"""Write a synthetic VIO dataset that the port's CLI runs, in the JSONL
layout (data.jsonl, frame_*.npy, the ground truth and a parameters.txt):

    python -m hybvio_tpu_torch.tools.make_synthetic_dataset out_dir [duration] [world]
    python -m hybvio_tpu_torch.cli.main -i=out_dir -o=out.jsonl

``world`` is "textured" (the default: a ray-cast value-noise scene with
dense gradients, ``io/textured.py``) or "blobs" (Gaussian blobs,
``io/synthetic.py``). ``make_euroc_dataset`` writes the same sequence in
the EuRoC ASL (mav0) layout, mono or stereo. The files equal those of the
JAX package's tool for the same arguments; the EuRoC frames are PNG,
encoded by PIL where it is installed (the same bytes as the JAX package's
tool), else by the standard library's zlib (the same pixels).
"""
from __future__ import annotations

import json
import os
import struct
import sys
import zlib

import numpy as np

from ..io.jsonl import Recorder
from ..io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
from ..io.textured import TexturedScene, textured_frame_renderer


def make_dataset(out_dir: str, duration: float = 6.0, width: int = 320,
                 height: int = 240, fx: float = 260.0, imu_rate: float = 100.0,
                 frame_rate: float = 10.0, seed: int = 0, n_landmarks: int = 300,
                 gyro_noise: float = 5e-4, acc_noise: float = 5e-3,
                 world: str = "textured", zoom: float = 0.0):
    """Write the dataset; returns (out_dir, frames written).

    zoom: a focal-length ramp over the run (a zooming lens): frame i
    renders and records fx * (1 + zoom * i / (n - 1)) in its per-frame
    cameraParameters. It needs world="blobs" (the textured renderer fixes
    its camera)."""
    if zoom:
        assert world == "blobs", "zoom requires the blobs renderer"
    seq = generate_sequence(duration=duration, imu_rate=imu_rate, frame_rate=frame_rate,
                            n_landmarks=n_landmarks, gyro_noise=gyro_noise,
                            acc_noise=acc_noise, seed=seed)
    if world == "textured":
        scene = TexturedScene(seed=seed, wall_radius=6.0)
        render_tex = textured_frame_renderer(scene, seq, SYNTH_IMU_TO_CAMERA, fx, fx,
                                             width / 2, height / 2, width, height)
    rec = Recorder(out_dir)
    # the extrinsics and intrinsics ride in the data file
    rec.f.write(json.dumps({
        "imuToCamera": [list(row) for row in np.asarray(SYNTH_IMU_TO_CAMERA)],
        "cameraInd": 0}) + "\n")
    # the dataset's tracker tuning, as a recorded benchmark ships a
    # parameters.txt: LK on these renders localizes to ~1-3 px, so the RANSAC
    # gates are wider than the 2 px defaults made for sharp images
    with open(os.path.join(out_dir, "parameters.txt"), "w") as pf:
        pf.write("ransac2Threshold 8.0;\nransac5Threshold 4.0;\n"
                 "visualR 0.5;\n")

    n_total = len(seq.frame_sample_idx)

    def fx_at(i):
        return fx * (1.0 + zoom * i / max(n_total - 1, 1)) if zoom else fx

    fi = 0
    frame_set = set(seq.frame_sample_idx.tolist())
    for k in range(len(seq.times)):
        t = float(seq.times[k])
        rec.gyro(t, seq.gyro[k])
        rec.acc(t, seq.acc[k])
        if k in frame_set:
            fxi = fx_at(fi)
            cam_params = [{
                "focalLengthX": fxi, "focalLengthY": fxi,
                "principalPointX": width / 2, "principalPointY": height / 2}]
            if world == "textured":
                img = render_tex(fi)
            else:
                img = render_view(
                    seq.landmarks, seq.pos[k], seq.quat[k], SYNTH_IMU_TO_CAMERA,
                    fxi, fxi, width / 2, height / 2, width, height, blob_sigma=1.2)
            rec.frame(t, [img], cam_params)
            rec.ground_truth(t, seq.pos[k], seq.quat[k])
            fi += 1
    rec.close()
    return out_dir, fi


def _encode_png_zlib(img: np.ndarray) -> bytes:
    """An 8-bit grayscale image as PNG bytes: no row filter, the standard
    library's zlib."""
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as PNG: with PIL where it is installed,
    else with ``_encode_png_zlib`` (the same pixels, other bytes)."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "wb") as f:
            f.write(_encode_png_zlib(np.ascontiguousarray(img, np.uint8)))
        return
    Image.fromarray(img).save(path)


def make_euroc_dataset(out_dir: str, duration: float = 4.0, width: int = 320,
                       height: int = 240, fx: float = 260.0,
                       imu_rate: float = 100.0, frame_rate: float = 10.0,
                       seed: int = 0, n_landmarks: int = 300,
                       gyro_noise: float = 5e-4, acc_noise: float = 5e-3,
                       stereo: bool = False, baseline: float = 0.11):
    """Write the same synthetic sequence (the blob world) in the EuRoC ASL
    (mav0) layout: cam*/data.csv, data/*.png and sensor.yaml, imu0/data.csv,
    state_groundtruth_estimate0/data.csv. Returns (out_dir, frames)."""
    seq = generate_sequence(duration=duration, imu_rate=imu_rate,
                            frame_rate=frame_rate, n_landmarks=n_landmarks,
                            gyro_noise=gyro_noise, acc_noise=acc_noise,
                            seed=seed)
    i2cs = [np.asarray(SYNTH_IMU_TO_CAMERA)]
    if stereo:
        second = i2cs[0].copy()
        second[0, 3] = -baseline
        i2cs.append(second)

    def yaml_for(i2c):
        T_BS = np.linalg.inv(i2c)
        rows = ",\n        ".join(
            ", ".join(f"{v:.12f}" for v in row) for row in T_BS)
        return (
            "%YAML:1.0\n"
            "sensor_type: camera\n"
            "T_BS:\n  rows: 4\n  cols: 4\n"
            f"  data: [{rows}]\n"
            "rate_hz: {:g}\n".format(frame_rate) +
            f"resolution: [{width}, {height}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{fx}, {fx}, {width / 2}, {height / 2}]\n"
            "distortion_model: radial-tangential\n"
            "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n")

    def to_ns(t):
        return int(round(t * 1e9))

    for ci, i2c in enumerate(i2cs):
        cdir = os.path.join(out_dir, f"cam{ci}")
        os.makedirs(os.path.join(cdir, "data"), exist_ok=True)
        with open(os.path.join(cdir, "sensor.yaml"), "w") as f:
            f.write(yaml_for(i2c))
        with open(os.path.join(cdir, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for k in seq.frame_sample_idx:
                ns = to_ns(seq.times[k])
                img = render_view(
                    seq.landmarks, seq.pos[k], seq.quat[k], i2c,
                    fx, fx, width / 2, height / 2, width, height,
                    blob_sigma=1.2)
                write_png_gray(os.path.join(cdir, "data", f"{ns}.png"),
                               np.clip(img * 255, 0, 255).astype(np.uint8))
                f.write(f"{ns},{ns}.png\n")

    idir = os.path.join(out_dir, "imu0")
    os.makedirs(idir, exist_ok=True)
    with open(os.path.join(idir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for k in range(len(seq.times)):
            g, a = seq.gyro[k], seq.acc[k]
            f.write(f"{to_ns(seq.times[k])},{g[0]},{g[1]},{g[2]},"
                    f"{a[0]},{a[1]},{a[2]}\n")

    gdir = os.path.join(out_dir, "state_groundtruth_estimate0")
    os.makedirs(gdir, exist_ok=True)
    with open(os.path.join(gdir, "data.csv"), "w") as f:
        f.write("#timestamp,p,q,v,bw,ba\n")
        for k in seq.frame_sample_idx:
            p, q = seq.pos[k], seq.quat[k]
            f.write(f"{to_ns(seq.times[k])},{p[0]},{p[1]},{p[2]},"
                    f"{q[0]},{q[1]},{q[2]},{q[3]}\n")
    return out_dir, len(seq.frame_sample_idx)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = argv[0] if len(argv) > 0 else "/tmp/synth_dataset"
    dur = float(argv[1]) if len(argv) > 1 else 6.0
    world = argv[2] if len(argv) > 2 else "textured"
    d, n = make_dataset(out, dur, world=world)
    print(f"wrote {n} frames to {d} ({world})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
