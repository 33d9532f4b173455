"""Offline CLI runner (port of the reference package's ``cli/main.py``, the
reference `main` binary equivalent), on the card unless asked for the CPU.

Usage:
    python -m hybvio_tpu_torch.cli.main -i=<dataset_dir> [-o=<output.jsonl>]
        [-parametersPath=<parameters.txt>] [-calibrationPath=<calibration.json>]
        [any -paramName=value]   (-help lists the full flag surface)
    HYBVIO_PLATFORM=cpu python -m hybvio_tpu_torch.cli.main ...   (on the CPU)

Flag surface = the reference `main` binary's cmd parameters
(config/cmd_params_generated); short aliases follow the reference (-c =
displayVideo, -p = displayPose).

Dataset directory layout (reference: src/commandline/main.cpp:259-397):
    data.jsonl                 sensor + frame metadata (+ embedded calibration)
    parameters.txt / vio_config.yaml   optional parameters
    calibration.json           optional calibration
    data.{mp4,mov,avi} (io/video.py VideoFileSource, cv2), frame_*.npy or an
    image directory for frames
or a EuRoC ASL tree (mav0/ or its parent: cam0/, cam1/, imu0/, sensor.yaml
calibration, ground truth as echoes; io/euroc.py), or a folder with the
legacy data.csv (io/jsonl.py read_csv_events) and its frames, or
-i=<video.mp4|.mov> with the legacy CSV beside it (<video>.csv).

Configuration precedence mirrors the reference (main.cpp:298-327):
    data.jsonl-embedded -> parameters.txt/vio_config.yaml -> calibration.json
    -> command line (last, highest).

SLAM: -useSlam runs the SLAM session beside the VIO (on the same device);
-slamMapPosesPath=<file> saves its keyframe map at the end; with -timer the
SLAM worker's per-keyframe stage table follows the VIO's.

A JSONL input whose frames' cameraParameters change mid-sequence (a
zooming or autofocus lens) runs through VioApi.add_frame_mono_varying from
the first frame whose lens differs from the session camera (mono);
-useSquareRootEkf runs the square-root filter (ekf/sqrt.py).

The JSONL reader and the sample synchronizer are the native (C++) ones
where the library builds (io/native_jsonl.py, io/native_sync.py), as in
the reference; the reader's echo lines go to VioApi.add_echo.

Display flags (-displayVideo / -c, -displayPose / -p, -displayTracks,
-displayCornerMeasure, -displayStereoDisparity, ...; api/visualizations.py)
are headless: with -visualizationPath=<dir> each active view is written
there every -visuUpdateInterval-th output as <view>_<output index>.png (or
.npy where cv2 is missing); with -useSlam the SLAM viewers
(-displayKeyframe, -visualizeOrbs, -visualizeOrbPyramid,
-visualizeOrbMatching, -visualizeLoopOrbMatching,
-visualizeMapPointSearch) write one raster per new keyframe, match or loop.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np

PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def find_frame_source_path(dataset_dir: str) -> Optional[str]:
    for ext in (".mp4", ".mov", ".avi"):
        p = os.path.join(dataset_dir, "data" + ext)
        if os.path.exists(p):
            return p
    if os.path.exists(os.path.join(dataset_dir, "frame_000000_cam0.npy")):
        return dataset_dir
    for sub in ("frames", "cam0/data", "mav0/cam0/data"):
        p = os.path.join(dataset_dir, sub)
        if os.path.isdir(p):
            return p
    return None


def _write_slam_visualizations(slam, slam_viz_on, save_vis, last_kf_seen):
    """Raster the SLAM debug viewers for the newest keyframe (reference:
    cmd slam group -displayKeyframe/-visualizeOrb*/-visualizeMapPointSearch,
    Pangolin windows there). The SLAM worker thread appends keyframes; reads
    here are tolerant of concurrent growth, and a failure is reported, not
    raised (a viewer must not end the run)."""
    from ..api import visualizations as vz

    try:
        if not slam.kf_order:
            return
        # each view advances independently: the SLAM worker appends the
        # keyframe first and computes matches a little later, so gating all
        # views on "new keyframe" would always render the match views one
        # step stale/empty
        kf_id = slam.kf_order[-1]
        kf = slam.keyframes.get(kf_id)
        if kf is not None and kf.thumb is not None and kf_id != last_kf_seen.get("kf"):
            last_kf_seen["kf"] = kf_id
            tag = f"{kf_id:05d}"
            if "displayKeyframe" in slam_viz_on or "visualizeOrbs" in slam_viz_on:
                save_vis(f"keyframe_{tag}", vz.render_orb_keypoints(
                    kf.thumb, kf.pix_pts, kf.desc_valid))
            if "visualizeOrbPyramid" in slam_viz_on:
                save_vis(f"orb_pyramid_{tag}", vz.render_orb_pyramid(kf.thumb))
            if "visualizeMapPointSearch" in slam_viz_on:
                proj, obs = slam.map_points_in_keyframe(kf_id)
                save_vis(f"map_search_{tag}", vz.render_map_point_search(kf.thumb, proj, obs))
        lam = slam.last_adjacent_matches
        if ("visualizeOrbMatching" in slam_viz_on and lam is not None
                and lam[0] != last_kf_seen.get("match")):
            ka, kb, pairs = lam
            a, b = slam.keyframes.get(ka), slam.keyframes.get(kb)
            if a is not None and b is not None and a.thumb is not None and b.thumb is not None:
                last_kf_seen["match"] = ka
                save_vis(f"orb_match_{ka:05d}", vz.render_orb_matches(
                    a.thumb, a.pix_pts, b.thumb, b.pix_pts, pairs))
        if "visualizeLoopOrbMatching" in slam_viz_on and slam.loop_events:
            ev = slam.loop_events[-1]
            if ev.matches and ev.kf_id != last_kf_seen.get("loop"):
                a = slam.keyframes.get(ev.kf_id)
                b = slam.keyframes.get(ev.matched_kf_id)
                if a is not None and b is not None and a.thumb is not None \
                        and b.thumb is not None:
                    last_kf_seen["loop"] = ev.kf_id
                    save_vis(f"loop_match_{ev.kf_id:05d}", vz.render_orb_matches(
                        a.thumb, a.pix_pts, b.thumb, b.pix_pts, ev.matches,
                        color=(1.0, 0.4, 0.1)))
    except Exception:
        import traceback

        print("slam visualization failed:", file=sys.stderr)
        traceback.print_exc()


def save_visualization(vis_dir: str, name: str, frame) -> str:
    """Write a raster under ``vis_dir``: a PNG where cv2 imports (float RGB
    in [0, 1] to 8-bit BGR), else the raw array as .npy, as the reference's
    CLI does. Returns the path written."""
    a = np.asarray(frame)
    path = os.path.join(vis_dir, name)
    try:
        import cv2
    except ImportError:
        np.save(path + ".npy", a)
        return path + ".npy"
    img8 = a
    if img8.dtype != np.uint8:
        img8 = (np.clip(img8, 0.0, 1.0) * 255).astype(np.uint8)
    if img8.ndim == 3 and img8.shape[-1] == 3:
        img8 = img8[..., ::-1]  # RGB -> BGR
    if not cv2.imwrite(path + ".png", img8):
        np.save(path + ".npy", a)
        return path + ".npy"
    return path + ".png"


def _platform_device(device):
    """The device to run on: ``device`` if given, else HYBVIO_PLATFORM
    (cpu | cuda | gpu), else the card."""
    if device is not None:
        return device
    platform = os.environ.get("HYBVIO_PLATFORM")
    if not platform:
        return None
    if platform.lower() not in PLATFORMS:
        raise ValueError(f"HYBVIO_PLATFORM={platform}: the port runs on "
                         f"{' or '.join(sorted(PLATFORMS))}")
    return PLATFORMS[platform.lower()]


def run(argv=None, device=None) -> int:
    """The offline runner; ``device`` ("cpu" or "cuda") takes precedence over
    HYBVIO_PLATFORM (same name and meaning as the reference's), and the card
    is the default."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _platform_device(device)

    from ..config import Parameters
    from ..config.loader import apply_argv, apply_calibration_json, apply_parameters_text, apply_yaml
    from ..io import jsonl as jio
    from ..io.video import open_frame_source

    # the full reference CLI surface (groups main/viewer/slam); keys are
    # flat (long name or short alias) and normalize to long names here.
    # NOTE reference short semantics: -c = displayVideo, -p = displayPose
    # (NOT calibration/parameters paths).
    from ..config.cmd_params_generated import (CMD_PARAMS, SHORT_TO_NAME,
                                               flat_keys, help_text)

    _SHORTS = {short: name for short, (_g, name) in SHORT_TO_NAME.items()}
    _LONG_KEYS = flat_keys() | {"visualizationPath", "interactive"}
    # display flags map to raster renderers (api/visualizations.py); frames
    # are written under -visualizationPath (headless: no GUI windows).
    # viewer-group params (the 3D viewer's settings in the reference) are
    # accepted for command-line compatibility; there is no GUI to apply
    # most of them to
    _DISPLAY_KEYS = {n for n in CMD_PARAMS["main"]
                     if n.startswith("display")} | {"visualUpdateViewer"}
    main_flags = {}
    rest = []
    for a in argv:
        body = a.lstrip("-")
        k, _, v = body.partition("=")
        k = _SHORTS.get(k, k)
        if k in ("help", "h"):
            print(__doc__)
            print(help_text())
            return 0
        if k in _LONG_KEYS:
            main_flags[k] = v if v else "true"
        else:
            rest.append(a)
    if "inputPath" not in main_flags:
        print(__doc__)
        return 2

    from ..utils.logging import setup_logging

    setup_logging(int(main_flags.get("logLevel", "0") if main_flags.get("logLevel", "0") != "true" else 1))

    dataset = main_flags["inputPath"]
    # legacy CSV input: -i=<video.mp4|.mov> with a sibling .csv (reference:
    # input_csv.cpp:66-77), or a folder containing data.csv (below)
    data_csv = video_path = None
    if dataset.endswith((".mp4", ".mov")) and os.path.exists(
            os.path.splitext(dataset)[0] + ".csv"):
        data_csv = os.path.splitext(dataset)[0] + ".csv"
        video_path = dataset
        dataset = os.path.dirname(dataset) or "."
    data_jsonl = os.path.join(dataset, "data.jsonl")
    params = Parameters()

    # EuRoC ASL layout (mav0/...) read directly; else a folder with data.csv
    euroc_dir = None
    if data_csv is None and not os.path.exists(data_jsonl):
        for cand in (dataset, os.path.join(dataset, "mav0")):
            if os.path.isdir(os.path.join(cand, "cam0")):
                euroc_dir = cand
                break
        if euroc_dir is None and os.path.exists(os.path.join(dataset, "data.csv")):
            data_csv = os.path.join(dataset, "data.csv")
        if euroc_dir is None and data_csv is None:
            print(f"error: no data.jsonl in {dataset}", file=sys.stderr)
            return 1

    # precedence: data.jsonl-embedded -> parameters/yaml -> calibration -> argv
    if euroc_dir:
        from ..io.euroc import read_euroc_calibration

        cams = read_euroc_calibration(euroc_dir)
        if cams:
            apply_calibration_json(params, json.dumps({"cameras": cams}))
    elif data_csv is None:
        jio.set_parameters_from_data(params, data_jsonl)
    ppath = main_flags.get("parametersPath")
    if not ppath:
        for cand in ("vio_config.yaml", "parameters.txt"):
            c = os.path.join(dataset, cand)
            if os.path.exists(c):
                ppath = c
                break
    if ppath and os.path.exists(ppath):
        text = open(ppath).read()
        if ppath.endswith((".yaml", ".yml")):
            apply_yaml(params, text)
        else:
            apply_parameters_text(params, text)
    cpath = main_flags.get("calibrationPath") or os.path.join(dataset, "calibration.json")
    if os.path.exists(cpath):
        apply_calibration_json(params, open(cpath).read())
    unparsed = apply_argv(params, rest)
    if unparsed:
        # unused-key error parity (reference: ParameterParser unused-key
        # checking, src/util/parameter_parser.hpp:14-28)
        print(f"error: unrecognized arguments: {unparsed}", file=sys.stderr)
        return 2

    if euroc_dir:
        import glob

        from ..io.video import load_image_file

        frames = None  # loaded per frame event from its image paths
        first = sorted(glob.glob(os.path.join(euroc_dir, "cam0", "data", "*")))
        if not first:
            print(f"error: no cam0 images in {euroc_dir}", file=sys.stderr)
            return 1
        H, W = load_image_file(first[0]).shape
    else:
        src_path = video_path or find_frame_source_path(dataset)
        if src_path is None:
            print(f"error: no frame source found in {dataset}", file=sys.stderr)
            return 1
        frames = open_frame_source(
            src_path,
            reader_threads=bool(params.tracker.videoReaderThreads),
            convert_to_gray=bool(params.tracker.convertVideoToGray))
        H, W = frames.shape

    def input_events():
        if euroc_dir:
            from ..io.euroc import read_euroc_events

            return read_euroc_events(euroc_dir)
        if data_csv:
            return jio.read_csv_events(data_csv)
        return jio.read_jsonl_events(data_jsonl)

    # per-frame intrinsics embedded in the input (reference: the first
    # frame's cameraParameters configure the camera, api.cpp:528-628 via
    # input_jsonl.cpp:119-199 / input_csv.cpp:169-177) — applied only when
    # not set by other sources
    if not euroc_dir and params.tracker.focalLength < 0 and params.tracker.focalLengthX < 0:
        for ev in input_events():
            if ev.kind == jio.FRAME and ev.frames:
                fr = ev.frames[0]
                if fr.focal_length_x > 0:
                    params.tracker.focalLengthX = fr.focal_length_x
                    params.tracker.focalLengthY = (
                        fr.focal_length_y if fr.focal_length_y > 0
                        else fr.focal_length_x)
                    if fr.principal_point_x >= 0:
                        params.tracker.principalPointX = fr.principal_point_x
                        params.tracker.principalPointY = fr.principal_point_y
                break

    # videoRotation: rotate incoming frames (the imuToCamera adjustment was
    # applied during parameter parsing; reference: parameters_base.cpp:38-66)
    rot_steps = getattr(params, "videoRotationSteps", 0) % 4

    def maybe_rotate(img):
        return np.rot90(img, k=-rot_steps) if rot_steps else img

    if rot_steps % 2 == 1:
        W, H = H, W

    # targetFrameWidth: scale the longer side down to the target (the
    # -Upsample variant also allows scaling up) and scale intrinsics with it
    # (reference: main.cpp:334-394 resolution probe + scaling)
    tfw = int(main_flags.get("targetFrameWidth", "0") or 0)
    tfw_up = int(main_flags.get("targetFrameWidthUpsample", "0") or 0)
    target = tfw_up if tfw_up > 0 else tfw
    frame_scale = 1.0
    if target > 0:
        frame_scale = target / float(max(W, H))
        if tfw_up <= 0:
            frame_scale = min(frame_scale, 1.0)
    intr_scale = (1.0, 1.0)  # per-frame intrinsics follow the frame scaling
    if frame_scale != 1.0:
        from ..frontend.image_utils import resize_bilinear_np

        newW, newH = round(W * frame_scale), round(H * frame_scale)
        sx, sy = newW / W, newH / H
        intr_scale = (sx, sy)
        for name, s in (("focalLength", sx), ("focalLengthX", sx),
                        ("focalLengthY", sy), ("principalPointX", sx),
                        ("principalPointY", sy),
                        ("secondFocalLengthX", sx), ("secondFocalLengthY", sy),
                        ("secondPrincipalPointX", sx),
                        ("secondPrincipalPointY", sy)):
            v = getattr(params.tracker, name, -1.0)
            if v is not None and v > 0:
                setattr(params.tracker, name, v * s)
        W, H = newW, newH
        _rot0 = maybe_rotate

        def maybe_rotate(img):  # noqa: F811
            # rotate first: newH/newW are post-rotation dimensions
            return resize_bilinear_np(_rot0(img), newH, newW)

    from ..api.vio import VioApi

    max_frames = int(main_flags.get("maxFrames", "0") or 0)
    out_file = open(main_flags["outputPath"], "w") if main_flags.get("outputPath") else None
    with_trail = main_flags.get("outputType") == "tail" or params.odometry.outputJsonPoseTrail

    api = VioApi(params, W, H, device=device)
    if main_flags.get("timer"):
        api.time_stats.enabled = True
        # SLAM worker per-keyframe stage timers (reference: slam::TIME_STATS
        # singleton, util/timer.cpp:8-11)
        from ..utils.timer import SLAM_TIME_STATS

        SLAM_TIME_STATS.enabled = True
    n_out = [0]
    t_start = time.time()

    # session recording (reference: -recordingPath / -videoRecordingPath via
    # jsonl-recorder, api.cpp:97-101,631-710)
    recorder = None
    if main_flags.get("recordingPath") or main_flags.get("videoRecordingPath"):
        from ..io.jsonl import Recorder

        rpath = main_flags.get("recordingPath") or main_flags.get("videoRecordingPath")
        recorder = Recorder(rpath, save_frames=bool(main_flags.get("videoRecordingPath")))
        if main_flags.get("videoRecordingPath") and main_flags.get("recordingPath") is None:
            recorder.dir = main_flags["videoRecordingPath"] if not main_flags["videoRecordingPath"].endswith(
                ".jsonl") else os.path.dirname(main_flags["videoRecordingPath"]) or "."

    # point cloud CSV (reference: writePointCloudToCsv, main.cpp:399-408)
    pc_file = open(main_flags["pointCloudOutputPath"], "w") if main_flags.get("pointCloudOutputPath") else None

    # headless display flags -> raster dumps under -visualizationPath
    vis_dir = main_flags.get("visualizationPath")
    vis_every = max(1, int(main_flags.get("visuUpdateInterval", "1") or 1))
    display_on = {k for k in _DISPLAY_KEYS
                  if main_flags.get(k) not in (None, "false", "NONE")}
    # SLAM debug viewers (reference: cmd slam group Pangolin windows),
    # rendered as rasters per new keyframe when -useSlam is active
    slam_viz_on = {k for k in ("displayKeyframe", "visualizeOrbMatching",
                               "visualizeLoopOrbMatching", "visualizeOrbPyramid",
                               "visualizeOrbs", "visualizeMapPointSearch")
                   if main_flags.get(k) not in (None, "false")}
    # bridge display flags into the tracker visualization-collection params
    # (reference: main.cpp:453,468 saveOpticalFlow/saveStereoEpipolar are set
    # FROM displayOpticalFlow/displayStereoEpipolarCurves)
    flow_opt = (main_flags.get("displayOpticalFlow") or "NONE").upper()
    if flow_opt == "TRUE":
        flow_opt = "COMPARE"  # bare -flow: the reference's richest overlay
    if flow_opt not in ("NONE", "FALSE"):
        params.tracker.saveOpticalFlow = flow_opt
    epi_opt = (main_flags.get("displayStereoEpipolarCurves") or "NONE").upper()
    if epi_opt == "TRUE":
        epi_opt = "TRACKED"
    if epi_opt not in ("NONE", "FALSE"):
        params.tracker.saveStereoEpipolar = epi_opt
    if slam_viz_on:
        display_on = display_on | {"__slam__"}
        if api.slam is not None:
            # keep half-res keyframe images + ORB pixel positions for viewers
            api.slam.slam.store_keyframe_images = True
    if display_on and vis_dir:
        os.makedirs(vis_dir, exist_ok=True)
    elif display_on:
        print("note: display flags are headless here; pass "
              "-visualizationPath=<dir> to write visualization frames", file=sys.stderr)
    last_img = [None]
    pc_history: list = []
    last_kf_seen = {}
    est_positions = []
    prev_gray = [None]
    varying_intrinsics = [False]  # latches once a frame's lens differs

    def save_vis(name, frame):
        save_visualization(vis_dir, name, frame)

    def covariance():
        """The filter's covariance of lane 0 on the host (W W^T where the P
        field holds the square-root factor, ekf/sqrt.py)."""
        P = api._state.backend.ekf.P[0].cpu().numpy()
        return P @ P.T if api._sqrt_mode else P

    def write_visualizations(out):
        if not (display_on and vis_dir) or (n_out[0] - 1) % vis_every:
            return
        from ..api import visualizations as vz

        k = n_out[0] - 1
        fo = api.last_frame_output
        # video flag -> VisualizationMode (reference: main.cpp maps the
        # display cmd params onto InternalAPI::setVisualization modes,
        # internal.hpp:66-81); one raster per active flag
        M = vz.VisualizationMode
        video_modes = []
        if "displayVideo" in display_on:
            video_modes.append(("video", M.PLAIN_VIDEO if fo is None else M.DEBUG_VISUALIZATION))
        if "displayPlainVideo" in display_on:
            # distinct name: both flags can be active at once, each gets its
            # own raster stream (reference: separate windows)
            video_modes.append(("plain", M.PLAIN_VIDEO))
        if "displayTracks" in display_on and fo is not None:
            video_modes.append(("tracks", M.TRACKS))
        if "displayTracksAll" in display_on and fo is not None:
            video_modes.append(("tracks_all", M.TRACKS_ALL))
        flow = str(params.tracker.saveOpticalFlow or "NONE").upper()
        if flow not in ("NONE", "FALSE") and fo is not None:
            video_modes.append(("flow", M.OPTICAL_FLOW_FAILURES if flow == "FAILURES"
                                else M.OPTICAL_FLOW))
        if "displayCornerMeasure" in display_on:
            video_modes.append(("corner", M.CORNER_MEASURE))
        if "displayStereoMatching" in display_on and fo is not None:
            video_modes.append(("stereo_match", M.STEREO_MATCHING))
        epi = str(params.tracker.saveStereoEpipolar or "NONE").upper()
        if epi not in ("NONE", "FALSE") and fo is not None:
            video_modes.append(("epipolar", M.STEREO_EPIPOLAR))
        if "displayStereoDisparity" in display_on:
            video_modes.append(("disparity", M.STEREO_DISPARITY))
        if "displayStereoDepth" in display_on:
            video_modes.append(("depth", M.STEREO_DEPTH))
        seen = set()
        for name, mode in video_modes:
            if name in seen or last_img[0] is None:
                continue
            seen.add(name)
            try:
                frame = api.render_visualization(mode)
            except Exception:  # a view must not end the run
                import traceback

                print(f"visualization {name} failed:", file=sys.stderr)
                traceback.print_exc()
                continue
            if frame is not None:
                save_vis(f"{name}_{k:06d}", frame)
        if "displayPose" in display_on:
            est_positions.append([out.position[0], out.position[1], out.position[2]])
            hist = {"output": np.asarray(est_positions, np.float64)}
            for name, rows in api.pose_histories.items():
                if rows:
                    hist[name] = np.asarray(rows, np.float64)[:, 1:4]
            pc_hist = None
            if "displayPointCloud" in display_on:
                # point-cloud history scatter (reference: -showPc, requires
                # -p; draws into the pose window)
                if len(out.point_cloud):
                    pc_history.extend(out.point_cloud[:, 1:4].tolist())
                    del pc_history[:-20000]  # bound memory
                if pc_history:
                    pc_hist = np.asarray(pc_history)
            save_vis(f"pose_{k:06d}", vz.render_pose_plot(hist, point_cloud=pc_hist))
        if "displayCovarianceMagnitude" in display_on and api._state is not None:
            save_vis(f"cov_{k:06d}", vz.render_covariance_magnitudes(covariance()))
        if "displayCorrelation" in display_on and api._state is not None:
            save_vis(f"corr_{k:06d}", vz.render_correlation(covariance()))
        if slam_viz_on and api.slam is not None:
            _write_slam_visualizations(api.slam.slam, slam_viz_on, save_vis, last_kf_seen)

    def as_f32_tensor(a):
        # normalized [0,1] view for host-side preprocessing (uint8 frame
        # sources are raw 0-255; see io/video.py load_image_file)
        import torch

        arr = torch.as_tensor(np.ascontiguousarray(a))
        if not arr.is_floating_point():
            return arr.to(torch.float32) / 255.0
        return arr.to(torch.float32)

    def on_output(out):
        n_out[0] += 1
        if out_file:
            extras = None
            if params.odometry.outputJsonExtras:
                # reference extras shape (api.cpp:817-860); BAT here is the
                # 3-dim diagonal accelerometer-transform part of our state
                bcd = out.bias_covariance_diagonal
                extras = {
                    "status": out.status,
                    "positionCovariance": [
                        list(map(float, r)) for r in out.position_covariance],
                    "velocityCovariance": [
                        list(map(float, r)) for r in out.velocity_covariance],
                    "focalLength": float(
                        params.tracker.focalLength
                        if params.tracker.focalLength > 0
                        else params.tracker.focalLengthX),
                    "biasMean": {
                        "gyroscopeAdditive": list(map(float, out.bias_gyro)),
                        "accelerometerAdditive": list(map(float, out.bias_acc)),
                    },
                    "biasCovarianceDiagonal": {
                        "gyroscopeAdditive": list(map(float, bcd[0:3])),
                        "accelerometerAdditive": list(map(float, bcd[3:6])),
                        "accelerometerTransform": list(map(float, bcd[6:9])),
                    },
                    "stationaryVisual": out.stationary_visual,
                }
            out_file.write(out.as_json(with_trail, extras) + "\n")
        if pc_file is not None and len(out.point_cloud):
            for row in out.point_cloud:
                pc_file.write(
                    f"{out.t},{int(row[0])},{row[1]},{row[2]},{row[3]}\n")
        write_visualizations(out)

    api.on_output = on_output

    # interactive command queue (reference: commandline/command_queue.cpp +
    # main.cpp key handling; headless here: keys read from stdin). -stepMode
    # pauses before every frame until a key/newline arrives.
    cq = None
    if main_flags.get("stepMode") or main_flags.get("interactive"):
        import threading

        from .command_queue import CommandQueue

        cq = CommandQueue()
        cq.step_mode = bool(main_flags.get("stepMode"))

        def read_keys():
            while True:
                line = sys.stdin.readline()
                if not line:  # EOF: leave step mode so the run can finish
                    cq.step_mode = False
                    cq._step_event.set()
                    return
                cq.push_key(line.strip()[:1] if line.strip() else " ")

        threading.Thread(target=read_keys, daemon=True).start()

    def handle_commands() -> bool:
        """Dispatch queued commands; returns False on QUIT."""
        from .command_queue import Command

        while True:
            cmd = cq.poll()
            if cmd == Command.NONE:
                return True
            if cmd == Command.QUIT:
                return False
            if cmd == Command.POSE and api.last_frame_output is not None:
                o = api.last_frame_output
                print(f"pose: p={np.asarray(o.position)} "
                      f"q={np.asarray(o.orientation)}", file=sys.stderr)
            elif cmd == Command.LOCK_BIASES:
                api.lock_biases()
                print("biases locked", file=sys.stderr)
            elif cmd == Command.CONDITION_ON_LAST_POSE:
                api.condition_on_last_pose()
                print("conditioned on last pose", file=sys.stderr)

    events = input_events()
    from ..utils.logging import log_info

    log_info("input: %s through the %s reader, samples through %s",
             euroc_dir or data_csv or data_jsonl, getattr(events, "reader", "python"),
             type(api.sample_sync).__name__)
    n_frames = 0
    for ev in events:
        if cq is not None:
            if ev.kind == jio.FRAME:
                cq.wait_for_step(timeout=300.0)
            if not handle_commands():
                break
        if ev.kind == jio.GYROSCOPE:
            if recorder is not None:
                recorder.gyro(ev.t, ev.values)
            api.add_gyro(ev.t, ev.values)
        elif ev.kind == jio.ACCELEROMETER:
            if recorder is not None:
                recorder.acc(ev.t, ev.values)
            api.add_acc(ev.t, ev.values)
        elif ev.kind == jio.ECHO:
            if ev.raw:
                if recorder is not None:
                    recorder.f.write(json.dumps(ev.raw) + "\n")
                api.add_echo(ev.raw)
        elif ev.kind == jio.FRAME:
            if euroc_dir:
                paths = ev.raw["paths"]
                img = load_image_file(paths[0])
                img2 = (load_image_file(paths[1])
                        if len(paths) > 1 and params.tracker.useStereo else None)
            else:
                num = ev.frames_index if ev.frames_index >= 0 else n_frames
                # camera index selection (reference: main.cpp:251-253
                # tracker.leftCameraId/rightCameraId)
                cam_l = int(params.tracker.leftCameraId)
                cam_r = int(params.tracker.rightCameraId)
                img = frames.frame(num, cam_l)
                img2 = (frames.frame(num, cam_r)
                        if len(ev.frames) > 1 and params.tracker.useStereo else None)
            img = maybe_rotate(img)
            img2 = maybe_rotate(img2) if img2 is not None else None
            # intensity equalization preprocessing (reference:
            # main.cpp:763-777 matchIntensities on successive frames and on
            # the stereo pair)
            if params.tracker.matchSuccessiveIntensities > 0.0 and prev_gray[0] is not None:
                from ..frontend.image_utils import match_intensities

                img = match_intensities(
                    as_f32_tensor(prev_gray[0]), as_f32_tensor(img),
                    params.tracker.matchSuccessiveIntensities).numpy()
            if img2 is not None and params.tracker.matchStereoIntensities:
                from ..frontend.image_utils import match_intensities

                img2 = match_intensities(as_f32_tensor(img), as_f32_tensor(img2)).numpy()
            prev_gray[0] = img
            last_img[0] = img
            if recorder is not None:
                recorder.frame(
                    ev.t, [img] if img2 is None else [img, img2])
            if img2 is not None:
                api.add_frame_stereo(ev.t, img, img2)
            else:
                # per-frame VARYING intrinsics (reference: the JSONL reader
                # updates the camera from every frame's cameraParameters,
                # input_jsonl.cpp:119-199 -> addFrameMonoVarying,
                # internal.hpp:216-230), from the first frame whose lens
                # differs from the session camera (mobile autofocus);
                # fixed-lens inputs keep the plain path
                fr0 = ev.frames[0] if ev.frames else None
                if fr0 is not None and fr0.focal_length_x > 0:
                    fx = fr0.focal_length_x * intr_scale[0]
                    fy = (fr0.focal_length_y if fr0.focal_length_y > 0
                          else fr0.focal_length_x) * intr_scale[1]
                    cx = (fr0.principal_point_x * intr_scale[0]
                          if fr0.principal_point_x >= 0 else -1.0)
                    cy = (fr0.principal_point_y * intr_scale[1]
                          if fr0.principal_point_y >= 0 else -1.0)
                    base = api.cameras[0]
                    if not varying_intrinsics[0]:
                        varying_intrinsics[0] = (
                            abs(fx - base.fx) > 1e-6 * fx
                            or abs(fy - base.fy) > 1e-6 * fy
                            or (cx >= 0 and abs(cx - base.cx) > 1e-6 * max(cx, 1.0)))
                    if varying_intrinsics[0]:
                        api.add_frame_mono_varying(ev.t, img, (fx, fy, cx, cy))
                    else:
                        api.add_frame_mono(ev.t, img)
                else:
                    api.add_frame_mono(ev.t, img)
            n_frames += 1
            if max_frames and n_frames >= max_frames:
                break

    api.finish(slam_map_poses_path=main_flags.get("slamMapPosesPath"))
    if slam_viz_on and vis_dir and api.slam is not None:
        # final flush: capture matches/loops the worker computed after the
        # last output's render pass
        _write_slam_visualizations(api.slam.slam, slam_viz_on, save_vis, last_kf_seen)
    elapsed = time.time() - t_start
    if out_file:
        out_file.close()
    if pc_file is not None:
        pc_file.close()
    if recorder is not None:
        recorder.close()
    print(f"processed {n_frames} frames, {n_out[0]} outputs in {elapsed:.1f}s "
          f"({n_frames / max(elapsed, 1e-9):.1f} fps)", file=sys.stderr)
    if main_flags.get("timer"):
        # the per-label table (main.cpp:1008-1016); the sub-stage labels
        # (pyramids / LK / stereo match / detection / RANSAC variants) come
        # from StageProbes, one sample a frame
        print(api.time_stats.report(), file=sys.stderr)
        from ..utils.timer import SLAM_TIME_STATS

        if SLAM_TIME_STATS.frames:
            print("--- SLAM worker (per keyframe) ---", file=sys.stderr)
            print(SLAM_TIME_STATS.report(), file=sys.stderr)
    if api.output_buffer is not None:
        # buffered-output statistics (reference: OutputBuffer FPS / latency
        # +/- / skips per second report, output_buffer.hpp:33-46)
        ob = api.output_buffer
        print(f"output buffer: {ob.fps:.1f} fps, mean latency "
              f"{1000 * ob.mean_latency:.1f} ms, {ob.skips_total} skips",
              file=sys.stderr)
    if api.vu_stats.enabled:
        # totals at exit (reference: printVisualUpdateStats final report)
        print(api.vu_stats.report(), file=sys.stderr)
    # on_output closes over the API: without it the API and its step graphs
    # are freed when run returns, not at a later collection, so the next
    # run (the next sequence of a benchmark) captures into their memory
    api.on_output = None
    return 0


if __name__ == "__main__":
    sys.exit(run())
