#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hybvio_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions; every
     later line starts with the card's name and power limit;
  2. build every CUDA kernel from csrc/ with nvcc (sm_90a), and beside it
     the native image decoder (native/image_decode.cpp, g++; PNG where the
     host has zlib, else PGM only) and the native host library
     (native/sample_sync.cpp, jsonl_reader.cpp, orb_detect.cpp, g++;
     utils/native.py); fails if either does not build;
  3. the card's launch floor (an empty kernel, timed like the rows below);
     each kernel against its plain PyTorch version on the card at every
     input shape the five paths of phase 4 give it (exact for gather /
     greedy / pyramid / fused pyramid and gradients / corner response,
     <= 1e-6 max abs for the standalone Scharr), plus edge cases of the
     gather, the greedy walk, the corner response and the pyramid with and
     without the gradients; each kernel's device time (CUDA events around
     100 back-to-back calls, median of 5 runs) beside its bound (bytes over
     3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is larger),
     its plain version's time and, where one PyTorch call computes the same
     function, that call's time. The gather at every window shape and
     pyramid level (image size) the paths launch; the fused pyramid +
     gradients of a stereo pair (levels 1-2 of both frames and the Scharr
     gradients of levels 0-2 of the left one) beside the pyramid launch and
     the three Scharr launches it replaced, and of one 480x752 or 512x512
     frame; the pyramid alone beside its single-image single-level launches
     and one launch per level; the standalone Scharr at each of the three
     level sizes; the corner response at 480x752 and 512x512; and at the
     per-lane shapes: the fused pyramid of 16 lanes x 2 cameras, the corner
     response of 16 lanes, the gather of per-lane images at every window
     shape and level, greedy with a per-lane d2; and at the host entry
     point's shapes (phase 7, one lane, the reference's defaults): the fused
     pyramid of 3 levels of one frame and of a stereo pair, the gather of
     200 windows at every window shape and level (API_GATHER_ROWS), greedy
     at K = 400; and at the vislam preset's (phase 8b, the stereo preset at
     one lane): the gather of 96 windows at every row of GATHER_ROWS,
     greedy at K = 192; and the FAST detector's greedy walk (phase 9a) at
     K = 256, one lane and 16 lanes with a per-lane d2; and at the textured
     world's new shapes (TEXTURED_SHAPES, one lane): the short probe's
     240x320 frame (maxTracks 64: the gathers at every GATHER_ROWS row, the
     fused pyramid of one and two cameras, the corner response, greedy at
     K = 128) and the long fisheye's 512x512 gathers of 96 windows;
  4. five paths through make_batched_vio (its compiled step: a CUDA graph
     captured at step 1, after the eager warm-up, and replayed from step
     2), each B=16 lanes, a float32
     filter (float64 with the map, see FILTER_DTYPE), over 60 synthetic
     frames (io.synthetic, the benchmark's worlds; mono, fisheye and
     stereo_sequential_hybrid over 40): the stereo preset at 752x480, the mono preset at
     752x480 and the fisheye (KB4) preset at 512x512, each lane sharing
     each frame (shared_frames=True); the stereo preset over 16 distinct
     worlds, one per lane (shared_frames=False; bench.py's seed-diverse
     worlds, rendered on the card each step by io.synthetic_device outside
     the timed step), with the batched visual update (stereo_per_lane) and
     with the reference's default sequential update and a hybrid map of 16
     points (stereo_sequential_hybrid). For each: median step time,
     aggregate frames/s, warm-up step, finite lanes, ATE median and p90
     against each lane's ground truth, every kernel's launch count in that
     run, in total and by input shape, and the host syncs of one step
     (torch.cuda.set_sync_debug_mode); with the map, the slots claimed and
     the map-point (PF_HYBRID) updates. Fails on a host sync, a Pallas
     kernel none of whose port kernels was launched, a path that did not
     launch one of the four kernels every path runs, a non-finite lane, an
     ATE median over 0.05 m, or a map that claimed no slot or updated no
     map point;
  5. (after phase 8) the kernels ranked, per path and over all of them, by
     the time the paths lose in them: the sum over input shapes of launches
     x (device time - bound); fails on a shape launched on a path and not
     timed in phase 3;
  6. the estimator options, each on top of stereo_sequential_hybrid, 3
     steps of the per-lane stereo input at B=16: RANDOM and ALL track
     sampling, linear triangulation, the visual update every 2nd frame, the
     visual update disabled, the batched update with the map, shared
     frames; and 20 steps of a float32 filter. Each reports its ATE; fails
     on a non-finite lane or a host sync in a step;
  7. the host entry point: for mono and stereo, a dataset in the
     reference's JSONL format written with the port's io.synthetic and
     io.jsonl.Recorder (752x480, the EuRoC-like cameras, the stereo path's
     world), the port's CLI run() in-process over API_FRAMES frames at the
     reference's defaults (stereo with -useStereo) with -maxFrames and
     -outputJsonExtras, then a -timer run over API_TIMER_FRAMES frames: frames
     in, outputs out, per-frame wall time at B=1, frames/s, ATE against the
     dataset's ground truth, launches, the host syncs of one step and the
     -timer stage table, and which JSONL reader and synchronizer ran. Fails
     on a non-finite output, fewer outputs than frames - 3, an ATE over
     0.05 m, a path kernel not launched, a host sync in a step, or the
     Python reader or synchronizer in place of the native ones (the
     reference's defaults);
  8. VISLAM on the card (BASELINE config 3), (a) and (b) on the torch
     keypoint detector (HYBVIO_NATIVE_ORB=0; phase 11d runs the native
     one): (a) the SLAM session alone,
     on the card and on the CPU in this process, over tests/test_slam.py's
     keyframe/BA scenarios and its revisit (240x320 frames, the multi-scale
     keypoints on) and tests/test_slam_global.py's revisit with applied loop
     closures, the pose graph and the end-of-run global adjustment: the same
     keyframe ids, map-point ids and loop events, poses and points within
     SLAM_POSE_TOL, a loop event on the card; (b) vislam: VioApi on
     synthetic_bench_params("vislam") (stereo, 752x480, B=1, the SLAM worker
     thread on) over VISLAM_FRAMES frames rendered on the card beforehand:
     per-frame wall time, frames/s, finish() teardown, SLAM keyframes, map
     points, loop events, dropped candidates, ATE of the SLAM-corrected
     outputs, the SLAM stage table per keyframe, host syncs of one step (the
     SLAM worker drained first), launches by shape; (c) the CLI with
     -useSlam and -slamMapPosesPath at the reference's defaults (the vislam()
     preset, mono) over phase 7's mono dataset. Fails on a mismatch in (a),
     a non-finite output, an ATE over 0.05 m, fewer than 2 SLAM keyframes, no
     local BA, no map point, a host sync in a step, a path kernel not
     launched, fewer CLI outputs than frames - 3 or a map file without a
     keyframe line;
  9. recorded stereo input and the stereo options: (a) STEREO_OPTION_STEPS
     (7) steps of each stereo option on stereo_per_lane's 16 worlds at
     752x480 (the batched update, a float32 filter): rectification of
     frames recorded through EuRoC cam0's radial distortion on both cameras
     (the frames rendered pinhole and warped through the distorted lens by
     the port's build_remap / remap), dense depth with the independent
     stereo triangulation, the independent stereo triangulation alone,
     upright-2P, stereo without RANSAC3, the FAST detector,
     predictOpticalFlow = false; each with its median step (steps 3-7)
     beside the same steps without an option and stereo_per_lane's phase-4
     median, finite lanes, ATE, launches and the host syncs of one step;
     then the SAD disparity alone at 16 lanes on the card; fails on a
     non-finite lane, a host sync or a path kernel the option runs and did
     not launch (FAST runs three of the four: no corner response); (b) a
     EuRoC ASL (mav0) tree of the stereo path's world at 752x480
     (EUROC_FRAMES frames through EuRoC cam0's intrinsics and radial
     distortion, PNG with the standard library's zlib where the decoder
     reads PNG, else PGM, imu0, ground truth) through the port's CLI run()
     in-process at the reference's defaults with -useStereo
     -useRectification: frames in, outputs out, per-frame wall time, decode
     time a frame, ATE, launches and the host syncs of one step; fails as
     phase 7;
 10. the textured world (eval/long_probe.py, frames ray-cast on the card by
     io/textured_device.py outside the timed step, one lane, float32
     filter): (a) long_stereo, the stereo preset at 752x480 over 20 s (200
     frames), ATE <= 0.05 m; (b) long_stereo_sqrt, the same with
     useSquareRootEkf over 10 s: finite, the smallest eigenvalue of
     W W^T >= -1e-9 x the largest, its ATE beside (a)'s over the same
     frames; (c) long_mono (752x480) and long_fisheye (512x512 KB4), 10 s
     each: finite, ATE printed; (d) zoom: VioApi on the mono preset at
     752x480 over ZOOM_FRAMES blob frames whose focal length grows by 30%,
     through add_frame_mono_varying beside the same frames through
     add_frame_mono: finite, the varying run's ATE under 0.7 x the fixed
     lens's. Each prints per-frame median and p90 ms, ATE, the host syncs
     of one step and its launches; any host sync in a step fails.
 11. the host layers at 752x480, B=1 (run_host_layers): (a) the CLI at the
     reference's defaults, mono and -useStereo, HOST_FRAMES frames each of
     phase 7's worlds, through the native JSONL reader and synchronizer,
     per-frame median and p90 beside phase 7's, and each synchronizer alone
     on the host (us a sample); (b) the stereo CLI with every -display*
     flag and -visualizationPath over DISPLAY_FRAMES frames: every view's
     file for every retired output, each view's render ms, and the
     corner-response kernel's launches from the CORNER_MEASURE view (at
     phase 3's 480x752 block-3 row); (c) vislam (8b) over PUBLISHER_FRAMES
     frames with a RecordingPublisher: its frames, visual updates,
     triangulations and clouds against the outputs; (d) vislam on the
     native ORB detector with the SLAM viewers on: keyframes, keypoint ms a
     keyframe, median, p90, finish() and ATE beside 8b's torch detector.
     Fails on a native module that fell back, a non-finite output or view,
     a view file missing, a host sync in a step, an ATE over 0.05 m or a
     CORNER_MEASURE view that launched no corner-response kernel.
 12. the multi-device layer (run_multi_device), over a Mesh of MESH_SHARDS
     (4) shards that all list the card (placement on one card, not
     scaling; a mesh of several cards is written and runs only where the
     host has them): (a) mesh_stereo_per_lane, stereo_per_lane at
     MESH_LANES (64) lanes, 16 a shard (phase 4's kernel shapes; lane b's
     world seeded 1000 + b, so shard 0's lanes are phase 4's), MESH_STEPS
     (10) steps: median step and aggregate frames/s beside phase 4's
     16-lane step; (b) scan_stereo, make_batched_scan over phase 4's
     stereo inputs (B=16, shared frames, SCAN_STEPS (20) frames), once
     under the sync check and once timed, wall ms a frame beside phase 4's
     median; (c) make_sharded_ba against ba_iterate on the card at NK = 20,
     MP = 1024, float64, 8 iterations (tools/scaling_bench.py's mesh check),
     each timed between CUDA events; (d) phase 8a's "BA on noisy odometry"
     through a card session with set_ba_mesh against a CPU session without;
     (e) graft_entry.dryrun_multichip over every card. Fails on a
     non-finite lane, an ATE median over 0.05 m, a host sync in a step or
     in scan_run, shard 0's or the scan's positions parting from phase 4's
     by more than 1e-6 m, the sharded BA's poses or points parting from the
     unsharded one's by more than 1e-5 / 1e-4, the session's ids differing
     or its poses parting by more than SLAM_POSE_TOL, no sharded BA run, or
     a dry run that raises. (a) and (b) count their launches under their
     own path names; (c) and (d) launch no kernel, and (e)'s launches at
     its 96x64 shapes (not timed in phase 3) are not counted.
 13. the compiled step (graphs.CapturedStep, the card's counterpart of
     jax.jit; the phases above step it wherever the reference jits): (a)
     in phase 4, each path COMPILED_STEPS (5) steps from its init state,
     eager (batched_step.eager), captured, captured, eager: every state
     leaf and output of every step bit-equal with the first eager run,
     no capture beyond phase 4's, the median step of each, the path's
     captures, their seconds, the graph pool, the launches a replay counts
     by kernel (the replays' counts equal to COMPILED_STEPS records),
     phase 4's host syncs of a replay step; (d) after each captured step
     the state and output of the step before unchanged, and the init state
     unchanged; (b) phase 12b's scan replays the graph, 0 m from phase 4;
     (c) phase 7's CLI runs again with VioApi(jit=False) over the same
     frames: positions 0 m from the jit=True run, per-frame median and p90
     of both, each API graph's captures and replays, the counted step a
     replay, the -timer split from the three stage graphs; (e) phase 8b's
     vislam steps the API's graph with the SLAM worker running; (f) phase
     12a's shards each replay a graph of their own, shard 0 0 m from phase
     4. A launch made while capturing is counted at every replay (the
     capture's record), not at the capture. Fails on any difference, a
     changed returned tensor, a capture in a counted step, or a host sync
     in a replay. Its summary, and the script's wall time, come before the
     kernel JSON.
 14. the compiled SLAM side (each keyframe-rate program of the SLAM session
     and its coupling a graphs.CapturedStep named "slam ...", SLAM_PROGRAMS,
     captured per session into the session's own graph pools; phases 8,
     11c, 11d and 12 run them captured): (b) phase 8b's vislam with every
     SLAM program's .eager form (the VIO step captured), then captured,
     captured and eager again: per-frame median and p90, finish() s and
     ATE of the four; of the first two the SLAM stage table per
     keyframe of both, keyframes, BA runs, loop events, dropped
     candidates, ATE, each local BA call's ms; the captured session equal
     to the eager one (ids, loop events, poses within SLAM_POSE_TOL) where
     their keyframes came from the same frames; in the captured run
     every step after step VISLAM_SYNC_STEP under the sync check, the
     stepping thread's syncs counted (the worker's not), and the steps
     beside a busy worker; (a)
     phase 8a's SLAM_RECORD_SCENARIOS through eager card sessions, held to
     8a's CPU sessions (8a holds its captured card sessions the same way),
     plus seeded direct calls of the programs no session called (the PnP
     and similarity RANSACs, the matcher, k-means, the sharded BA at 12c's
     problem), and every call recorded in (a) and (b)'s eager runs
     replayed through its captured program: every output leaf bit-equal;
     (c) at vislam's and phase 12c's problem sizes, ba_iterate and the
     sharded BA over 4 shards of the card, captured (replays) and eager,
     between CUDA events, and ba_iterate on the host CPU (the reference's
     placement, host clock); (d) each program's captures (signatures),
     capture s and replays, the SLAM pools' MiB beside the VIO steps'
     pool. Fails on a leaf not bit-equal, ids or loop events that differ
     from the CPU session's, poses more than SLAM_POSE_TOL apart, a
     signature captured twice, a program in SLAM_PROGRAMS that never
     replayed, an ATE over 0.05 m, a host sync of the stepping thread in a
     VIO step or no watched step beside a busy worker.
Before the last line come the kernel JSON and the card's name and power
limit; the last line is the device JSON."""
from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

B = 16
FRAMES = 60
# mono and fisheye are cut to 40 frames to keep the run near half its time
# limit with the sequential path (the paths that share their code with
# stereo_per_lane and stereo_sequential_hybrid keep 60), and
# stereo_sequential_hybrid (~2 s a step) to 40 to make room for phase 8
# (stereo_sequential_hybrid to 30 and the CLI runs of phases 7 and 8c to 14
# frames to make room for phase 9)
PATH_FRAMES = {"mono": 40, "fisheye": 40, "stereo_sequential_hybrid": 30}
PATHS = ("stereo", "mono", "fisheye", "stereo_per_lane", "stereo_sequential_hybrid")
FRAME_HW = {"stereo": (480, 752), "mono": (480, 752), "fisheye": (512, 512),
            "stereo_per_lane": (480, 752), "stereo_sequential_hybrid": (480, 752)}
PER_LANE_PATHS = ("stereo_per_lane", "stereo_sequential_hybrid")
# the reference's default estimator: the sequential visual update, here with
# a hybrid map of 16 points (d = 20 + 7 * 12 + 3 * 16 = 152), in a float64
# filter: a map point enters with variance 1e6, and in float32 its first
# updates cancel that to a few hundred chaotically: the JAX package's own
# float32 estimator with a map moves by more than 0.1 m within 20 frames
# when its accelerometer input moves by 1e-6 m/s^2, its float64 one by
# less than 1e-6 m (tests/test_torch_sequential.py; PERF.md section 6)
SEQUENTIAL_HYBRID = {"batchVisualUpdate": False, "hybridMapSize": 16}
FILTER_DTYPE = {"stereo_sequential_hybrid": "float64"}
PF_HYBRID = 2  # point_cloud_status of a map-point update
# the options phase: each on top of stereo_sequential_hybrid, OPTION_STEPS
# steps of the per-lane stereo input (shared frames: lane 0's frames and
# IMU for all): (name, odometry parameters, shared frames, filter dtype,
# steps). The float32 filter runs longer, to show its map drift per lane.
# 3 steps each (5 before phase 8 was added): step 2 counts the host syncs.
OPTION_STEPS = 3
OPTIONS = (("RANDOM sampling", {"trackSampling": "RANDOM"}, False, "float64", OPTION_STEPS),
           ("ALL sampling", {"trackSampling": "ALL"}, False, "float64", OPTION_STEPS),
           ("linear triangulation", {"useLinearTriangulation": True}, False, "float64",
            OPTION_STEPS),
           ("visual update every 2nd frame", {"visualUpdateForEveryNFrame": 2}, False, "float64",
            OPTION_STEPS),
           ("visual update disabled", {"visualUpdateEnabled": False}, False, "float64",
            OPTION_STEPS),
           ("batched visual update with the map", {"batchVisualUpdate": True}, False, "float64",
            OPTION_STEPS),
           ("shared frames", {}, True, "float64", OPTION_STEPS),
           ("float32 filter", {}, False, "float32", 20))
# kernels every path launches (pyr_down and scharr alone are off the paths)
PATH_KERNELS = ("pyramid_scharr", "patch_gather", "corner_response", "greedy_nms")
# the gathers the paths launch, per frame size: (images, window, pyramid
# level). The LK template (level, Ix, Iy) at 18x18 on levels 0-2; the LK
# search at 50x50 on the top level of the 3-level temporal LK (level 2) and
# of the 2-level stereo LK (level 1, stereo only), 34x34 below; the subpixel
# refinement's Ix and Iy at 33x33 on level 0.
GATHER_ROWS = {
    (480, 752): ((3, 18, 0), (3, 18, 1), (3, 18, 2), (1, 50, 2), (1, 50, 1), (1, 34, 1),
                 (1, 34, 0), (2, 33, 0)),
    (512, 512): ((3, 18, 0), (3, 18, 1), (3, 18, 2), (1, 50, 2), (1, 34, 1), (1, 34, 0),
                 (2, 33, 0)),
}
# the host entry point (phase 7): the CLI at the reference's defaults, one
# lane (B = 1), maxTracks T = 200 windows a gather, pyrLKWindowSize 31 over a
# 4-level pyramid (pyrLKMaxLevel 3). The gathers it launches on a 480x752
# frame: (images, window, pyramid level). The LK template (level, Ix, Iy) at
# 34x34 on levels 0-3; the temporal LK's search at 60x60 on its top level
# (level 3: its 16-pixel margin is clamped to 13 on the 60x94 level) and
# 50x50 below; the stereo LK's (two levels) at 66x66 on level 1 and 50x50
# on level 0; the subpixel refinement's Ix and Iy at 33x33 on level 0.
API_T = 200
API_LEVELS = 3
API_GATHER_ROWS = ((3, 34, 0), (3, 34, 1), (3, 34, 2), (3, 34, 3), (1, 60, 3), (1, 50, 2),
                   (1, 50, 1), (1, 50, 0), (1, 66, 1), (2, 33, 0))
API_GREEDY_K = 2 * API_T  # the detector's candidates, max(2 T, 128)
API_CONFIGS = ("mono", "stereo")
API_FRAMES = 14  # frames each CLI run reads
API_TIMER_FRAMES = 8  # frames of each -timer run
API_SYNC_STEP = 3  # the step whose host syncs are counted
ATE_LIMIT_M = 0.05
# phase 8: the SLAM session's CPU parity tolerance for poses and points (m;
# tests/test_torch_slam_session.py), the vislam run's frames, the step whose
# host syncs are counted (the SLAM worker drained first) and the preset's
# maxTracks (the windows of each gather)
SLAM_POSE_TOL = 1e-8
VISLAM_FRAMES = 60
VISLAM_SYNC_STEP = 10
VISLAM_T = 96
# phase 9: the stereo options (name, tracker / odometry parameters), each
# STEREO_OPTION_STEPS steps of the per-lane stereo input (step 2 counts the
# host syncs; the median is over the steps after it: 3 steps, as phase 6
# runs its options, left one sample, and single steps spread over 235-450
# ms on one host), and the EuRoC tree.
# EuRoC cam0's radial coefficients (io/euroc.py drops p1 and p2) and
# intrinsics.
EUROC_K = (-0.28340811, 0.07395907)
EUROC_INTRINSICS = (458.654, 457.296, 367.215, 248.375)
STEREO_OPTION_STEPS = 7
STEREO_OPTIONS = (
    ("rectification, EuRoC distortion", {"tracker.useRectification": True}),
    ("dense depth + independent triangulation",
     {"tracker.computeDenseStereoDepth": True, "odometry.useIndependentStereoTriangulation": True}),
    ("independent triangulation", {"odometry.useIndependentStereoTriangulation": True}),
    ("upright-2P", {"tracker.useRansac3": False, "tracker.useStereoUpright2p": True}),
    ("no RANSAC3", {"tracker.useRansac3": False}),
    ("FAST detector", {"tracker.featureDetector": "FAST"}),
    ("predictOpticalFlow = false", {"tracker.predictOpticalFlow": False}))
FAST_K = 256  # the FAST detector's candidates
EUROC_FRAMES = 14
# phase 10: the textured world (eval/long_probe.py's families at one lane,
# float32 filter, 10 frames a second, rendered on the card by
# io/textured_device.py outside the timed step) and the zooming lens. The
# seconds of each run; the step whose host syncs are counted; the scene
# seed; the zoom run's frames and focal-length ramp; the square-root
# factor's eigenvalue floor (relative to the largest). The short probe's
# shapes (eval/textured_probe.py: 320x240, maxTracks 64, pyrLKWindowSize
# 15, two levels) and the long fisheye's (512x512 at one lane) are timed in
# phase 3 (TEXTURED_SHAPES: frame size -> windows a gather, cameras).
TEXTURED_RUNS = (("long_stereo", "stereo", 20.0, False), ("long_stereo_sqrt", "stereo", 10.0, True),
                 ("long_mono", "mono", 10.0, False), ("long_fisheye", "fisheye", 10.0, False))
TEXTURED_SYNC_STEP = 3
TEXTURED_SEED = 8
ZOOM_FRAMES = 40
ZOOM = 0.30
ZOOM_ATE_RATIO = 0.7  # the reference's criterion (tests/test_varying_intrinsics.py)
SQRT_EIG_TOL = 1e-9
TEXTURED_SHAPES = {(240, 320): (64, (1, 2)), (512, 512): (96, (1,))}
# phase 11: the host layers (the native synchronizer, JSONL reader and ORB
# detector, the display flags, the debug publisher, the SLAM viewers). The
# frames of each CLI run at the defaults (11a) and of the display run
# (11b), the every -display* flag of the CLI and the views they write, the
# publisher run's frames (11c; 11d runs VISLAM_FRAMES) and the SLAM viewers
HOST_FRAMES = 10
DISPLAY_FRAMES = 7
DISPLAY_FLAGS = ("-displayVideo", "-displayPlainVideo", "-displayTracks", "-displayTracksAll",
                 "-displayOpticalFlow", "-displayCornerMeasure", "-displayStereoMatching",
                 "-displayStereoEpipolarCurves", "-displayStereoDisparity", "-displayStereoDepth",
                 "-displayPose", "-displayPointCloud", "-displayCovarianceMagnitude",
                 "-displayCorrelation", "-displayImuSamples")
DISPLAY_VIEWS = ("video", "plain", "tracks", "tracks_all", "flow", "corner", "stereo_match",
                 "epipolar", "disparity", "depth", "pose", "cov", "corr")
PUBLISHER_FRAMES = 30
SLAM_VIEWERS = {"displayKeyframe", "visualizeOrbs", "visualizeOrbPyramid", "visualizeOrbMatching",
                "visualizeLoopOrbMatching", "visualizeMapPointSearch"}
SLAM_VIEWS = ("keyframe", "orb_pyramid", "map_search", "orb_match")  # loop_match needs a loop
STENCIL_TOL = 1e-6
# phase 12: the multi-device layer on one card, a mesh of MESH_SHARDS shards
# that all list the card (placement, not scaling: the host has one card)
MESH_SHARDS = 4
MESH_LANES = MESH_SHARDS * B  # B lanes a shard: phase 4's kernel shapes
MESH_STEPS = 10
MESH_POS_TOL = 0.0  # m: shard 0 and the scan against phase 4 (the same captured step)
SCAN_STEPS = 20
BA_NK, BA_MP, BA_ITERATIONS = 20, 1024, 8  # tools/scaling_bench.py's mesh check
BA_POSE_TOL, BA_POINT_TOL = 1e-5, 1e-4  # the same check's bounds
BA_TIMED_RUNS = 5
MESH_SESSION = "BA on noisy odometry"  # the phase-8a scenario run with set_ba_mesh
# phase 13: the compiled step. COMPILED_STEPS steps of each phase-4 path
# from its init state, eager and captured, in the order eager, captured,
# captured, eager (phase 13a); the API's eager runs beside phase 7's (13c)
COMPILED_STEPS = 5
COMPILED = {}  # phase 13's numbers, by path
# phase 14: the compiled SLAM side. The programs a session captures (each a
# graphs.CapturedStep named "slam ..."; the sharded BA's is made by
# make_sharded_ba); phase 8a's scenarios whose eager card sessions are
# recorded for 14a; the CPU runs of each BA problem timed in 14c
SLAM_PROGRAMS = ("slam ORB descriptors", "slam multi-scale keypoints", "slam descriptor matcher",
                 "slam local BA", "slam pose graph", "slam similarity RANSAC", "slam PnP RANSAC",
                 "slam vocabulary k-means", "slam ray_to_pixel", "slam uint8 quantizer",
                 "slam sharded BA")
SLAM_RECORD_SCENARIOS = ("revisit", "applied loops")
BA_CPU_RUNS = 3
SLAM_SESSIONS = {}  # phase 8a: scenario -> (its card session, its CPU session)
COMPILED_SLAM = {}  # phase 14's numbers
R = 100  # back-to-back calls in one timed run
RUNS = 5  # timed runs; their median is kept
SLEEP_CYCLES_PER_S = 2e9  # the H100's top SM clock, rounded up
MAX_SLEEP_S = 0.25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source

KERNELS = {  # name -> (source, Pallas kernels it replaces, ", "-separated)
    "patch_gather": ("hybvio_tpu_torch/csrc/patch_gather.cu",
                     "hybvio_tpu/ops/patch_gather_pallas.py:105"),
    "pyr_down": ("hybvio_tpu_torch/csrc/pyramid.cu",
                 "hybvio_tpu/ops/pyramid_pallas.py:83"),
    "scharr": ("hybvio_tpu_torch/csrc/pyramid.cu",
               "hybvio_tpu/ops/pyramid_pallas.py:118"),
    "pyramid_scharr": ("hybvio_tpu_torch/csrc/pyramid.cu",
                       "hybvio_tpu/ops/pyramid_pallas.py:83, hybvio_tpu/ops/pyramid_pallas.py:118"),
    "corner_response": ("hybvio_tpu_torch/csrc/corner_response.cu",
                        "hybvio_tpu/ops/gftt_pallas.py:79"),
    "greedy_nms": ("hybvio_tpu_torch/csrc/greedy_nms.cu",
                   "hybvio_tpu/ops/nms_pallas.py:42"),
}


CARD = ""  # nvidia-smi's "name, power limit", set in main
PATH_MEDIAN_MS = {}  # phase 4's median step of each path
PHASE7_WALL = {}  # phase 7's per-frame wall time at B=1 (median, p90 ms) of mono and stereo
VISLAM_STATS = {}  # phase 8b's and 11's vislam runs: name -> their numbers
PATH_POSITIONS = {}  # phase 4's positions (F - 1, B, 3) of each path
STEREO_INPUTS = {}  # phase 4's stereo inputs (frames on the card, IMU), for phase 12b


def say(msg: str) -> None:
    """Print a line that begins with the card's name and power limit."""
    print(f"[{CARD}] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def device_ms(fn, reps=R):
    """(ms, ahead): the card's time per call of fn, the median over RUNS runs
    of ``reps`` back-to-back calls between two CUDA events (inputs made
    before).
    Before each run the stream sleeps long enough for the host to enqueue
    all the calls, so the card runs them back to back and never waits on the
    Python wrapper. ``ahead`` is False if the card caught up with the host in
    some run anyway (a composition of many launches can fill the queue);
    that time then includes host dispatch."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(3.0 * enqueue_s, MAX_SLEEP_S) * SLEEP_CYCLES_PER_S)
    times, ahead = [], True
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = ahead and not a.query()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times), ahead


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the least time an H100 SXM could take to
    move nbytes and do nops float32 operations."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def greedy_inputs(g, b, k, shared, ties, dev):
    """(d2 (b, k, k), ok (b, k), min_d2) for the greedy walk: candidates on
    an integer grid when ``ties`` (so d2 == min_d2 happens), else uniform in
    the frame; d2 shared by every lane (batch stride 0) when ``shared``;
    lane 0 has no eligible candidate and, with b > 1, the last lane only
    eligible ones."""
    import torch

    n = 1 if shared else b
    if ties:
        xy = torch.randint(0, 40, (n, k, 2), generator=g).float()
        min_d2 = 100.0
    else:
        xy = torch.rand((n, k, 2), generator=g) * torch.tensor([752.0, 480.0])
        min_d2 = (35.0 * 480 / 720) ** 2
    d2 = torch.sum((xy[:, :, None] - xy[:, None]) ** 2, dim=-1).to(dev)
    if shared:
        d2 = d2[0].expand(b, k, k)
    ok = torch.rand((b, k), generator=g) > 0.2
    ok[0] = False
    if b > 1:
        ok[-1] = True
    return d2, ok.to(dev), min_d2


def check_edge_cases(dev, g):
    """The kernels against their plain versions where chunks, words, tiles
    and halos end: the gather of 1 to 3 images at odd and even window sizes,
    on widths whose rows are and are not 16-byte aligned, shared and
    per-lane images, B = 1 and 16, origins past the edges; greedy at K up
    to 1024, shared and per-lane d2, exact ties, B = 1 and 16; the corner
    response at blocks 3 and 5 on the frame and on two odd level sizes, of
    one image and of 3 lanes; the pyramid, with and without the gradients of
    the first image's levels, of one and two images at 1 to 4 levels on the
    frame and on odd sizes, and of 3 lanes x 1 or 2 cameras at 0 to 4
    levels. Returns the number of cases."""
    import torch

    from hybvio_tpu_torch import ops

    cases = 0
    for h, w in ((480, 752), (239, 377), (60, 94)):  # 377, 94: rows not 16-byte aligned
        base = torch.rand((h, w), generator=g).to(dev)
        for b in (1, B):
            lanes = torch.rand((b, h, w), generator=g).to(dev)
            for ps in (18, 33, 34, 50):
                y0 = torch.randint(-3, h - ps + 4, (b, 96), generator=g, dtype=torch.int32).to(dev)
                x0 = torch.randint(-3, w - ps + 4, (b, 96), generator=g, dtype=torch.int32).to(dev)
                for images in ((base.expand(b, h, w),), (lanes, base.expand(b, h, w)),
                               (lanes, lanes * 2, base.expand(b, h, w))):
                    outs = ops.gather_patches(images, y0, x0, ps)
                    for out, im in zip(outs, images):
                        if not torch.equal(out, ops.gather_patches_plain(im, y0, x0, ps)):
                            raise AssertionError(f"patch_gather {h}x{w} B={b} ps={ps} "
                                                 f"{len(images)} images: windows differ")
                    cases += 1
    for k in (128, 192, 200, 1024):
        for b in (1, B):
            for shared in (True, False):
                for ties in (False, True):
                    d2, ok, min_d2 = greedy_inputs(g, b, k, shared, ties, dev)
                    bad = int((ops.greedy_min_distance(d2, ok, min_d2)
                               != ops.greedy_min_distance_plain(d2, ok, min_d2)).sum())
                    if bad:
                        raise AssertionError(f"greedy_nms K={k} B={b} shared={shared} "
                                             f"ties={ties}: {bad} decisions differ")
                    cases += 1
    for h, w in ((480, 752), (239, 377), (121, 189)):
        im = torch.rand((h, w), generator=g).to(dev)
        for bs in (3, 5):
            err = max_err(ops.corner_response(im, bs), ops.corner_response_plain(im, bs))
            if err != 0:
                raise AssertionError(f"corner_response {h}x{w} block {bs}: max abs error {err}")
            cases += 1
    for h, w in ((480, 752), (512, 512), (239, 377), (121, 189), (60, 94)):
        pair = tuple(torch.rand((h, w), generator=g).to(dev) for _ in range(2))
        for n in (1, 2):
            for levels in (1, 2, 3, 4):  # 4: two chained launches
                got = ops.pyr_down_levels(pair[:n], levels)
                want = ops.pyr_down_levels_plain(pair[:n], levels)
                err = max(max_err(a, b) for pa, pb in zip(got, want) for a, b in zip(pa, pb))
                if err != 0 or [len(p) for p in got] != [levels] * n:
                    raise AssertionError(f"pyramid {h}x{w}, {n} images, {levels} levels: "
                                         f"max abs error {err}")
                err = fused_err(pair[:n], levels)
                if err != 0:
                    raise AssertionError(f"pyramid_scharr {h}x{w}, {n} images, {levels} levels: "
                                         f"max abs error {err}")
                cases += 2
    for h, w in ((480, 752), (239, 377), (60, 94)):  # per lane, laid out as the renderer's
        lanes = torch.rand((3, 2, h, w), generator=g).to(dev)
        for n in (1, 2):
            cams = (lanes[:, 0], lanes[:, 1])[:n]
            for levels in (0, 1, 2, 3, 4):  # 0: the standalone Scharr; 4: two chained launches
                got = ops.pyr_down_levels(cams, levels)
                want = ops.pyr_down_levels_plain(cams, levels)
                err = max([max_err(a, b) for pa, pb in zip(got, want) for a, b in zip(pa, pb)]
                          + [fused_err(cams, levels)])
                if err != 0:
                    raise AssertionError(f"pyramid per lane {h}x{w}, {n} cameras, {levels} "
                                         f"levels: max abs error {err}")
                cases += 2
        for bs in (3, 5):
            err = max_err(ops.corner_response(lanes[:, 1], bs),
                          ops.corner_response_plain(lanes[:, 1], bs))
            if err != 0:
                raise AssertionError(f"corner_response per lane {h}x{w} block {bs}: "
                                     f"max abs error {err}")
            cases += 1
    return cases


def fused_err(images, levels) -> float:
    """Max abs error of the fused pyramid + gradients launch(es) against
    the plain version, over every level and gradient."""
    from hybvio_tpu_torch import ops

    got_p, got_g = ops.pyramid_with_gradients(images, levels)
    want_p, want_g = ops.pyramid_with_gradients_plain(images, levels)
    if [len(p) for p in got_p] != [levels] * len(images) or len(got_g) != levels + 1:
        raise AssertionError(f"pyramid_scharr: {[len(p) for p in got_p]} levels, "
                             f"{len(got_g)} gradients for {levels} levels")
    pairs = [(a, b) for pa, pb in zip(got_p, want_p) for a, b in zip(pa, pb)]
    pairs += [(a, b) for ga, gb in zip(got_g, want_g) for a, b in zip(ga, gb)]
    return max(max_err(a, b) for a, b in pairs)


def max_err(a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return float((a - b).abs().max())


def shape_key(shape) -> str:
    return "x".join(map(str, shape))


def check_kernels(dev):
    """Phase 3: every kernel against its plain version at main-path shapes,
    timed on the card beside its bound, its plain version and, where one
    PyTorch call computes the same function, that call (never used by the
    port); the stencils at every input shape the main path gives them; the
    card's launch floor."""
    import torch
    import torch.nn.functional as F

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.ops.pyramid import PYR_K, SCHARR_D, SCHARR_S

    g = torch.Generator(device="cpu").manual_seed(0)
    H, W = FRAME_HW["stereo"]
    img = torch.rand((H, W), generator=g).to(dev)
    right = torch.rand((H, W), generator=g).to(dev)
    fish = torch.rand(FRAME_HW["fisheye"], generator=g).to(dev)
    frames = {(H, W): img, FRAME_HW["fisheye"]: fish}
    px = H * W
    results = {}

    floor_ms, _ = device_ms(ops.launch_empty)
    say(f"launch floor: {floor_ms:.5f} ms per launch of an empty kernel (one thread), "
        f"the least any row below can read")

    def timed(label, err, tol, kernel, library, nbytes, nops, plain=None, plain_reps=R):
        """Check err against tol, time kernel / library / plain (the plain
        version over ``plain_reps`` calls a run), print a line; the row's
        numbers."""
        if not err <= tol:
            raise AssertionError(f"{label}: max abs error {err} > {tol}")
        ms, ahead = device_ms(kernel)
        library_ms = device_ms(library)[0] if library is not None else None
        plain_ms, plain_ahead = (device_ms(plain, plain_reps) if plain is not None
                                 else (None, True))
        bound_ms, bound_by = bound(nbytes, nops)
        lib = f"{library_ms:.5f} ms" if library_ms is not None else "none"
        plain_s = (f", plain {plain_ms:.5f} ms{'' if plain_ahead else ' (host-bound)'}"
                   if plain is not None else "")
        say(f"kernel {label}: max_abs_err {err:.3g} (tol {tol}); device {ms:.5f} ms"
            f"{'' if ahead else ' (card caught up with the host)'}, bound {bound_ms:.5f} ms "
            f"({bound_by}, {100 * bound_ms / ms:.1f}% of it), library {lib}{plain_s}")
        return {"max_abs_err": float(err), "ms": ms, "device_ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    def shape_row(r):
        return {k: r[k] for k in ("ms", "bound_ms", "library_ms", "max_abs_err")}

    # patch gather at every shape key (images, B, N, ps, H, W) the paths
    # launch, on the levels of a frame and their gradients shared by the
    # lanes (stride 0): GATHER_ROWS; origins inside the level. The bound
    # reads each pixel that some window covers once per image (the union of
    # the footprints), writes each window and reads each origin once.
    # Yardstick: one torch.gather of the stacked images' windows. Phase 5
    # charges each shape at its own row.
    errs = []
    for ps in (18, 50, 34, 33):  # origins past the frame's edges
        y0 = torch.randint(-3, H - ps + 4, (B, 96), generator=g, dtype=torch.int32).to(dev)
        x0 = torch.randint(-3, W - ps + 4, (B, 96), generator=g, dtype=torch.int32).to(dev)
        (out,) = ops.gather_patches((img.expand(B, H, W),), y0, x0, ps)
        errs.append(max_err(out, ops.gather_patches_plain(img.expand(B, H, W), y0, x0, ps)))
    n = 96
    shapes = {}
    for (fh, fw), rows in GATHER_ROWS.items():
        frame = frames[(fh, fw)]
        (lv,), grads = ops.pyramid_with_gradients((frame,), 2)
        for k, ps, level in rows:
            base = (frame, *lv)[level]
            planes = {3: (base, *grads[level]), 1: (base,), 2: grads[level]}[k]
            h, w = base.shape
            images = tuple(p.expand(B, h, w) for p in planes)
            y0 = torch.randint(0, h - ps + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
            x0 = torch.randint(0, w - ps + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
            r = torch.arange(ps, device=dev)
            idx = (((y0.long()[..., None] + r) * w)[..., :, None]
                   + (x0.long()[..., None] + r)[..., None, :]).reshape(B, -1).expand(k, B, -1)
            flat = torch.stack([p.reshape(-1) for p in planes])[:, None].expand(k, B, h * w)
            covered = torch.zeros(h * w, dtype=torch.bool, device=dev)
            covered[idx[0].reshape(-1)] = True
            read_px = int(covered.sum())
            got = ops.gather_patches(images, y0, x0, ps)
            want = [ops.gather_patches_plain(im, y0, x0, ps) for im in images]
            err = max([max_err(a, b) for a, b in zip(got, want)] + errs)
            if not torch.equal(torch.gather(flat, 2, idx).reshape(k, B, n, ps, ps),
                               torch.stack(got)):
                raise AssertionError(f"patch_gather {ps}x{ps} on {h}x{w}: the torch.gather "
                                     f"yardstick disagrees")
            srow = timed(f"patch_gather ({k} image{'s' if k > 1 else ''}, {B}x{n} windows of "
                         f"{ps}x{ps} on {h}x{w})", err, 0.0,
                         lambda: ops.gather_patches(images, y0, x0, ps),
                         lambda: torch.gather(flat, 2, idx),
                         4 * (k * B * n * ps * ps + k * read_px + 2 * B * n), 0,
                         plain=lambda: [ops.gather_patches_plain(im, y0, x0, ps) for im in images])
            say(f"  the windows cover {read_px} of the level's {h * w} pixels "
                f"({100 * read_px / (h * w):.1f}%)")
            shapes[shape_key((k, B, n, ps, h, w, "shared"))] = shape_row(srow)
            if (ps, h, w) == (34, H, W):
                row = srow
            if (k, ps, h, w) == (3, 18, H, W):  # the template's three images in one launch, or three
                three_ms, three_launches_ms = srow["ms"], device_ms(
                    lambda: [ops.gather_patches((im,), y0, x0, ps) for im in images])[0]
    row.update(shapes=shapes, template_3img_ms=three_ms,
               template_3launches_ms=three_launches_ms)
    results["patch_gather"] = row
    say(f"kernel patch_gather, LK template (3 images of 16x96 windows of 18x18 on {H}x{W}): "
        f"one launch {three_ms:.5f} ms, three launches {three_launches_ms:.5f} ms")

    # pyramid, main-path form: levels 1 and 2 of the left and right frames in
    # one launch (no single PyTorch call computes it: library none)
    levels_hw = [(H, W), ((H + 1) // 2, (W + 1) // 2), ((H + 3) // 4, (W + 3) // 4)]
    pair = (img, right)
    got, want = ops.pyr_down_levels(pair, 2), ops.pyr_down_levels_plain(pair, 2)
    err = max(max_err(a, b) for pa, pb in zip(got, want) for a, b in zip(pa, pb))
    pbytes = 2 * 4 * sum(h * w for h, w in levels_hw)
    pops = 2 * sum(9 * levels_hw[l - 1][0] * w + 9 * h * w
                   for l, (h, w) in enumerate(levels_hw) if l > 0)
    row = timed("pyr_down (2 images, 2 levels, one launch)", err, 0.0,
                lambda: ops.pyr_down_levels(pair, 2), None, pbytes, pops,
                plain=lambda: ops.pyr_down_levels_plain(pair, 2))
    row["shapes"] = {shape_key((2, 1, H, W, 2)): shape_row(row)}
    results["pyr_down"] = row
    # the single-image single-level kernel at both level sizes it replaces,
    # with the one-call yardstick (the 5x5 outer-product kernel at stride 2)
    k5 = torch.tensor(np.outer(PYR_K, PYR_K), dtype=torch.float32, device=dev)[None, None]
    level_imgs = [img, *got[0]]  # the left frame's levels 0, 1, 2
    lib_err = 0.0
    for (h, w), im in zip(levels_hw[:2], level_imgs):
        pad2 = F.pad(im[None, None], (2, 2, 2, 2), mode="replicate")
        lib_err = max(lib_err, max_err(F.conv2d(pad2, k5, stride=2)[0, 0], ops.pyr_down(im)))
        ho, wo = (h + 1) // 2, (w + 1) // 2
        srow = timed(f"pyr_down (1 image, 1 level, {h}x{w})",
                     max_err(ops.pyr_down(im), ops.pyr_down_plain(im)), 0.0,
                     lambda: ops.pyr_down(im), lambda: F.conv2d(pad2, k5, stride=2),
                     4 * (h * w + ho * wo), 9 * h * wo + 9 * ho * wo,
                     plain=(lambda: ops.pyr_down_plain(im)) if h == H else None)
        row["shapes"][shape_key((1, 1, h, w, 1))] = shape_row(srow)
        if h == H:
            row.update({f"single_{k}": v for k, v in srow.items() if k != "device_ms"})
    four, _ = device_ms(lambda: [ops.pyr_down(ops.pyr_down(im)) for im in pair])
    per_level, _ = device_ms(lambda: ops.pyr_down_levels(
        [lv[0] for lv in ops.pyr_down_levels(pair, 1)], 1))
    singles = 2 * sum(row["shapes"][shape_key((1, 1, h, w, 1))]["ms"] for h, w in levels_hw[:2])
    # one launch per level computes the same function: the same bound
    row.update(four_launches_ms=four, per_level_2img_ms=per_level, single_sum_ms=singles)
    say(f"kernel pyr_down, the pyramid of one stereo frame: one launch {row['ms']:.5f} ms; "
        f"four single-image single-level launches {four:.5f} ms (their timed rows summed: "
        f"{singles:.5f} ms); two launches of one level each for both images "
        f"{per_level:.5f} ms (bound {row['bound_ms']:.5f} ms, "
        f"{100 * row['bound_ms'] / per_level:.1f}% of it)")

    # Scharr at every level size the main path gives it: one 2-channel 3x3
    # convolution of the padded level as the yardstick
    k3 = torch.tensor(np.stack([np.outer(SCHARR_S, SCHARR_D), np.outer(SCHARR_D, SCHARR_S)]),
                      dtype=torch.float32, device=dev)[:, None]
    shapes = {}
    for (h, w), im in zip(levels_hw, level_imgs):
        ix, iy = ops.scharr(im)
        pad1 = F.pad(im[None, None], (1, 1, 1, 1), mode="replicate")
        lib_err = max(lib_err, max_err(F.conv2d(pad1, k3)[0], torch.stack([ix, iy])))
        rx, ry = ops.scharr_plain(im)
        srow = timed(f"scharr {h}x{w}", max(max_err(ix, rx), max_err(iy, ry)), STENCIL_TOL,
                     lambda: ops.scharr(im), lambda: F.conv2d(pad1, k3), 4 * 3 * h * w,
                     2 * 10 * h * w, plain=(lambda: ops.scharr_plain(im)) if h == H else None)
        shapes[shape_key((1, h, w))] = shape_row(srow)
        if h == H:
            results["scharr"] = srow
    results["scharr"]["shapes"] = shapes
    if not lib_err <= 1e-5:
        raise AssertionError(f"the conv2d yardsticks disagree with the stencils by {lib_err}")

    # the main path's form: levels 1 and 2 of both frames and the gradients
    # of levels 0-2 of the left one in one launch (no single PyTorch call
    # computes it: library none), also chained at 4 levels and on one image,
    # beside the pyramid launch and the three Scharr launches it replaced
    for images, levels in ((pair, 4), (pair[:1], 2)):
        err = fused_err(images, levels)
        if err != 0:
            raise AssertionError(f"pyramid_scharr {len(images)} images, {levels} levels: "
                                 f"max abs error {err}")
    row = timed("pyramid_scharr (2 images, 2 levels, gradients of the left levels 0-2, one "
                "launch)", fused_err(pair, 2), 0.0, lambda: ops.pyramid_with_gradients(pair, 2),
                None, 2 * pbytes, pops + sum(2 * 10 * h * w for h, w in levels_hw),
                plain=lambda: ops.pyramid_with_gradients_plain(pair, 2))
    row["shapes"] = {shape_key((2, 1, H, W, 2)): shape_row(row)}
    # the mono and fisheye paths' form: one frame's levels 1-2 and the
    # gradients of its levels 0-2 (bytes: read level 0, write levels 1-2,
    # write both gradients of levels 0-2)
    for frame in frames.values():
        fh, fw = frame.shape
        lhw = [(fh, fw), ((fh + 1) // 2, (fw + 1) // 2), ((fh + 3) // 4, (fw + 3) // 4)]
        ops1 = (sum(9 * lhw[l - 1][0] * w + 9 * h * w for l, (h, w) in enumerate(lhw) if l > 0)
                + sum(2 * 10 * h * w for h, w in lhw))
        srow = timed(f"pyramid_scharr (1 image, {fh}x{fw}, 2 levels, gradients of levels 0-2, "
                     f"one launch)", fused_err((frame,), 2), 0.0,
                     lambda: ops.pyramid_with_gradients((frame,), 2), None,
                     3 * 4 * sum(h * w for h, w in lhw), ops1,
                     plain=lambda: ops.pyramid_with_gradients_plain((frame,), 2))
        row["shapes"][shape_key((1, 1, fh, fw, 2))] = shape_row(srow)
    replaced, _ = device_ms(lambda: [ops.pyr_down_levels(pair, 2)]
                            + [ops.scharr(im) for im in level_imgs])
    rows_sum = results["pyr_down"]["ms"] + sum(v["ms"] for v in shapes.values())
    row.update(replaced_4launches_ms=replaced, replaced_rows_sum_ms=rows_sum)
    results["pyramid_scharr"] = row
    say(f"kernel pyramid_scharr, one stereo frame's pyramid and left gradients: one launch "
        f"{row['ms']:.5f} ms; the pyramid launch and three Scharr launches it replaced "
        f"{replaced:.5f} ms (their timed rows summed: {rows_sum:.5f} ms)")

    for bs in (3, 5):
        srow = timed(f"corner_response block {bs}",
                     max_err(ops.corner_response(img, bs), ops.corner_response_plain(img, bs)),
                     0.0, lambda: ops.corner_response(img, bs), None, 4 * 2 * px,
                     (46 + 6 * (bs - 3)) * px, plain=lambda: ops.corner_response_plain(img, bs))
        if bs == 3:
            srow["shapes"] = {shape_key((1, H, W, 3)): shape_row(srow)}
            results["corner_response"] = srow
        else:
            results["corner_response"].update(block5_ms=srow["ms"], block5_bound_ms=srow["bound_ms"],
                                               block5_max_abs_err=srow["max_abs_err"])
    fh, fw = fish.shape
    srow = timed(f"corner_response block 3, {fh}x{fw}",
                 max_err(ops.corner_response(fish, 3), ops.corner_response_plain(fish, 3)), 0.0,
                 lambda: ops.corner_response(fish, 3), None, 4 * 2 * fh * fw, 46 * fh * fw,
                 plain=lambda: ops.corner_response_plain(fish, 3))
    results["corner_response"]["shapes"][shape_key((1, fh, fw, 3))] = shape_row(srow)

    # greedy: the main path's layout, one d2 shared by the lanes (stride 0)
    K = 192
    d2, ok, min_d2 = greedy_inputs(g, B, K, True, False, dev)
    taken = ops.greedy_min_distance(d2, ok, min_d2)
    ref = ops.greedy_min_distance_plain(d2, ok, min_d2)
    row = timed("greedy_nms", float((taken != ref).sum()), 0.0,
                lambda: ops.greedy_min_distance(d2, ok, min_d2), None,
                4 * K * K + 2 * B * K, B * K * (K - 1) // 2,
                plain=lambda: ops.greedy_min_distance_plain(d2, ok, min_d2))
    row["shapes"] = {shape_key((B, K, "shared")): shape_row(row)}
    results["greedy_nms"] = row
    # and with a distinct d2 per lane (the per-lane path)
    d2l, okl, _ = greedy_inputs(g, B, K, False, False, dev)
    srow = timed("greedy_nms, per-lane d2", float((ops.greedy_min_distance(d2l, okl, min_d2)
                                                   != ops.greedy_min_distance_plain(d2l, okl, min_d2)
                                                   ).sum()), 0.0,
                 lambda: ops.greedy_min_distance(d2l, okl, min_d2), None,
                 4 * B * K * K + 2 * B * K, B * K * (K - 1) // 2,
                 plain=lambda: ops.greedy_min_distance_plain(d2l, okl, min_d2), plain_reps=10)
    row["shapes"][shape_key((B, K, "per-lane"))] = shape_row(srow)

    check_per_lane(dev, g, results, timed, shape_row)
    check_api_shapes(dev, g, results, timed, shape_row)
    check_vislam_shapes(dev, g, results, timed, shape_row)
    check_fast_shapes(dev, g, results, timed, shape_row)
    check_textured_shapes(dev, g, results, timed, shape_row)

    say(f"edge cases: {check_edge_cases(dev, g)} gather / greedy / corner-response / pyramid "
        f"/ pyramid-and-gradients cases equal their plain versions")
    return results, floor_ms


def check_per_lane(dev, g, results, timed, shape_row):
    """Phase 3 at the per-lane path's shapes: B lanes of distinct 480x752
    stereo frames laid out (B, 2, H, W) as the renderer gives them (camera
    c is a (B, H, W) view with lane stride 2 H W). The fused pyramid of the
    B x 2 images, the corner response of the B left images, the gather of
    per-lane levels and gradients at every window shape and level of
    GATHER_ROWS (its bound reads each lane's footprint once per image),
    each against its plain version exactly; rows join the kernels' shape
    tables under the keys the wrappers count launches by."""
    import torch

    from hybvio_tpu_torch import ops

    H, W = FRAME_HW["stereo_per_lane"]
    frames = torch.rand((B, 2, H, W), generator=g).to(dev)
    cams = (frames[:, 0], frames[:, 1])
    lhw = [(H, W), ((H + 1) // 2, (W + 1) // 2), ((H + 3) // 4, (W + 3) // 4)]
    err = fused_err(cams, 2)
    pops = B * (2 * sum(9 * lhw[l - 1][0] * w + 9 * h * w for l, (h, w) in enumerate(lhw) if l > 0)
                + sum(2 * 10 * h * w for h, w in lhw))
    # bytes: read the B x 2 frames, write their levels 1-2 and the gradients
    # of the B left frames' levels 0-2
    pbytes = 4 * B * (2 * H * W + 2 * sum(h * w for h, w in lhw[1:])
                      + 2 * sum(h * w for h, w in lhw))
    srow = timed(f"pyramid_scharr ({B} lanes x 2 cameras, {H}x{W}, 2 levels, gradients of the "
                 f"left levels 0-2, one launch)", err, 0.0,
                 lambda: ops.pyramid_with_gradients(cams, 2), None, pbytes, pops,
                 plain=lambda: ops.pyramid_with_gradients_plain(cams, 2), plain_reps=3)
    results["pyramid_scharr"]["shapes"][shape_key((2, B, H, W, 2))] = shape_row(srow)

    left = cams[0]
    srow = timed(f"corner_response block 3, {B} lanes x {H}x{W}",
                 max_err(ops.corner_response(left, 3), ops.corner_response_plain(left, 3)), 0.0,
                 lambda: ops.corner_response(left, 3), None, 4 * 2 * B * H * W, 46 * B * H * W,
                 plain=lambda: ops.corner_response_plain(left, 3), plain_reps=3)
    results["corner_response"]["shapes"][shape_key((B, H, W, 3))] = shape_row(srow)

    (lv, _), grads = ops.pyramid_with_gradients(cams, 2)
    n = 96
    for k, ps, level in GATHER_ROWS[(H, W)]:
        base = (left, *lv)[level]
        planes = {3: (base, *grads[level]), 1: (base,), 2: grads[level]}[k]
        h, w = base.shape[-2:]
        y0 = torch.randint(0, h - ps + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
        x0 = torch.randint(0, w - ps + 1, (B, n), generator=g, dtype=torch.int32).to(dev)
        r = torch.arange(ps, device=dev)
        idx = (((y0.long()[..., None] + r) * w)[..., :, None]
               + (x0.long()[..., None] + r)[..., None, :]).reshape(B, -1).expand(k, B, -1)
        flat = torch.stack([p.reshape(B, h * w) for p in planes])
        covered = torch.zeros((B, h * w), dtype=torch.bool, device=dev)
        covered.scatter_(1, idx[0], True)
        read_px = int(covered.sum())  # each lane's footprint, summed over the lanes
        got = ops.gather_patches(planes, y0, x0, ps)
        err = max(max_err(a, ops.gather_patches_plain(im, y0, x0, ps)) for a, im in zip(got, planes))
        if not torch.equal(torch.gather(flat, 2, idx).reshape(k, B, n, ps, ps), torch.stack(got)):
            raise AssertionError(f"patch_gather per lane {ps}x{ps} on {h}x{w}: the torch.gather "
                                 f"yardstick disagrees")
        srow = timed(f"patch_gather ({k} per-lane image{'s' if k > 1 else ''}, {B}x{n} windows "
                     f"of {ps}x{ps} on {B} lanes of {h}x{w})", err, 0.0,
                     lambda: ops.gather_patches(planes, y0, x0, ps),
                     lambda: torch.gather(flat, 2, idx),
                     4 * (k * B * n * ps * ps + k * read_px + 2 * B * n), 0,
                     plain=lambda: [ops.gather_patches_plain(im, y0, x0, ps) for im in planes],
                     plain_reps=10)
        say(f"  the windows cover {read_px} of the {B} lanes' {B * h * w} pixels "
            f"({100 * read_px / (B * h * w):.1f}%)")
        results["patch_gather"]["shapes"][shape_key((k, B, n, ps, h, w, "per-lane"))] = \
            shape_row(srow)


def check_api_shapes(dev, g, results, timed, shape_row):
    """Phase 3 at the shapes the host entry point (phase 7) gives the
    kernels at the reference's defaults, one lane: the fused pyramid of a
    480x752 frame (mono) and of a stereo pair at API_LEVELS levels in one
    launch, the gather of API_T windows at every row of API_GATHER_ROWS on
    the levels and gradients of that pyramid, greedy over API_GREEDY_K
    candidates; each against its plain version exactly. (The corner response
    of one 480x752 lane is the main-path row.) Rows join the kernels' shape
    tables under the keys the wrappers count launches by."""
    import torch

    from hybvio_tpu_torch import ops

    H, W = FRAME_HW["stereo"]
    L = API_LEVELS
    frames = torch.rand((1, 2, H, W), generator=g).to(dev)  # one lane, two cameras
    cams = (frames[:, 0], frames[:, 1])
    lhw = [(H, W)]
    for _ in range(L):
        lhw.append(((lhw[-1][0] + 1) // 2, (lhw[-1][1] + 1) // 2))
    blur = sum(9 * lhw[l - 1][0] * w + 9 * h * w for l, (h, w) in enumerate(lhw) if l > 0)
    grad = sum(2 * 10 * h * w for h, w in lhw)
    for n in (1, 2):
        images = cams[:n]
        # bytes: read the n frames, write their levels 1..L and both
        # gradients of the first frame's levels 0..L
        nbytes = 4 * (n * H * W + n * sum(h * w for h, w in lhw[1:])
                      + 2 * sum(h * w for h, w in lhw))
        srow = timed(f"pyramid_scharr ({n} camera{'s' if n > 1 else ''}, one lane, {H}x{W}, "
                     f"{L} levels, gradients of levels 0-{L}, one launch)", fused_err(images, L),
                     0.0, lambda: ops.pyramid_with_gradients(images, L), None, nbytes,
                     n * blur + grad, plain=lambda: ops.pyramid_with_gradients_plain(images, L))
        results["pyramid_scharr"]["shapes"][shape_key((n, 1, H, W, L))] = shape_row(srow)

    (lv, _), grads = ops.pyramid_with_gradients(cams, L)
    left = cams[0]
    for k, ps, level in API_GATHER_ROWS:
        base = (left, *lv)[level]
        planes = {3: (base, *grads[level]), 1: (base,), 2: grads[level]}[k]
        h, w = base.shape[-2:]
        y0 = torch.randint(0, h - ps + 1, (1, API_T), generator=g, dtype=torch.int32).to(dev)
        x0 = torch.randint(0, w - ps + 1, (1, API_T), generator=g, dtype=torch.int32).to(dev)
        r = torch.arange(ps, device=dev)
        idx = (((y0.long()[..., None] + r) * w)[..., :, None]
               + (x0.long()[..., None] + r)[..., None, :]).reshape(1, -1).expand(k, 1, -1)
        flat = torch.stack([p.reshape(1, h * w) for p in planes])
        covered = torch.zeros((1, h * w), dtype=torch.bool, device=dev)
        covered.scatter_(1, idx[0], True)
        read_px = int(covered.sum())
        got = ops.gather_patches(planes, y0, x0, ps)
        err = max(max_err(a, ops.gather_patches_plain(im, y0, x0, ps)) for a, im in zip(got, planes))
        if not torch.equal(torch.gather(flat, 2, idx).reshape(k, 1, API_T, ps, ps),
                           torch.stack(got)):
            raise AssertionError(f"patch_gather one lane {ps}x{ps} on {h}x{w}: the torch.gather "
                                 f"yardstick disagrees")
        srow = timed(f"patch_gather ({k} image{'s' if k > 1 else ''}, one lane, {API_T} windows "
                     f"of {ps}x{ps} on {h}x{w})", err, 0.0,
                     lambda: ops.gather_patches(planes, y0, x0, ps),
                     lambda: torch.gather(flat, 2, idx),
                     4 * (k * API_T * ps * ps + k * read_px + 2 * API_T), 0,
                     plain=lambda: [ops.gather_patches_plain(im, y0, x0, ps) for im in planes])
        say(f"  the windows cover {read_px} of the level's {h * w} pixels "
            f"({100 * read_px / (h * w):.1f}%)")
        results["patch_gather"]["shapes"][shape_key((k, 1, API_T, ps, h, w, "shared"))] = \
            shape_row(srow)

    K = API_GREEDY_K
    d2, ok, min_d2 = greedy_inputs(g, 2, K, False, False, dev)
    d2, ok = d2[1:].contiguous(), ok[1:].contiguous()  # the lane with eligible candidates
    srow = timed(f"greedy_nms, one lane, K={K}",
                 float((ops.greedy_min_distance(d2, ok, min_d2)
                        != ops.greedy_min_distance_plain(d2, ok, min_d2)).sum()), 0.0,
                 lambda: ops.greedy_min_distance(d2, ok, min_d2), None, 4 * K * K + 2 * K,
                 K * (K - 1) // 2, plain=lambda: ops.greedy_min_distance_plain(d2, ok, min_d2),
                 plain_reps=10)
    results["greedy_nms"]["shapes"][shape_key((1, K, "shared"))] = shape_row(srow)


def check_vislam_shapes(dev, g, results, timed, shape_row):
    """Phase 3 at the shapes the vislam preset (phase 8b: the stereo preset
    at one lane) gives the kernels: the gather of VISLAM_T windows at every
    row of GATHER_ROWS on the levels and gradients of a 480x752 stereo
    pyramid, and greedy over the preset's 192 candidates, one lane; each
    against its plain version exactly. (The fused pyramid of one stereo
    frame and the corner response of one 480x752 image are main-path
    rows.)"""
    import torch

    from hybvio_tpu_torch import ops

    H, W = FRAME_HW["stereo"]
    frames = torch.rand((1, 2, H, W), generator=g).to(dev)
    cams = (frames[:, 0], frames[:, 1])
    (lv, _), grads = ops.pyramid_with_gradients(cams, 2)
    left, n = cams[0], VISLAM_T
    for k, ps, level in GATHER_ROWS[(H, W)]:
        base = (left, *lv)[level]
        planes = {3: (base, *grads[level]), 1: (base,), 2: grads[level]}[k]
        h, w = base.shape[-2:]
        y0 = torch.randint(0, h - ps + 1, (1, n), generator=g, dtype=torch.int32).to(dev)
        x0 = torch.randint(0, w - ps + 1, (1, n), generator=g, dtype=torch.int32).to(dev)
        r = torch.arange(ps, device=dev)
        idx = (((y0.long()[..., None] + r) * w)[..., :, None]
               + (x0.long()[..., None] + r)[..., None, :]).reshape(1, -1).expand(k, 1, -1)
        flat = torch.stack([p.reshape(1, h * w) for p in planes])
        covered = torch.zeros((1, h * w), dtype=torch.bool, device=dev)
        covered.scatter_(1, idx[0], True)
        read_px = int(covered.sum())
        got = ops.gather_patches(planes, y0, x0, ps)
        err = max(max_err(a, ops.gather_patches_plain(im, y0, x0, ps)) for a, im in zip(got, planes))
        if not torch.equal(torch.gather(flat, 2, idx).reshape(k, 1, n, ps, ps), torch.stack(got)):
            raise AssertionError(f"patch_gather one lane {ps}x{ps} on {h}x{w}: the torch.gather "
                                 f"yardstick disagrees")
        srow = timed(f"patch_gather ({k} image{'s' if k > 1 else ''}, one lane, {n} windows "
                     f"of {ps}x{ps} on {h}x{w})", err, 0.0,
                     lambda: ops.gather_patches(planes, y0, x0, ps),
                     lambda: torch.gather(flat, 2, idx),
                     4 * (k * n * ps * ps + k * read_px + 2 * n), 0,
                     plain=lambda: [ops.gather_patches_plain(im, y0, x0, ps) for im in planes])
        say(f"  the windows cover {read_px} of the level's {h * w} pixels "
            f"({100 * read_px / (h * w):.1f}%)")
        results["patch_gather"]["shapes"][shape_key((k, 1, n, ps, h, w, "shared"))] = \
            shape_row(srow)

    K = 2 * VISLAM_T
    d2, ok, min_d2 = greedy_inputs(g, 2, K, False, False, dev)
    d2, ok = d2[1:].contiguous(), ok[1:].contiguous()  # the lane with eligible candidates
    srow = timed(f"greedy_nms, one lane, K={K}",
                 float((ops.greedy_min_distance(d2, ok, min_d2)
                        != ops.greedy_min_distance_plain(d2, ok, min_d2)).sum()), 0.0,
                 lambda: ops.greedy_min_distance(d2, ok, min_d2), None, 4 * K * K + 2 * K,
                 K * (K - 1) // 2, plain=lambda: ops.greedy_min_distance_plain(d2, ok, min_d2),
                 plain_reps=10)
    results["greedy_nms"]["shapes"][shape_key((1, K, "shared"))] = shape_row(srow)


def check_fast_shapes(dev, g, results, timed, shape_row):
    """Phase 3 at the FAST detector's shape (phase 9a): the greedy walk over
    its FAST_K candidates, at one lane and at B lanes with a per-lane d2,
    each against its plain version exactly."""
    from hybvio_tpu_torch import ops

    K = FAST_K
    d2, ok, min_d2 = greedy_inputs(g, 2, K, False, False, dev)
    d2, ok = d2[1:].contiguous(), ok[1:].contiguous()  # the lane with eligible candidates
    srow = timed(f"greedy_nms, one lane, K={K} (FAST)",
                 float((ops.greedy_min_distance(d2, ok, min_d2)
                        != ops.greedy_min_distance_plain(d2, ok, min_d2)).sum()), 0.0,
                 lambda: ops.greedy_min_distance(d2, ok, min_d2), None, 4 * K * K + 2 * K,
                 K * (K - 1) // 2, plain=lambda: ops.greedy_min_distance_plain(d2, ok, min_d2),
                 plain_reps=10)
    results["greedy_nms"]["shapes"][shape_key((1, K, "shared"))] = shape_row(srow)
    d2l, okl, _ = greedy_inputs(g, B, K, False, False, dev)
    srow = timed(f"greedy_nms, {B} lanes, per-lane d2, K={K} (FAST)",
                 float((ops.greedy_min_distance(d2l, okl, min_d2)
                        != ops.greedy_min_distance_plain(d2l, okl, min_d2)).sum()), 0.0,
                 lambda: ops.greedy_min_distance(d2l, okl, min_d2), None,
                 4 * B * K * K + 2 * B * K, B * K * (K - 1) // 2,
                 plain=lambda: ops.greedy_min_distance_plain(d2l, okl, min_d2), plain_reps=10)
    results["greedy_nms"]["shapes"][shape_key((B, K, "per-lane"))] = shape_row(srow)


def check_textured_shapes(dev, g, results, timed, shape_row):
    """Phase 3 at the textured world's new shapes (TEXTURED_SHAPES), one
    lane: the gather of the frame size's windows at every row of
    GATHER_ROWS (the short probe's 240x320 at the 480x752 rows) on the
    levels and gradients of a two-level pyramid, the fused pyramid of one
    and two cameras, the corner response, and greedy over the detector's
    max(2 T, 128) candidates; each against its plain version exactly. A
    shape some earlier row timed is not timed again."""
    import torch

    from hybvio_tpu_torch import ops

    for (H, W), (n, cams_n) in TEXTURED_SHAPES.items():
        frames = torch.rand((1, 2, H, W), generator=g).to(dev)  # one lane, two cameras
        cams = (frames[:, 0], frames[:, 1])
        lhw = [(H, W), ((H + 1) // 2, (W + 1) // 2), ((H + 3) // 4, (W + 3) // 4)]
        blur = sum(9 * lhw[l - 1][0] * w + 9 * h * w for l, (h, w) in enumerate(lhw) if l > 0)
        grad = sum(2 * 10 * h * w for h, w in lhw)
        for c in cams_n:
            key = shape_key((c, 1, H, W, 2))
            if key in results["pyramid_scharr"]["shapes"]:
                continue
            images = cams[:c]
            nbytes = 4 * (c * H * W + c * sum(h * w for h, w in lhw[1:])
                          + 2 * sum(h * w for h, w in lhw))
            srow = timed(f"pyramid_scharr ({c} camera{'s' if c > 1 else ''}, one lane, {H}x{W}, "
                         f"2 levels, gradients of levels 0-2, one launch)", fused_err(images, 2),
                         0.0, lambda: ops.pyramid_with_gradients(images, 2), None, nbytes,
                         c * blur + grad, plain=lambda: ops.pyramid_with_gradients_plain(images, 2))
            results["pyramid_scharr"]["shapes"][key] = shape_row(srow)
        (lv, _), grads = ops.pyramid_with_gradients(cams, 2)
        left = cams[0]
        rows = GATHER_ROWS.get((H, W), GATHER_ROWS[FRAME_HW["stereo"]])
        for k, ps, level in rows:
            base = (left, *lv)[level]
            h, w = base.shape[-2:]
            key = shape_key((k, 1, n, ps, h, w, "shared"))
            if key in results["patch_gather"]["shapes"]:
                continue
            planes = {3: (base, *grads[level]), 1: (base,), 2: grads[level]}[k]
            y0 = torch.randint(0, h - ps + 1, (1, n), generator=g, dtype=torch.int32).to(dev)
            x0 = torch.randint(0, w - ps + 1, (1, n), generator=g, dtype=torch.int32).to(dev)
            r = torch.arange(ps, device=dev)
            idx = (((y0.long()[..., None] + r) * w)[..., :, None]
                   + (x0.long()[..., None] + r)[..., None, :]).reshape(1, -1).expand(k, 1, -1)
            flat = torch.stack([p.reshape(1, h * w) for p in planes])
            covered = torch.zeros((1, h * w), dtype=torch.bool, device=dev)
            covered.scatter_(1, idx[0], True)
            read_px = int(covered.sum())
            got = ops.gather_patches(planes, y0, x0, ps)
            err = max(max_err(a, ops.gather_patches_plain(im, y0, x0, ps))
                      for a, im in zip(got, planes))
            if not torch.equal(torch.gather(flat, 2, idx).reshape(k, 1, n, ps, ps),
                               torch.stack(got)):
                raise AssertionError(f"patch_gather one lane {ps}x{ps} on {h}x{w}: the "
                                     f"torch.gather yardstick disagrees")
            srow = timed(f"patch_gather ({k} image{'s' if k > 1 else ''}, one lane, {n} windows "
                         f"of {ps}x{ps} on {h}x{w})", err, 0.0,
                         lambda: ops.gather_patches(planes, y0, x0, ps),
                         lambda: torch.gather(flat, 2, idx),
                         4 * (k * n * ps * ps + k * read_px + 2 * n), 0,
                         plain=lambda: [ops.gather_patches_plain(im, y0, x0, ps) for im in planes])
            results["patch_gather"]["shapes"][key] = shape_row(srow)
        key = shape_key((1, H, W, 3))
        if key not in results["corner_response"]["shapes"]:
            img = left[0]
            srow = timed(f"corner_response block 3, one lane, {H}x{W}",
                         max_err(ops.corner_response(img, 3), ops.corner_response_plain(img, 3)),
                         0.0, lambda: ops.corner_response(img, 3), None, 4 * 2 * H * W,
                         46 * H * W, plain=lambda: ops.corner_response_plain(img, 3))
            results["corner_response"]["shapes"][key] = shape_row(srow)
        K = max(2 * n, 128)
        key = shape_key((1, K, "shared"))
        if key not in results["greedy_nms"]["shapes"]:
            d2, ok, min_d2 = greedy_inputs(g, 2, K, False, False, dev)
            d2, ok = d2[1:].contiguous(), ok[1:].contiguous()  # the lane with candidates
            srow = timed(f"greedy_nms, one lane, K={K}",
                         float((ops.greedy_min_distance(d2, ok, min_d2)
                                != ops.greedy_min_distance_plain(d2, ok, min_d2)).sum()), 0.0,
                         lambda: ops.greedy_min_distance(d2, ok, min_d2), None,
                         4 * K * K + 2 * K, K * (K - 1) // 2,
                         plain=lambda: ops.greedy_min_distance_plain(d2, ok, min_d2),
                         plain_reps=10)
            results["greedy_nms"]["shapes"][key] = shape_row(srow)


def rank(rows, path=None):
    """The order in which the kernels lose ``path`` (or, with None, all the
    paths together) the most time: first any kernel slower than its library
    call at some shape, then the rest by the sum over the input shapes the
    path gave it of launches x (device time - bound); a kernel at >= 50% of
    its bound and no slower than its library call is left alone. Raises if
    a path launched a kernel at a shape phase 3 did not time."""
    def slower(r):
        return any(s.get("library_ms") is not None and s["ms"] > s["library_ms"]
                   for s in (r, *r["shapes"].values()) if "ms" in s)

    def launches(s):
        return s["launches"][path] if path else sum(s["launches"].values())

    for r in rows:
        untimed = [k for k, s in r["shapes"].items()
                   if any(s["launches"].values()) and "ms" not in s]
        if untimed:
            raise AssertionError(f"{r['name']} launched at shapes phase 3 did not time: {untimed}")
    loss = {r["name"]: sum(launches(s) * (s["ms"] - s["bound_ms"])
                           for s in r["shapes"].values() if launches(s)) for r in rows}
    order = sorted(rows, key=lambda r: (not slower(r), -loss[r["name"]]))
    return [(r["name"], loss[r["name"]], slower(r),
             r["bound_ms"] / r["ms"] >= 0.5 and not slower(r)) for r in order]


def path_inputs(config, dev):
    """(params, derived, cameras, sequence, frames on the card, IMU batches)
    of a preset over its PATH_FRAMES (else FRAMES) frames of its synthetic
    world: the stereo and
    mono presets on render_view at 752x480 (landmarks 6 m out), the fisheye
    preset on render_view_fisheye at 512x512 with its KB4 lens and field of
    view (landmarks 5 m out, as bench.py's fisheye world)."""
    import torch

    from hybvio_tpu_torch import runtime
    from hybvio_tpu_torch.io.synthetic import (
        SYNTH_IMU_TO_CAMERA, generate_sequence, render_view, render_view_fisheye,
    )
    from hybvio_tpu_torch.models import _finalize, synthetic_bench_params
    from hybvio_tpu_torch.odometry.backend import ImuBatch

    H, W = FRAME_HW[config]
    params, derived, cams = _finalize(synthetic_bench_params(config), W, H)
    pt = params.tracker
    seq = generate_sequence(duration=PATH_FRAMES.get(config, FRAMES) / 20.0, imu_rate=200.0,
                            frame_rate=20.0,
                            n_landmarks=500, landmark_radius=5.0 if config == "fisheye" else 6.0,
                            gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    F = len(seq.frame_times)
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -0.11
    f, cx, cy = pt.focalLength, pt.principalPointX, pt.principalPointY
    t0 = time.perf_counter()
    frames = []
    for fi in range(F):
        k = seq.frame_sample_idx[fi]
        if config == "fisheye":
            views = [render_view_fisheye(seq.landmarks, seq.pos[k], seq.quat[k],
                                         SYNTH_IMU_TO_CAMERA, f, f, cx, cy, W, H,
                                         pt.distortionCoeffs, max_fov_deg=pt.validCameraFov,
                                         blob_sigma=1.4)]
        else:
            views = [render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, f, f, cx, cy, W, H,
                                 blob_sigma=1.4)
                     for ext in ((SYNTH_IMU_TO_CAMERA, second) if pt.useStereo
                                 else (SYNTH_IMU_TO_CAMERA,))]
        views = tuple(torch.as_tensor(v).to(dev) for v in views)
        frames.append(views if pt.useStereo else views[0])
    say(f"{config}: rendered {F} frames of {W}x{H} ({len(cams)} camera"
        f"{'s' if len(cams) > 1 else ''}) in {time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(1)
    S = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    batches, prev = [], seq.frame_sample_idx[0] + 1
    fl = lambda x: torch.as_tensor(x, dtype=runtime.filter_dtype(dev), device=dev)
    for fi in range(1, F):
        k = seq.frame_sample_idx[fi] + 1
        n, pad = k - prev, S - (k - prev)
        t = np.pad(seq.times[prev:k], (0, pad), constant_values=seq.times[k - 1])
        g = np.pad(seq.gyro[prev:k], ((0, pad), (0, 0)))
        a = np.pad(seq.acc[prev:k], ((0, pad), (0, 0)))
        gB = np.stack([g + 1e-4 * rng.randn(*g.shape) for _ in range(B)])
        aB = np.stack([a + 1e-3 * rng.randn(*a.shape) for _ in range(B)])
        batches.append(ImuBatch(fl(np.tile(t, (B, 1))), fl(gB), fl(aB),
                                torch.as_tensor(np.tile(np.arange(S) < n, (B, 1)), device=dev)))
        prev = k
    return params, derived, cams, seq, frames, batches


def per_lane_inputs(dev, dtype=None, frames=FRAMES, lanes=None):
    """(params, derived, cameras, start time, ground truth (lanes, F - 1,
    3), frame(fi) -> (left, right) (lanes, H, W) views of frames rendered
    on the card, IMU batches) of the stereo preset over ``lanes`` (default
    B) distinct worlds, built as bench.py's seed-diverse leg builds them: lane b's
    sequence has seed 1000 + b and its radius, angular speed and z-wobble
    drawn from RandomState(7000 + b); 500 landmarks 6 m out, the IMU noise
    of path_inputs, no per-lane jitter beyond each lane's own noise. The IMU
    batches are of ``dtype`` (default: the port's filter dtype on ``dev``).
    Frames render B lanes a call, so lanes 0..B-1 of any ``lanes`` get the
    same frames."""
    import torch

    from hybvio_tpu_torch import runtime
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
    from hybvio_tpu_torch.io.synthetic_device import make_blob_renderer
    from hybvio_tpu_torch.models import _finalize, synthetic_bench_params
    from hybvio_tpu_torch.odometry.backend import ImuBatch

    H, W = FRAME_HW["stereo_per_lane"]
    params, derived, cams = _finalize(synthetic_bench_params("stereo"), W, H)
    pt = params.tracker
    lanes = B if lanes is None else lanes
    seqs = []
    for b in range(lanes):
        lane_rng = np.random.RandomState(7000 + b)
        seqs.append(generate_sequence(
            duration=frames / 20.0 + 0.25, imu_rate=200.0, frame_rate=20.0,
            radius=float(lane_rng.uniform(1.7, 2.3)),
            angular_speed=float(lane_rng.uniform(0.34, 0.46)),
            z_wobble=float(lane_rng.uniform(0.10, 0.20)), n_landmarks=500,
            landmark_radius=6.0, gyro_noise=5e-4, acc_noise=5e-3, seed=1000 + b))
    idx, times = seqs[0].frame_sample_idx[:frames], seqs[0].times  # one time grid for all
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -0.11
    f, cx, cy = pt.focalLength, pt.principalPointX, pt.principalPointY
    render = make_blob_renderer([SYNTH_IMU_TO_CAMERA, second], f, f, cx, cy, W, H,
                                blob_sigma=1.4, device=dev)
    landmarks = torch.as_tensor(np.stack([s.landmarks for s in seqs]), dtype=torch.float32,
                                device=dev)
    pos = torch.as_tensor(np.stack([s.pos[idx] for s in seqs], axis=1), dtype=torch.float32,
                          device=dev)  # (F, B, 3)
    quat = torch.as_tensor(np.stack([s.quat[idx] for s in seqs], axis=1), dtype=torch.float32,
                           device=dev)

    def frame(fi):
        out = torch.cat([render(landmarks[a:a + B], pos[fi, a:a + B], quat[fi, a:a + B])
                         for a in range(0, lanes, B)])  # (lanes, 2, H, W)
        return out[:, 0], out[:, 1]

    S = int(np.max(np.diff(np.concatenate([[0], idx + 1]))))
    batches, prev = [], idx[0] + 1
    dtype = runtime.filter_dtype(dev) if dtype is None else dtype
    fl = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    for fi in range(1, len(idx)):
        k = idx[fi] + 1
        n, pad = k - prev, S - (k - prev)
        t = np.pad(times[prev:k], (0, pad), constant_values=times[k - 1])
        gB = np.stack([np.pad(s.gyro[prev:k], ((0, pad), (0, 0))) for s in seqs])
        aB = np.stack([np.pad(s.acc[prev:k], ((0, pad), (0, 0))) for s in seqs])
        batches.append(ImuBatch(fl(np.tile(t, (lanes, 1))), fl(gB), fl(aB),
                                torch.as_tensor(np.tile(np.arange(S) < n, (lanes, 1)),
                                                device=dev)))
        prev = k
    gt = np.stack([s.pos[idx[1:]] - s.pos[0] for s in seqs])  # (lanes, F - 1, 3)
    return params, derived, cams, float(times[idx[0]]), gt, frame, batches


def host_syncs(step):
    """Run ``step()`` under torch.cuda.set_sync_debug_mode("warn"): (its
    result, the host syncs it made, counted by the Python line that made
    each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # The first set_sync_debug_mode of a process also warns that the mode
    # "is a prototype feature and does not yet detect all synchronizing
    # operations": that warning is no sync.
    lines = collections.Counter(
        f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message) and "prototype feature" not in str(w.message))
    return out, lines


def bit_diff(a, b):
    """(the leaves of two trees of tensors that are not bit-equal, the
    largest absolute difference among them; 0 and 0.0 when every leaf has
    the same dtype, shape and bits)."""
    import torch
    from torch.utils._pytree import tree_flatten

    xs, ys = tree_flatten(a)[0], tree_flatten(b)[0]
    if len(xs) != len(ys):
        return abs(len(xs) - len(ys)), float("inf")
    unequal, worst = 0, 0.0
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for x, y in zip(xs, ys):
        if not isinstance(x, torch.Tensor):
            unequal += int(x != y)
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            unequal, worst = unequal + 1, float("inf")
            continue
        if x.is_floating_point():
            view = bits[x.element_size()]
            if torch.equal(x.contiguous().view(view), y.contiguous().view(view)):
                continue
            d = (x.double() - y.double()).abs().nan_to_num(nan=float("inf"))
        elif torch.equal(x, y):
            continue
        else:
            d = (x.long() - y.long()).abs()
        unequal, worst = unequal + 1, max(worst, float(d.max()) if d.numel() else 0.0)
    return unequal, worst


def clone_tree(tree):
    import torch
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def graph_stats(graphs):
    """One line on CapturedSteps: captures (signatures), their seconds,
    replays, the launches a replay counts by kernel, the device's graph
    pool."""
    from hybvio_tpu_torch.graphs import graph_pool_bytes

    per = collections.Counter()
    for g in graphs:
        per.update(g.launches_per_replay())
    return (f"captures {sum(g.captures for g in graphs)} (signatures "
            f"{sum(g.keys for g in graphs)}) in {sum(g.capture_s for g in graphs):.2f} s, "
            f"replays {sum(g.replays for g in graphs)}, launches a replay "
            f"{json.dumps(dict(sorted(per.items())))}, the graph pool "
            f"{graph_pool_bytes('cuda:0') / 2**20:.1f} MiB")


def run_compiled(config, binit, bstep, first, start, images, batches, syncs):
    """Phase 13a, one path: COMPILED_STEPS steps from the init state (the
    first of phase 4's inputs), eager (``batched_step.eager``) and
    captured, in the order eager, captured, captured, eager: every state
    leaf and output of every step bit-equal with the first eager run's; no
    capture (phase 4 captured every signature); after each captured step
    of the first captured run, the state and output the step before
    returned unchanged; the init state unchanged by all of it. Prints the
    median step of each, the replays' launches (COMPILED_STEPS replays of
    one record), the path's captures, their seconds and the graph pool,
    and phase 4's host syncs of a replay step. Returns (launches, launches
    by input shape, 0)."""
    import torch

    from hybvio_tpu_torch import ops

    s0 = binit(first, np.full(B, start), np.arange(B))
    s0_copy = clone_tree(s0)
    graph = bstep.graphs[0]
    captures = graph.captures

    def chain(step, ref=None, own=False):
        st, trees, ms, diff, owned, kept = s0, [], [], (0, 0.0), (0, 0.0), None
        for k in range(COMPILED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, out = step(st, batches[k], images[k])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if ref is None:
                trees.append((st, out))
            else:
                n, d = bit_diff(ref[k], (st, out))
                diff = (diff[0] + n, max(diff[1], d))
            if own:
                if kept is not None:
                    n, d = bit_diff(*kept)
                    owned = (owned[0] + n, max(owned[1], d))
                kept = ((st, out), clone_tree((st, out)))
        return trees, ms, diff, owned

    ref, e1, _, _ = chain(bstep.eager)
    ops.reset_launch_counts()
    _, c1, d1, owned = chain(bstep, ref, own=True)
    torch.cuda.synchronize()
    launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
    _, c2, d2, _ = chain(bstep, ref)
    _, e2, d3, _ = chain(bstep.eager, ref)
    s0_diff = bit_diff(s0, s0_copy)
    unequal = d1[0] + d2[0] + d3[0]
    worst = max(d1[1], d2[1], d3[1])
    eager, captured = statistics.median(e1 + e2), statistics.median(c1 + c2)
    COMPILED[config] = dict(eager_ms=eager, captured_ms=captured, unequal=unequal, worst=worst,
                            captures=graph.captures, capture_s=graph.capture_s)
    say(f"compiled {config} (13a): {COMPILED_STEPS} steps from the init state, eager / captured "
        f"/ captured / eager: leaves not bit-equal with the first eager run {unequal} (max "
        f"difference {worst:.3g}); median step eager {eager:.2f} ms, captured {captured:.2f} ms "
        f"({eager / captured:.2f}x); steps (ms) eager {' '.join(f'{t:.1f}' for t in e1)} | "
        f"captured {' '.join(f'{t:.1f}' for t in c1)} | {' '.join(f'{t:.1f}' for t in c2)} | "
        f"eager {' '.join(f'{t:.1f}' for t in e2)}")
    say(f"compiled {config} (13a): {graph_stats(bstep.graphs)}; the replays' kernel launches "
        f"({COMPILED_STEPS} steps) {json.dumps(launches)}; leaves a later replay changed in a "
        f"returned state or output {owned[0]} (max {owned[1]:.3g}); the init state changed "
        f"{s0_diff[0]}; host syncs of a replay step (phase 4's step 2) {syncs}")
    if unequal:
        raise AssertionError(f"compiled {config}: the captured step parts from the eager one: "
                             f"{unequal} leaves, max difference {worst}")
    if owned[0] or s0_diff[0]:
        raise AssertionError(f"compiled {config}: a replay changed what a step returned "
                             f"({owned[0]} leaves) or the init state ({s0_diff[0]})")
    if graph.captures != captures:
        raise AssertionError(f"compiled {config}: {graph.captures - captures} new captures in "
                             f"13a (a signature phase 4 did not capture)")
    per_replay = graph.launches_per_replay()
    wrong = {k: (launches[k], per_replay.get(k, 0)) for k in launches
             if launches[k] != COMPILED_STEPS * per_replay.get(k, 0)}
    if wrong:
        raise AssertionError(f"compiled {config}: replay launches (counted, a replay's record) "
                             f"{wrong}")
    check_path_kernels(f"compiled {config}", launches)
    return launches, by_shape, 0


def run_path(dev, config):
    """Phase 4, one path: the batched step of a preset at full width on the
    card; (launches, launches by input shape, host syncs of one step)."""
    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.parallel.batched import make_batched_vio

    H, W = FRAME_HW[config]
    dtype = getattr(torch, FILTER_DTYPE[config]) if config in FILTER_DTYPE else None
    if config in PER_LANE_PATHS:
        t0 = time.perf_counter()
        params, derived, cams, start, gt, frame, batches = per_lane_inputs(
            dev, dtype, PATH_FRAMES.get(config, FRAMES))
        if config == "stereo_sequential_hybrid":
            for k, v in SEQUENTIAL_HYBRID.items():
                setattr(params.odometry, k, v)
        F = len(batches) + 1
        first = frame(0)
        if not (first[0][0] - first[0][1]).abs().max() > 0:
            raise AssertionError(f"{config}: lanes 0 and 1 got the same frame")
        torch.cuda.synchronize()
        say(f"{config}: {B} distinct worlds, frames of {W}x{H} (2 cameras) rendered on the card "
            f"each step; set-up {time.perf_counter() - t0:.1f} s; lanes 0 and 1 differ by "
            f"{float((first[0][0] - first[0][1]).abs().max()):.3f} at most")
        shared = False
    else:
        params, derived, cams, seq, frames, batches = path_inputs(config, dev)
        F = len(frames)
        frame, first, start = frames.__getitem__, frames[0], float(seq.frame_times[0])
        gt = np.stack([seq.pos[seq.frame_sample_idx[1:F]] - seq.pos[0]] * B)
        shared = True
    binit, bstep, _ = make_batched_vio(params, derived, cams, batch_size=B,
                                       shared_frames=shared, device=dev, dtype=dtype)
    ops.reset_launch_counts()
    states = binit(first, np.full(B, start), np.arange(B))
    positions, step_ms, hybrid_points = [], [], []
    for fi in range(1, F):
        images = frame(fi)  # per lane: rendered here, outside the timed step
        torch.cuda.synchronize()
        ts = time.perf_counter()
        if fi == 2:  # the host syncs of one step, a replay (not timed: the warnings cost time)
            captures = bstep.graphs[0].captures
            (states, out), syncs = host_syncs(lambda: bstep(states, batches[fi - 1], images))
            if bstep.graphs[0].captures != captures:
                raise AssertionError(f"{config}: step 2 captured a signature step 1 did not")
        else:
            states, out = bstep(states, batches[fi - 1], images)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - ts))
        positions.append(out.position)
        hybrid_points.append(torch.sum(out.point_cloud_status == PF_HYBRID))
    launches = dict(ops.LAUNCHES)
    by_shape = dict(ops.SHAPE_LAUNCHES)
    compiled = run_compiled(config, binit, bstep, first, start,
                            [frame(fi) for fi in range(1, COMPILED_STEPS + 1)], batches,
                            sum(syncs.values()))
    claimed = int(torch.sum(states.backend.trail.map_point_ids >= 0))
    hybrid = int(torch.stack(hybrid_points).sum())

    est = torch.stack(positions).cpu().numpy()  # (F-1, B, 3)
    if est.shape != (F - 1, B, 3):
        raise AssertionError(f"{config}: positions of shape {est.shape}")
    PATH_POSITIONS[config] = est
    if config == "stereo":  # phase 12b scans the same inputs
        STEREO_INPUTS.update(params=params, derived=derived, cams=cams, start=start,
                             frames=frames, batches=batches)
    finite = [b for b in range(B) if np.isfinite(est[:, b]).all()]
    ates = [float(ate_rmse(est[:, b], gt[b])) for b in finite]
    timed = step_ms[2:]  # the first step is the warm-up, the second counted the syncs
    med = statistics.median(timed)
    PATH_MEDIAN_MS[config] = med
    fps = B * len(timed) / (sum(timed) / 1000.0)
    ate_med = float(np.median(ates)) if ates else float("nan")
    ate_p90 = float(np.percentile(ates, 90)) if ates else float("nan")
    say(f"{config}: B={B} {W}x{H}, {FILTER_DTYPE.get(config, 'float32')} filter, {F - 1} "
        f"steps of the captured step (median and frames/s over the last {len(timed)}, "
        f"replays): median step {med:.2f} ms, aggregate {fps:.1f} frames/s, step 1 (the eager "
        f"warm-up and the capture) {step_ms[0]:.1f} ms")
    say(f"{config}: finite lanes {len(finite)}/{B}, ATE median {ate_med:.4f} m, p90 "
        f"{ate_p90:.4f} m (max {max(ates) if ates else float('nan'):.4f} m); per lane "
        + " ".join(f"{a:.4f}" for a in ates))
    say(f"{config}: host syncs in one step (step 2): {sum(syncs.values())} "
        f"{json.dumps(dict(sorted(syncs.items())))}")
    say(f"{config}: kernel launches {json.dumps(launches)}")
    say(f"{config}: kernel launches by input shape " + json.dumps(
        {f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
    M = params.odometry.hybridMapSize
    if M:
        lanes = int(torch.sum(torch.any(states.backend.trail.map_point_ids >= 0, dim=1)))
        say(f"{config}: hybrid map of {M} points a lane: {claimed} of the {B * M} slots claimed "
            f"at the end, {lanes}/{B} lanes with a claimed slot; {hybrid} map-point updates "
            f"(PF_HYBRID points) in the run")
    if len(finite) != B:
        raise AssertionError(f"{config}: only {len(finite)}/{B} lanes finite")
    if not ate_med <= ATE_LIMIT_M:
        raise AssertionError(f"{config}: ATE median {ate_med} m > {ATE_LIMIT_M} m")
    if M and not (claimed and hybrid):
        raise AssertionError(f"{config}: the hybrid map did not run: {claimed} slots claimed, "
                             f"{hybrid} PF_HYBRID points")
    check_path_kernels(config, launches)
    return (launches, by_shape, sum(syncs.values())), compiled


def check_path_kernels(config, launches):
    """Fail unless the path launched each of the four kernels every path
    runs and a port kernel of every Pallas kernel."""
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"{config}: kernels not launched: {missing}")
    ports = {}  # Pallas kernel -> the port kernels that replace it
    for name, (_, replaces) in KERNELS.items():
        for ref in replaces.split(", "):
            ports.setdefault(ref, []).append(name)
    never = [ref for ref, names in ports.items() if not any(launches[n] for n in names)]
    if never:
        raise AssertionError(f"{config}: Pallas kernels with no port kernel launched: {never}")


def run_options(dev):
    """The options phase: each estimator option of OPTIONS on top of the
    sequential update with the hybrid map, in its filter dtype,
    OPTION_STEPS steps of the per-lane stereo input at B lanes (or, with
    shared frames, lane 0's frames and IMU for every lane). Fails on a
    non-finite lane or a host sync in a step; returns the syncs by
    option."""
    import copy

    import torch

    from hybvio_tpu_torch.odometry.backend import ImuBatch
    from hybvio_tpu_torch.parallel.batched import make_batched_vio

    from hybvio_tpu_torch.eval.ate import ate_rmse

    base, derived, cams, start, gt, frame, batches = per_lane_inputs(dev, torch.float64)
    lane0 = lambda x: x[:1].expand_as(x).contiguous()
    syncs_by_option = {}
    for name, settings, shared, dtype, steps in OPTIONS:
        dtype = getattr(torch, dtype)
        params = copy.deepcopy(base)
        for k, v in {**SEQUENTIAL_HYBRID, **settings}.items():
            setattr(params.odometry, k, v)
        binit, bstep, _ = make_batched_vio(params, derived, cams, batch_size=B,
                                           shared_frames=shared, device=dev, dtype=dtype)
        images = (lambda fi: tuple(im[0] for im in frame(fi))) if shared else frame
        states = binit(images(0), np.full(B, start), np.arange(B))
        positions, t0 = [], time.perf_counter()
        for fi in range(1, steps + 1):
            imu = ImuBatch(*(x.to(dtype) if x.is_floating_point() else x for x in batches[fi - 1]))
            imu = ImuBatch(*map(lane0, imu)) if shared else imu
            im = images(fi)  # rendered outside the step
            step = lambda: bstep(states, imu, im)
            if fi == 2:
                (states, out), syncs = host_syncs(step)
            else:
                states, out = step()
            positions.append(out.position)
        torch.cuda.synchronize()
        est = torch.stack(positions).double().cpu().numpy()  # (steps, B, 3)
        finite = int(np.isfinite(est).all(axis=(0, 2)).sum())
        # ATE against each lane's ground truth (lane 0's with shared frames)
        ates = [float(ate_rmse(est[:, b], gt[0 if shared else b][:steps]))
                for b in range(B) if np.isfinite(est[:, b]).all()]
        syncs_by_option[name] = sum(syncs.values())
        say(f"option {name}: {steps} steps ({'shared' if shared else 'per-lane'} frames, "
            f"{str(dtype)[6:]} filter) in {time.perf_counter() - t0:.1f} s, finite lanes "
            f"{finite}/{B}, host syncs in step 2: {syncs_by_option[name]} "
            f"{json.dumps(dict(sorted(syncs.items())))}; ATE median "
            f"{statistics.median(ates) if ates else float('nan'):.4f} m, max "
            f"{max(ates, default=float('nan')):.4f} m; per lane " + " ".join(f"{a:.4f}" for a in ates))
        if finite != B:
            raise AssertionError(f"option {name}: only {finite}/{B} lanes finite")
    return syncs_by_option


def write_api_dataset(out_dir, config, frames):
    """A dataset in the reference's JSONL format (data.jsonl with the
    cameras' imuToCamera lines, gyroscope and accelerometer samples, frames
    with their cameraParameters, ground truth; frame_*_cam*.npy) of
    ``frames`` frames: the world and seed of the stereo path (path_inputs:
    200 Hz IMU, 20 frames/s, 500 landmarks 6 m out), seen at 752x480 by the
    cameras of the EuRoC-like presets (models.euroc_mono / euroc_stereo:
    f = 458, the principal point at the centre; the second camera 0.11 m
    along -x), and the parameters.txt of tools/make_synthetic_dataset.py."""
    import os

    from hybvio_tpu_torch.io.jsonl import Recorder
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence, render_view
    from hybvio_tpu_torch.models import euroc_mono, euroc_stereo

    H, W = FRAME_HW[config]
    _, _, cams = (euroc_stereo if config == "stereo" else euroc_mono)(W, H)
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -0.11
    exts = (SYNTH_IMU_TO_CAMERA, second)[:len(cams)]
    seq = generate_sequence(duration=frames / 20.0, imu_rate=200.0, frame_rate=20.0,
                            n_landmarks=500, landmark_radius=6.0, gyro_noise=5e-4,
                            acc_noise=5e-3, seed=0)
    rec = Recorder(out_dir)
    for ci, ext in enumerate(exts):
        rec.f.write(json.dumps({"imuToCamera": [list(r) for r in np.asarray(ext)],
                                "cameraInd": ci}) + "\n")
    with open(os.path.join(out_dir, "parameters.txt"), "w") as pf:
        pf.write("ransac2Threshold 8.0;\nransac5Threshold 4.0;\nvisualR 0.5;\n")
    frame_set = set(seq.frame_sample_idx.tolist())
    for k in range(len(seq.times)):
        t = float(seq.times[k])
        rec.gyro(t, seq.gyro[k])
        rec.acc(t, seq.acc[k])
        if k in frame_set:
            views = [render_view(seq.landmarks, seq.pos[k], seq.quat[k], ext, c.fx, c.fy, c.cx,
                                 c.cy, W, H, blob_sigma=1.4) for ext, c in zip(exts, cams)]
            rec.frame(t, views, [{"focalLengthX": c.fx, "focalLengthY": c.fy,
                                  "principalPointX": c.cx, "principalPointY": c.cy}
                                 for c in cams])
            rec.ground_truth(t, seq.pos[k], seq.quat[k])
    rec.close()
    return rec.frame_count


def run_cli(dev, config, dataset, out_path, frames, timer=False, extra=(), jit=True):
    """Phase 7, one run of the port's CLI ``run()`` in-process on the card
    at the reference's defaults (stereo with -useStereo), with -maxFrames
    and -outputJsonExtras (and -timer): (launches, launches by input shape,
    host syncs of step API_SYNC_STEP by line (None with -timer), wall
    seconds of each frame step, its standard error, the host modules that
    ran: {"sync": the API's synchronizer class, "reader": the JSONL
    reader}). A frame's wall time is that of the API's
    ``_process_frame``: queueing its step and retiring the frame before it
    (which waits for that frame's work on the card); the host syncs are
    those of ``_step_frame`` (the step without the retirement), with the
    SLAM worker (``extra`` -useSlam) drained first: its own syncs are off
    the step; ``impl["api"]`` is the API, ``impl["captured"]`` whether the
    counted step captured a graph. ``jit=False`` builds the API with
    ``jit=False`` (the CLI passes none, as the reference's)."""
    import contextlib
    import io

    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.cli.main import run
    from hybvio_tpu_torch.io import jsonl

    argv = [f"-i={dataset}", f"-o={out_path}", f"-maxFrames={frames}", "-outputJsonExtras"]
    argv += (["-useStereo"] if config == "stereo" else []) + (["-timer"] if timer else [])
    argv += list(extra)
    process, step, read = VioApi._process_frame, VioApi._step_frame, jsonl.read_jsonl_events
    from hybvio_tpu_torch.utils.timer import TimeStats

    init, scope = VioApi.__init__, TimeStats.scope
    wall, counted, impl = [], {}, {"stages": collections.defaultdict(list)}

    @contextlib.contextmanager
    def sampled_scope(self, name, probe=None):  # each -timer sample, for the split without
        t0 = time.perf_counter()                # the frame that captured
        with scope(self, name, probe):
            yield
        impl["stages"][name].append(time.perf_counter() - t0)

    def eager_init(self, *a, **k):
        init(self, *a, **{**k, "jit": False})

    def reader(path):
        events = read(path)
        impl["reader"] = events.reader
        return events

    def timed_process(self, synced):
        impl["sync"], impl["api"] = type(self.sample_sync).__name__, self
        stepped = self._state is not None
        t0 = time.perf_counter()
        process(self, synced)
        if stepped:
            wall.append(time.perf_counter() - t0)

    def counted_step(self, *args):
        if not timer and len(wall) == API_SYNC_STEP and "syncs" not in counted:
            if self.slam is not None:
                self.slam.wait_idle()
            captures = getattr(self._step, "captures", 0)
            counted["syncs"] = host_syncs(lambda: step(self, *args))[1]
            impl["captured"] = getattr(self._step, "captures", 0) != captures
        else:
            step(self, *args)

    err = io.StringIO()
    VioApi._process_frame, VioApi._step_frame = timed_process, counted_step
    TimeStats.scope = sampled_scope
    if not jit:
        VioApi.__init__ = eager_init
    jsonl.read_jsonl_events = reader
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with contextlib.redirect_stderr(err):
            rc = run(argv, device=dev)
        torch.cuda.synchronize()
        launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
    finally:
        VioApi._process_frame, VioApi._step_frame = process, step
        VioApi.__init__, TimeStats.scope = init, scope
        jsonl.read_jsonl_events = read
    if rc != 0:
        raise RuntimeError(f"the CLI exited with {rc}: {err.getvalue()[-2000:]}")
    if not timer and "syncs" not in counted:
        raise AssertionError(f"cli {config}: step {API_SYNC_STEP} was never run")
    return launches, by_shape, counted.get("syncs"), wall, err.getvalue(), impl


def run_api_paths(dev):
    """Phase 7, the host entry point: for mono and stereo, a dataset in the
    reference's format (write_api_dataset), the port's CLI over its
    API_FRAMES frames and then over API_TIMER_FRAMES with -timer (run_cli).
    Prints frames in, outputs out, per-frame wall time (median, p90 and the
    first step), frames/s, ATE against the dataset's ground truth (the
    outputs' positions against the ground truth at their times, aligned),
    launches, the host syncs of one step and the -timer stage table. Fails
    on a non-finite output, fewer outputs than frames - 3 (the first frame
    initializes, and the synchronizer holds the last two back at the end of
    the input, as the reference's does), an ATE over ATE_LIMIT_M, a path
    kernel not launched or a host sync in a step. Returns {path: (launches,
    launches by shape, host syncs)}."""
    import os
    import shutil
    import tempfile

    from hybvio_tpu_torch.eval.ate import ate_rmse

    runs = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")  # the kernels' too
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_api_", dir=build)
    try:
        for config in API_CONFIGS:
            t0 = time.perf_counter()
            ds = f"{tmp}/{config}"
            n_written = write_api_dataset(ds, config, API_FRAMES)
            gt = [json.loads(l) for l in open(f"{ds}/data.jsonl") if "groundTruth" in l]
            gt_t = np.array([j["time"] for j in gt])
            gt_p = np.array([[j["groundTruth"]["position"][a] for a in "xyz"] for j in gt])
            H, W = FRAME_HW[config]
            say(f"cli {config}: wrote a {n_written}-frame dataset ({W}x{H}, "
                f"{2 if config == 'stereo' else 1} camera(s)) in {time.perf_counter() - t0:.1f} s")
            for timer, jit in ((False, True), (True, True), (False, False)):
                frames = API_TIMER_FRAMES if timer else API_FRAMES
                name = f"api_{config}{'_timer' if timer else ''}{'' if jit else '_eager'}"
                out_path = f"{tmp}/{name}.jsonl"
                t0 = time.perf_counter()
                launches, by_shape, syncs, wall, err, impl = run_cli(dev, config, ds, out_path,
                                                                     frames, timer, jit=jit)
                secs = time.perf_counter() - t0
                lines = [json.loads(l) for l in open(out_path)]
                est = np.array([[j["position"][a] for a in "xyz"] for j in lines])
                t_out = np.array([j["time"] for j in lines])
                floats = np.array([[*j["position"].values(), *j["orientation"].values(),
                                    *j["velocity"].values(),
                                    *np.ravel(j["positionCovariance"])] for j in lines])
                finite = bool(len(lines)) and bool(np.isfinite(floats).all())
                gt_i = np.stack([np.interp(t_out, gt_t, gt_p[:, a]) for a in range(3)], axis=1)
                ate = float(ate_rmse(est, gt_i)) if finite and len(lines) >= 3 else float("nan")
                # the first step is the warm-up; the counted step runs under the sync check
                steady = [w for i, w in enumerate(wall) if i not in (0, API_SYNC_STEP)]
                med = 1e3 * statistics.median(steady)
                p90 = 1e3 * float(np.percentile(steady, 90))
                statuses = [j["status"] for j in lines]
                say(f"cli {name}: {frames} frames in, {len(lines)} outputs out in {secs:.1f} s; "
                    f"per-frame wall time at B=1: median {med:.2f} ms, p90 {p90:.2f} ms, first "
                    f"step {1e3 * wall[0]:.1f} ms, {len(steady) / sum(steady):.2f} frames/s over "
                    f"{len(steady)} steps; ATE {ate:.4f} m over {len(lines)} outputs; statuses "
                    f"{dict(sorted(collections.Counter(statuses).items()))}; the {impl.get('reader')} "
                    f"JSONL reader, the synchronizer {impl.get('sync')}")
                if not timer and jit:
                    PHASE7_WALL[config] = (med, p90)
                check_native_host(f"cli {name}", impl)
                api = impl["api"]
                if jit:  # 13c: the API's graphs
                    graphs = [api._step, api._imu_only, api._track_stage, api._backend_stage]
                    say(f"cli {name} (13c): the step's graph: captures {api._step.captures}, "
                        f"replays {api._step.replays}; IMU-only {api._imu_only.captures} / "
                        f"{api._imu_only.replays}, track_stage {api._track_stage.captures} / "
                        f"{api._track_stage.replays}, backend_stage "
                        f"{api._backend_stage.captures} / {api._backend_stage.replays} "
                        f"(captures / replays); all: {graph_stats(graphs)}; the counted step "
                        + ("captured: its syncs are the capture's" if impl.get("captured")
                           else "replayed"))
                    if not timer and impl.get("captured"):
                        raise AssertionError(f"cli {name}: step {API_SYNC_STEP} captured a graph")
                else:  # 13c: against the captured run over the same frames
                    ref = [json.loads(l) for l in open(f"{tmp}/api_{config}.jsonl")]
                    pos = lambda ls: np.array([[j["position"][a] for a in "xyz"] for j in ls])
                    diff = (float(np.abs(pos(ref) - est).max()) if len(ref) == len(lines)
                            else float("inf"))
                    COMPILED[f"api_{config}"] = dict(
                        diff=diff, eager=(med, p90), captured=PHASE7_WALL[config])
                    say(f"cli {name} (13c): VioApi(jit=False) against jit=True over the same "
                        f"{frames} frames: {len(lines)} / {len(ref)} outputs, max position "
                        f"difference {diff:.3g} m; per-frame median {med:.2f} ms eager against "
                        f"{PHASE7_WALL[config][0]:.2f} ms captured (p90 {p90:.2f} / "
                        f"{PHASE7_WALL[config][1]:.2f} ms)")
                    if diff != 0.0:
                        raise AssertionError(f"cli {name}: positions part from the captured "
                                             f"run by {diff} m")
                say(f"cli {name}: host syncs in step {API_SYNC_STEP} (the retirement excluded): "
                    + ("not counted: the -timer stages wait on the card by design" if timer else
                       f"{sum(syncs.values())} {json.dumps(dict(sorted(syncs.items())))}")
                    + f"; kernel launches {json.dumps(launches)}")
                say(f"cli {name}: kernel launches by input shape " + json.dumps(
                    {f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
                if timer:
                    table = err[err.index("--- per-frame timings"):].strip().splitlines()
                    for line in table:
                        say(f"cli {name} -timer: {line.strip()}")
                    stages = {k: v for k, v in impl["stages"].items() if len(v) > 1}
                    say(f"cli {name} -timer (13c): each stage's median over its frames after "
                        f"the first (which captured its graph; the table above averages it in): "
                        + ", ".join(f"{k} {1e3 * statistics.median(v[1:]):.3f} ms"
                                    for k, v in sorted(stages.items())))
                if not finite:
                    raise AssertionError(f"cli {name}: a non-finite output")
                if len(lines) < frames - 3:
                    raise AssertionError(f"cli {name}: {len(lines)} outputs for {frames} frames")
                if not ate <= ATE_LIMIT_M:
                    raise AssertionError(f"cli {name}: ATE {ate} m > {ATE_LIMIT_M} m")
                missing = [k for k in PATH_KERNELS if not launches[k]]
                if missing:
                    raise AssertionError(f"cli {name}: kernels not launched: {missing}")
                runs[name] = (launches, by_shape, 0 if timer else sum(syncs.values()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def _cam_pose_cw(pos, yaw):
    """tests/test_slam.py's camera-to-world pose: the camera at pos looking
    along (cos yaw, sin yaw, 0), its y axis along world +z."""
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[-s, 0.0, c], [c, 0.0, s], [0.0, 1.0, 0.0]])
    T[:3, 3] = pos
    return T


def _project_to_norm(T, pts):
    pc = (pts - T[:3, 3]) @ T[:3, :3]
    ok = pc[:, 2] > 0.3
    return pc[:, :2] / np.where(ok, pc[:, 2], 1.0)[:, None], ok


def _box_frame(T, landmarks):
    """tests/test_slam.py's 240x320 frame: flat 0.3 with a 5x5 box (+0.5 or
    -0.2) at each visible landmark."""
    ip, ok = _project_to_norm(T, landmarks)
    px = ip * 260.0 + np.array([160.0, 120.0])
    img = np.zeros((240, 320), np.float32) + 0.3
    for i in np.where(ok)[0]:
        u, v = px[i]
        if 8 <= u < 312 and 8 <= v < 232:
            iu, iv = int(u), int(v)
            img[max(iv - 2, 0):iv + 3, max(iu - 2, 0):iu + 3] += 0.5 if i % 2 == 0 else -0.2
    return ip, ok, np.clip(img, 0, 1)


def slam_scenarios():
    """Phase 8a's inputs: [(name, parameter settings, Slam keywords, frames
    (image, T_cw, track ids, normalized points, t, frame number), run
    end())], tests/test_slam.py's and tests/test_slam_global.py's."""
    every = {"keyframeDecisionMinIntervalSeconds": 0.0, "keyframeDecisionDistanceThreshold": 0.01}

    def straight(n, n_lm, seed, step, noise=0.0):
        rng = np.random.RandomState(seed)
        lm = np.stack([4.0 + rng.rand(n_lm) * 2, rng.randn(n_lm) * 2, rng.randn(n_lm)], axis=1)
        out = []
        for k in range(n):
            T = _cam_pose_cw(np.array([0.0, k * step, 0.0]), 0.0)
            ip, ok = _project_to_norm(T, lm)
            T_odo = T.copy()
            if noise:
                T_odo[:3, 3] += rng.randn(3) * noise
                ip = ip + rng.randn(*ip.shape) * 5e-4
            ids = np.where(ok, np.arange(n_lm), -1).astype(np.int32)
            out.append((None, T_odo, ids[ok], ip[ok], float(k), k))
        return out

    def revisit():
        rng = np.random.RandomState(2)
        lm = np.stack([5.0 + rng.rand(50), rng.randn(50) * 2, rng.randn(50)], axis=1)
        out = []
        for k, y in enumerate((0.0, 0.4, 0.8, 1.2, 0.8, 0.4, 0.02)):
            T = _cam_pose_cw(np.array([0.0, y, 0.0]), 0.0)
            ip, ok, img = _box_frame(T, lm)
            ids = np.where(ok, np.arange(50) + (1000 * k if k >= 4 else 0), -1).astype(np.int32)
            out.append((img, T, ids[ok], ip[ok], float(k), k))
        return out

    def global_revisit():
        rng = np.random.RandomState(11)
        lm = np.stack([6.0 + rng.rand(60), rng.randn(60) * 2.5, rng.randn(60)], axis=1)
        out, k = [], 0
        for lap in range(2):
            for y in (0.0, 0.35, 0.7, 1.05, 1.4, 1.05, 0.7, 0.35):
                T = _cam_pose_cw(np.array([0.0, y, 0.0]), 0.0)
                ip, ok, img = _box_frame(T, lm)
                T_drift = T.copy()
                T_drift[0, 3] += 0.05 * k
                ids = np.where(ok, np.arange(60) + 10000 * lap, -1).astype(np.int32)
                out.append((img, T_drift, ids[ok], ip[ok], float(k), k))
                k += 1
        return out

    loops = {**every, "adjacentSpaceSize": 3, "minLoopClosureFeatureMatches": 4}
    applied = {**every, "adjacentSpaceSize": 4, "minLoopClosureFeatureMatches": 4,
               "loopClosureRansacMinInliers": 4, "applyLoopClosures": True,
               "applyLocalBundleAdjustment": False, "maximumDriftMetersPerSecond": 1.0,
               "maximumDriftMetersPerTraveled": 1.0, "keyframeCullEnabled": False}
    return [("keyframes and map", every, dict(max_ba_keyframes=8, compute_descriptors=False),
             straight(6, 60, 0, 0.3), False),
            ("BA on noisy odometry", every, dict(max_ba_keyframes=10, compute_descriptors=False),
             straight(8, 80, 1, 0.25, noise=0.01), False),
            ("revisit", loops, dict(max_ba_keyframes=8), revisit(), False),
            ("applied loops", applied, {}, global_revisit(), True)]


def loop_events(s):
    return [(e.kf_id, e.matched_kf_id, e.n_matches, e.applied) for e in s.loop_events]


def session_diff(card, cpu):
    """(the same keyframe ids, map-point ids, track aliases and loop
    events, max keyframe pose difference, max map point difference) of two
    sessions over the same frames (the differences NaN unless the ids
    match)."""
    same = (card.kf_order == cpu.kf_order and sorted(card.points) == sorted(cpu.points)
            and card.track_to_point == cpu.track_to_point
            and loop_events(card) == loop_events(cpu))
    pose_err = max(float(np.abs(card.keyframes[k].pose - cpu.keyframes[k].pose).max())
                   for k in cpu.kf_order) if same else float("nan")
    point_err = max([float(np.abs(card.points[i].position - cpu.points[i].position).max())
                     for i in cpu.points] or [0.0]) if same else float("nan")
    return same, pose_err, point_err


def run_slam_sessions(dev):
    """Phase 8a: each scenario of slam_scenarios through a Slam session on
    the card and one on the CPU in this process, frame by frame: the same
    keyframe ids, map-point ids, track aliases and loop events, keyframe
    poses and map points within SLAM_POSE_TOL. Fails on a mismatch or on no
    loop event on the card in the revisits."""
    import torch

    from hybvio_tpu_torch.config import Parameters
    from hybvio_tpu_torch.slam.session import Slam

    for name, settings, kw, frames, end in slam_scenarios():
        runs = []
        for d in (dev, torch.device("cpu")):
            p = Parameters()
            for k, v in settings.items():
                setattr(p.slam, k, v)
            s, per_frame = Slam(p, device=d, **kw), []
            for img, T, ids, ip, t, k in frames:
                t0 = time.perf_counter()
                s.add_frame(img, T, ids, ip, t=t, frame_num=k)
                per_frame.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            if end:
                s.end()
            runs.append((s, per_frame, time.perf_counter() - t0))
        (card, card_s, card_end), (cpu, cpu_s, cpu_end) = runs
        SLAM_SESSIONS[name] = (card, cpu)
        same, pose_err, point_err = session_diff(card, cpu)
        say(f"slam session {name}: {len(frames)} frames, card {1e3 * sum(card_s):.1f} ms "
            f"(per frame median {1e3 * statistics.median(card_s):.1f} ms, first "
            f"{1e3 * card_s[0]:.1f} ms), CPU {1e3 * sum(cpu_s):.1f} ms"
            + (f"; end() card {card_end:.3f} s, CPU {cpu_end:.3f} s" if end else "")
            + f"; keyframes {card.kf_order}, {len(card.points)} map points, loop events "
            f"{loop_events(card)}, loop edges {len(card.loop_edges)}; card vs CPU: ids "
            f"{'equal' if same else 'DIFFER'}, max pose diff {pose_err:.3g}, max point diff "
            f"{point_err:.3g} (tol {SLAM_POSE_TOL}); the card's programs (14): "
            + program_line(card.graph_pools.programs))
        if not same:
            raise AssertionError(f"slam session {name}: the card's ids or loop events differ "
                                 f"from the CPU's: keyframes {card.kf_order} / {cpu.kf_order}, "
                                 f"{len(card.points)} / {len(cpu.points)} points, loop events "
                                 f"{loop_events(card)} / {loop_events(cpu)}")
        if not (pose_err <= SLAM_POSE_TOL and point_err <= SLAM_POSE_TOL):
            raise AssertionError(f"slam session {name}: poses part by {pose_err}, points by "
                                 f"{point_err} > {SLAM_POSE_TOL}")
        if frames[0][0] is not None and not card.loop_events:
            raise AssertionError(f"slam session {name}: no loop event on the card")


def check_native_host(where, impl):
    """Fail unless the native synchronizer and the native JSONL reader ran
    (``impl`` as run_cli returns it): the host's g++ builds them, and a
    run that fell back to the Python modules is not the reference's
    default path."""
    if impl.get("sync") != "NativeSampleSync" or impl.get("reader") != "native":
        from hybvio_tpu_torch.utils import native

        raise AssertionError(f"{where}: the host modules fell back ({impl}): "
                             f"{native.unavailable_reason()}")


@contextlib.contextmanager
def torch_detector():
    """The SLAM session on its torch keypoint detector (HYBVIO_NATIVE_ORB=0,
    the reference's switch) inside the block: phases 8a and 8b hold the
    torch detector on the card, phase 11d the native one beside it."""
    old = os.environ.get("HYBVIO_NATIVE_ORB")
    os.environ["HYBVIO_NATIVE_ORB"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["HYBVIO_NATIVE_ORB"]
        else:
            os.environ["HYBVIO_NATIVE_ORB"] = old


def _slam_table():
    """The SLAM worker's per-keyframe stage table (utils.timer
    SLAM_TIME_STATS), in the session's order: [(label, ms per keyframe,
    calls)]."""
    from hybvio_tpu_torch.utils import timer

    ts = timer.SLAM_TIME_STATS
    ms = ts.per_frame_timings()
    return [(k, ms[k], ts.counts[k]) for k in timer.SLAM_STAGES if k in ms]


def run_vislam(dev, name="vislam", frames_in=VISLAM_FRAMES, publisher=None, vis_dir=None,
               watch=False):
    """Phase 8b: VioApi on synthetic_bench_params("vislam") (bench.py's
    run_vislam on the port): stereo 752x480 at one lane with the SLAM
    session on its worker thread, fed the stereo path's world (path_inputs'
    sequence) rendered on the card beforehand, IMU sample by sample. Prints
    per-frame wall time, frames/s after the first two frames, the finish()
    teardown, the SLAM session's keyframes, map points, loop events, dropped
    candidates and BA runs, the ATE of the SLAM-corrected outputs, the SLAM
    stage table per keyframe, the host syncs of step VISLAM_SYNC_STEP (the
    SLAM worker drained first) and the launches by shape. Phase 11 runs it
    again as ``name`` over ``frames_in`` frames, with a debug ``publisher``
    on the API (11c) or the SLAM viewers writing under ``vis_dir`` after
    each output, as the CLI does (11d). With ``watch`` (phase 14b) every
    step after step VISLAM_SYNC_STEP runs under the sync check too, the
    syncs of this thread counted (the worker's own are not), and the steps
    during which the SLAM worker was busy are counted. Keeps its numbers in
    VISLAM_STATS[name]; returns (launches, launches by shape, host
    syncs)."""
    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
    from hybvio_tpu_torch.io.synthetic_device import make_blob_renderer
    from hybvio_tpu_torch.models import synthetic_bench_params
    from hybvio_tpu_torch.utils import timer

    params = synthetic_bench_params("vislam")
    pt = params.tracker
    W, H = int(2 * pt.principalPointX), int(2 * pt.principalPointY)
    seq = generate_sequence(duration=frames_in / 20.0, imu_rate=200.0, frame_rate=20.0,
                            n_landmarks=500, landmark_radius=6.0, gyro_noise=5e-4,
                            acc_noise=5e-3, seed=0)
    F = min(frames_in, len(seq.frame_sample_idx))
    second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
    second[0, 3] = -0.11
    f, cx, cy = pt.focalLength, pt.principalPointX, pt.principalPointY
    t0 = time.perf_counter()
    render = make_blob_renderer([SYNTH_IMU_TO_CAMERA, second], f, f, cx, cy, W, H,
                                blob_sigma=1.4, device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    frames = [render(f32(seq.landmarks[None]), f32(seq.pos[k][None]), f32(seq.quat[k][None]))[0]
              for k in seq.frame_sample_idx[:F]]  # each (2, H, W) on the card
    torch.cuda.synchronize()
    say(f"{name}: rendered {F} stereo frames of {W}x{H} on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    api = VioApi(params, W, H, device=dev)
    ba_runs, ba_program, ba_calls = [0], api.slam.slam._ba_program, []

    def counted_ba(*a, **k):  # each local BA call: how it ran, ms to its result on the host
        ba_runs[0] += 1
        before = (ba_program.captures, ba_program.replays)
        t0 = time.perf_counter()
        out = ba_program(*a, **k)
        torch.cuda.current_stream().synchronize()
        kind = ("capture" if ba_program.captures > before[0] else
                "replay" if ba_program.replays > before[1] else "eager")
        ba_calls.append((kind, 1e3 * (time.perf_counter() - t0)))
        return out

    api.slam.slam._ba_program = counted_ba
    outputs, wall, counted = [], [], {}
    api.on_output = outputs.append
    if publisher is not None:
        from hybvio_tpu_torch.odometry.debug import DebugAPI

        api.debug_api = DebugAPI(publisher)
    if vis_dir is not None:
        from hybvio_tpu_torch.cli.main import _write_slam_visualizations, save_visualization

        api.slam.slam.store_keyframe_images = True
        seen = {}

        def save_vis(view, frame):
            save_visualization(vis_dir, view, frame)

        def on_output(vo):  # the CLI's viewer pass after each output
            outputs.append(vo)
            _write_slam_visualizations(api.slam.slam, SLAM_VIEWERS, save_vis, seen)

        api.on_output = on_output
    process, step = api._process_frame, api._step_frame

    def timed_process(synced):
        stepped = api._state is not None
        ts = time.perf_counter()
        process(synced)
        if stepped:
            wall.append(time.perf_counter() - ts)

    watched = collections.Counter()  # 14b: this thread's syncs in the steps after the counted one

    def counted_step(*args):
        if len(wall) == VISLAM_SYNC_STEP and "syncs" not in counted:
            api.slam.wait_idle()  # the SLAM worker's own syncs are off the step
            captures = api._step.captures
            counted["syncs"] = host_syncs(lambda: step(*args))[1]
            counted["captured"] = api._step.captures != captures
        elif watch and "syncs" in counted:
            busy = any(not p.future.done() for p in api.slam.pending)
            captures = api._step.captures
            watched.update(thread_syncs(lambda: step(*args))[1])
            watched["(steps)"] += 1
            watched["(steps beside a busy worker)"] += busy
            watched["(steps that captured)"] += api._step.captures != captures
        else:
            step(*args)

    api._process_frame, api._step_frame = timed_process, counted_step
    timer.SLAM_TIME_STATS.reset()
    timer.SLAM_TIME_STATS.enabled = True
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        frame_of = {int(k): fi for fi, k in enumerate(seq.frame_sample_idx[:F])}
        t_start = time.perf_counter()
        for k in range(int(seq.frame_sample_idx[F - 1]) + 1):
            api.add_gyro(float(seq.times[k]), seq.gyro[k])
            api.add_acc(float(seq.times[k]), seq.acc[k])
            fi = frame_of.get(k)
            if fi is not None:
                api.add_frame_stereo(float(seq.times[k]), frames[fi][0], frames[fi][1])
        t_end = time.perf_counter()
        api.finish()
        teardown = time.perf_counter() - t_end
        if vis_dir is not None:  # the CLI's last viewer pass, after finish()
            _write_slam_visualizations(api.slam.slam, SLAM_VIEWERS, save_vis, seen)
        torch.cuda.synchronize()
        launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
        table = _slam_table()
    finally:
        timer.SLAM_TIME_STATS.enabled = False
    slam, coupling = api.slam.slam, api.slam
    est = np.stack([o.position for o in outputs]) if outputs else np.zeros((0, 3))
    est_t = np.array([o.t for o in outputs])
    gt = np.stack([np.interp(est_t, seq.times, seq.pos[:, a] - seq.pos[0, a]) for a in range(3)],
                  axis=1)
    finite = bool(len(outputs)) and all(np.isfinite(np.concatenate(
        [o.position, o.orientation, o.velocity, o.point_cloud.ravel()])).all() for o in outputs)
    ate = float(ate_rmse(est, gt)) if finite and len(outputs) >= 3 else float("nan")
    steady = wall[2:]  # after the first two frames (the first step is the warm-up)
    steady_wo = [w for i, w in enumerate(wall) if i >= 2 and i != VISLAM_SYNC_STEP]
    slam_pts = sum(1 for mp in slam.points.values() if mp.triangulated)
    merged = int(sum((o.point_cloud[:, 0] < 0).sum() for o in outputs))
    syncs = counted.get("syncs")
    say(f"{name}: {F} frames in, {len(outputs)} outputs out; per-frame wall time at B=1: median "
        f"{1e3 * statistics.median(steady_wo):.2f} ms, p90 "
        f"{1e3 * float(np.percentile(steady_wo, 90)):.2f} ms, first step {1e3 * wall[0]:.1f} ms; "
        f"{len(steady) / sum(steady):.2f} frames/s after the first two frames "
        f"({len(steady)} frames in {sum(steady):.2f} s; feeding took {t_end - t_start:.2f} s); "
        f"finish() teardown {teardown:.3f} s")
    say(f"{name}: SLAM keyframes {len(slam.kf_order)} (submitted {coupling.frame_counter} "
        f"keyframe candidates, every {coupling.interval}th SLAM frame), map points "
        f"{len(slam.points)} ({slam_pts} triangulated), loop events "
        f"{[(e.kf_id, e.matched_kf_id, e.n_matches, e.applied) for e in slam.loop_events]}, "
        f"loop edges {len(slam.loop_edges)}, dropped candidates {coupling.dropped}, local BA "
        f"runs {ba_runs[0]}; outputs carrying SLAM map points: "
        f"{sum(1 for o in outputs if (o.point_cloud[:, 0] < 0).any())} ({merged} points)")
    say(f"{name}: ATE of the SLAM-corrected outputs {ate:.4f} m over {len(outputs)} outputs; "
        f"the odometry-to-SLAM transform moves the last output by "
        f"{float(np.linalg.norm(coupling.coord.T[:3, 3])):.4g} m")
    for label, ms, calls in table:
        say(f"{name} SLAM stage (per keyframe, {timer.SLAM_TIME_STATS.frames} keyframes): "
            f"{ms:10.3f} ms  {label} (x{calls})")
    say(f"{name}: host syncs in step {VISLAM_SYNC_STEP} (the SLAM worker drained): "
        f"{sum(syncs.values()) if syncs is not None else 'not counted'} "
        f"{json.dumps(dict(sorted((syncs or {}).items())))}; kernel launches {json.dumps(launches)}")
    say(f"{name}: kernel launches by input shape " + json.dumps(
        {f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
    say(f"{name} (13e): VioApi(jit=True) with the SLAM worker: the step's graph captures "
        f"{api._step.captures}, replays {api._step.replays}; IMU-only {api._imu_only.captures} / "
        f"{api._imu_only.replays}; all: {graph_stats([api._step, api._imu_only])}; step "
        f"{VISLAM_SYNC_STEP} {'captured' if counted.get('captured') else 'replayed'}")
    if counted.get("captured"):
        raise AssertionError(f"{name}: step {VISLAM_SYNC_STEP} captured a graph")
    if not finite:
        raise AssertionError(f"{name}: a non-finite output")
    if len(outputs) < F - 3:
        raise AssertionError(f"{name}: {len(outputs)} outputs for {F} frames")
    if not ate <= ATE_LIMIT_M:
        raise AssertionError(f"{name}: ATE {ate} m > {ATE_LIMIT_M} m")
    if len(slam.kf_order) < 2 or not ba_runs[0] or not slam.points:
        raise AssertionError(f"{name}: {len(slam.kf_order)} SLAM keyframes, {ba_runs[0]} local "
                             f"BA runs, {len(slam.points)} map points")
    if syncs is None:
        raise AssertionError(f"{name}: step {VISLAM_SYNC_STEP} was never run")
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    kp = dict((label, ms) for label, ms, _ in table).get("multi-scale keypoints", float("nan"))
    VISLAM_STATS[name] = dict(median=1e3 * statistics.median(steady_wo),
                              p90=1e3 * float(np.percentile(steady_wo, 90)),
                              keyframes=len(slam.kf_order), kp_ms=kp, finish=teardown, ate=ate,
                              detector=slam.keypoint_detector, outputs=outputs,
                              sync=type(api.sample_sync).__name__, table=table,
                              ba_runs=ba_runs[0], ba_calls=ba_calls, dropped=coupling.dropped,
                              session=slam,
                              loops=loop_events(slam), watched=dict(watched),
                              programs=slam.graph_pools.programs + [coupling._quantize_u8])
    return launches, by_shape, sum(syncs.values())


def run_cli_vislam(dev):
    """Phase 8c: the port's CLI with -useSlam and -slamMapPosesPath at the
    reference's defaults (the vislam() preset: mono, a SLAM candidate every
    8th keyframe, the worker thread on) over phase 7's mono dataset
    (API_FRAMES frames), the SLAM stage table per keyframe beside it. Fails
    on a non-finite output, fewer outputs than frames - 3, an ATE over
    ATE_LIMIT_M, a map file without a keyframe line, a path kernel not
    launched or a host sync in a step. Returns (launches, launches by shape,
    host syncs)."""
    import os
    import shutil
    import tempfile

    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.utils import timer

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vislam_", dir=build)
    try:
        ds, out_path, map_path = f"{tmp}/mono", f"{tmp}/out.jsonl", f"{tmp}/map.jsonl"
        write_api_dataset(ds, "mono", API_FRAMES)
        gt = [json.loads(l) for l in open(f"{ds}/data.jsonl") if "groundTruth" in l]
        gt_t = np.array([j["time"] for j in gt])
        gt_p = np.array([[j["groundTruth"]["position"][a] for a in "xyz"] for j in gt])
        timer.SLAM_TIME_STATS.reset()
        timer.SLAM_TIME_STATS.enabled = True
        t0 = time.perf_counter()
        try:
            launches, by_shape, syncs, wall, err, impl = run_cli(
                dev, "mono", ds, out_path, API_FRAMES,
                extra=("-useSlam", f"-slamMapPosesPath={map_path}"))
            table = _slam_table()
        finally:
            timer.SLAM_TIME_STATS.enabled = False
        secs = time.perf_counter() - t0
        lines = [json.loads(l) for l in open(out_path)]
        map_lines = [json.loads(l) for l in open(map_path)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    est = np.array([[j["position"][a] for a in "xyz"] for j in lines])
    t_out = np.array([j["time"] for j in lines])
    floats = np.array([[*j["position"].values(), *j["orientation"].values(),
                        *j["velocity"].values()] for j in lines])
    finite = bool(len(lines)) and bool(np.isfinite(floats).all())
    gt_i = np.stack([np.interp(t_out, gt_t, gt_p[:, a]) for a in range(3)], axis=1)
    ate = float(ate_rmse(est, gt_i)) if finite and len(lines) >= 3 else float("nan")
    steady = [w for i, w in enumerate(wall) if i not in (0, API_SYNC_STEP)]
    kf_lines = sum(1 for d in map_lines if "time" in d)
    say(f"cli vislam (-useSlam, the vislam() preset, mono): {API_FRAMES} frames in, {len(lines)} "
        f"outputs out in {secs:.1f} s; per-frame wall time at B=1: median "
        f"{1e3 * statistics.median(steady):.2f} ms, p90 "
        f"{1e3 * float(np.percentile(steady, 90)):.2f} ms, first step {1e3 * wall[0]:.1f} ms; "
        f"ATE {ate:.4f} m; the map file: {kf_lines} keyframe lines, "
        f"{len(map_lines) - kf_lines} map points")
    for label, ms, calls in table:
        say(f"cli vislam SLAM stage (per keyframe, {timer.SLAM_TIME_STATS.frames} keyframes): "
            f"{ms:10.3f} ms  {label} (x{calls})")
    say(f"cli vislam: host syncs in step {API_SYNC_STEP} (the SLAM worker drained): "
        f"{sum(syncs.values())} {json.dumps(dict(sorted(syncs.items())))}; kernel launches "
        f"{json.dumps(launches)}")
    say("cli vislam: kernel launches by input shape " + json.dumps(
        {f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
    if not finite:
        raise AssertionError("cli vislam: a non-finite output")
    if len(lines) < API_FRAMES - 3:
        raise AssertionError(f"cli vislam: {len(lines)} outputs for {API_FRAMES} frames")
    if not ate <= ATE_LIMIT_M:
        raise AssertionError(f"cli vislam: ATE {ate} m > {ATE_LIMIT_M} m")
    if kf_lines < 1:
        raise AssertionError("cli vislam: the map file has no keyframe line")
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"cli vislam: kernels not launched: {missing}")
    return launches, by_shape, sum(syncs.values())


def run_stereo_options(dev):
    """Phase 9a: STEREO_OPTION_STEPS steps of each stereo option of
    STEREO_OPTIONS on stereo_per_lane's input (B distinct worlds, 752x480,
    the batched update, a float32 filter), first the same steps with no
    option. The distortion option records the frames through EuRoC cam0's
    radial lens on both cameras: each frame rendered pinhole on the card and
    warped through the distorted camera by build_remap / remap, outside the
    step. Fails on a non-finite lane, a host sync in a step or a path kernel
    the option runs and did not launch. Returns {path name: (launches,
    launches by shape, host syncs)}."""
    import copy

    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.frontend.rectify import build_remap, remap
    from hybvio_tpu_torch.geometry.cameras import build_pinhole
    from hybvio_tpu_torch.models import _finalize
    from hybvio_tpu_torch.parallel.batched import make_batched_vio

    H, W = FRAME_HW["stereo_per_lane"]
    base, derived, cams, start, gt, frame, batches = per_lane_inputs(
        dev, torch.float32, STEREO_OPTION_STEPS + 1)
    pt = base.tracker
    pin = build_pinhole(pt.focalLength, pt.focalLength, pt.principalPointX, pt.principalPointY,
                        width=W, height=H)
    lens = build_pinhole(pt.focalLength, pt.focalLength, pt.principalPointX, pt.principalPointY,
                         coeffs=EUROC_K + (0.0,), width=W, height=H)
    warp = build_remap(pin, lens, W, H, torch.float32, dev)
    runs, plain_ate = {}, {}
    for name, settings in (("no option", {}),) + STEREO_OPTIONS:
        params = copy.deepcopy(base)
        for key, value in settings.items():
            group, field = key.split(".")
            params.set_parameter(group, field, value)
        distort = "useRectification" in str(settings)
        if distort:
            params.tracker.distortionCoeffs = EUROC_K + (0.0,)
        p, d, c = _finalize(params, W, H)
        images = ((lambda fi: tuple(remap(im, warp) for im in frame(fi))) if distort else frame)
        binit, bstep, _ = make_batched_vio(p, d, c, batch_size=B, device=dev,
                                           dtype=torch.float32)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        states = binit(images(0), np.full(B, start), np.arange(B))
        positions, step_ms = [], []
        for fi in range(1, STEREO_OPTION_STEPS + 1):
            im = images(fi)  # rendered (and warped) outside the step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if fi == 2:
                (states, out), syncs = host_syncs(lambda: bstep(states, batches[fi - 1], im))
            else:
                states, out = bstep(states, batches[fi - 1], im)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            positions.append(out.position)
        launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
        est = torch.stack(positions).double().cpu().numpy()
        finite = [b for b in range(B) if np.isfinite(est[:, b]).all()]
        ates = [float(ate_rmse(est[:, b], gt[b][:STEREO_OPTION_STEPS])) for b in finite]
        lane_ate = dict(zip(finite, ates))
        if not settings:  # "no option" runs first
            plain_ate = lane_ate
        worst = max(lane_ate, key=lane_ate.get, default=None)
        with_depth = int(torch.sum(out.track_depth > 0))
        say(f"stereo option {name}: {STEREO_OPTION_STEPS} steps at B={B} {W}x{H}, float32 "
            f"filter: median step {statistics.median(step_ms[2:]):.2f} ms over steps 3-"
            f"{STEREO_OPTION_STEPS} ({' '.join(f'{t:.1f}' for t in step_ms[2:])}; "
            f"stereo_per_lane's median step in phase 4: "
            f"{PATH_MEDIAN_MS.get('stereo_per_lane', float('nan')):.2f} ms), steps 1-2 "
            f"{step_ms[0]:.1f} / {step_ms[1]:.1f} ms (step 2 under the sync check); finite lanes "
            f"{len(finite)}/{B}; ATE median "
            f"{statistics.median(ates) if ates else float('nan'):.4f} m, max "
            f"{max(ates, default=float('nan')):.4f} m in lane {worst} (that lane with no option "
            f"{plain_ate.get(worst, float('nan')):.4f} m); tracks with dense depth at the last "
            f"step {with_depth}; host syncs in step 2: {sum(syncs.values())} "
            f"{json.dumps(dict(sorted(syncs.items())))}")
        say(f"stereo option {name}: kernel launches {json.dumps(launches)}; by input shape "
            + json.dumps({f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
        if len(finite) != B:
            raise AssertionError(f"stereo option {name}: only {len(finite)}/{B} lanes finite")
        if sum(syncs.values()):
            raise AssertionError(f"stereo option {name}: host syncs in a step: {dict(syncs)}")
        runs_kernels = [k for k in PATH_KERNELS
                        if not (k == "corner_response" and p.tracker.featureDetector == "FAST")]
        missing = [k for k in runs_kernels if not launches[k]]
        if missing:
            raise AssertionError(f"stereo option {name}: kernels not launched: {missing}")
        if "computeDenseStereoDepth" in str(settings) and not with_depth:
            raise AssertionError(f"stereo option {name}: no track got a dense depth")
        runs[f"stereo option: {name}"] = (launches, by_shape, sum(syncs.values()))
    # the dense depth's SAD disparity alone, device time at B lanes (plain
    # PyTorch: the cost volume (B, H, D, W) written once by a gather, read
    # and written by the 2 x 15 box-sum passes), and the memory it takes
    # above its inputs at its peak
    from hybvio_tpu_torch.frontend.disparity import compute_disparity, default_max_disparity

    left, right = (im.contiguous() for im in frame(1))
    D = default_max_disparity(W)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    compute_disparity(left, right, D)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms, _ = device_ms(lambda: compute_disparity(left, right, D), reps=3)
    volume = 4 * B * H * W * D
    say(f"stereo options: the SAD disparity of {B} lanes of {W}x{H}, D={D}: {ms:.2f} ms on the "
        f"card (CUDA events, 3 calls a run, median of {RUNS}); its volume {volume / 1e9:.2f} GB, "
        f"its peak memory above its inputs {peak / 1e9:.2f} GB ({peak / volume:.2f} volumes); "
        f"reading the two images and writing disparity and validity once would take "
        f"{bound(4 * B * H * W * 3 + B * H * W, 0)[0]:.4f} ms")
    return runs


def run_euroc_cli(dev):
    """Phase 9b: a EuRoC ASL tree of the stereo path's world (EUROC_FRAMES
    frames at 752x480 through EuRoC cam0's intrinsics and radial lens on
    both cameras) through the port's CLI at the reference's defaults with
    -useStereo -useRectification (run_cli). Fails as phase 7. Returns
    (launches, launches by shape, host syncs)."""
    import glob
    import os
    import shutil
    import tempfile

    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.io import native_image
    from hybvio_tpu_torch.io.euroc import read_euroc_events
    from hybvio_tpu_torch.io.jsonl import ECHO
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
    from hybvio_tpu_torch.io.video import load_image_file

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from euroc_fixture import write_euroc_sequence  # the tests' mav0 writer

    H, W = FRAME_HW["stereo"]
    fmt = "png" if native_image.png_supported() else "pgm"
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_euroc_", dir=build)
    try:
        t0 = time.perf_counter()
        seq = generate_sequence(duration=(EUROC_FRAMES + 2) / 20.0, imu_rate=200.0,
                                frame_rate=20.0, n_landmarks=500, landmark_radius=6.0,
                                gyro_noise=5e-4, acc_noise=5e-3, seed=0)
        second = np.asarray(SYNTH_IMU_TO_CAMERA).copy()
        second[0, 3] = -0.11
        mav = f"{tmp}/mav0"
        n = write_euroc_sequence(mav, seq, (SYNTH_IMU_TO_CAMERA, second), *EUROC_INTRINSICS,
                                 W, H, EUROC_K, n_frames=EUROC_FRAMES, fmt=fmt)
        files = sorted(glob.glob(f"{mav}/cam*/data/*.{fmt}"))
        t1 = time.perf_counter()
        for f in files:
            load_image_file(f)
        decode_ms = 1e3 * (time.perf_counter() - t1) / n  # both cameras' images of a frame
        gt = [e.raw for e in read_euroc_events(mav) if e.kind == ECHO]
        gt_t = np.array([g["time"] for g in gt])
        gt_p = np.array([[g["groundTruth"]["position"][a] for a in "xyz"] for g in gt])
        say(f"euroc cli: wrote a {n}-frame mav0 tree ({W}x{H}, 2 cameras, EuRoC cam0 "
            f"intrinsics {EUROC_INTRINSICS} and k1, k2 = {EUROC_K}, {fmt.upper()} "
            f"({'the decoder reads PNG' if fmt == 'png' else 'the decoder was built without zlib'}"
            f"), {len(files)} images) in {t1 - t0:.1f} s; decode {decode_ms:.3f} ms a frame "
            f"(2 images, io.video.load_image_file)")
        out_path = f"{tmp}/out.jsonl"
        t0 = time.perf_counter()
        launches, by_shape, syncs, wall, err, impl = run_cli(
            dev, "stereo", tmp, out_path, EUROC_FRAMES, extra=("-useRectification",))
        if impl.get("sync") != "NativeSampleSync":
            raise AssertionError(f"euroc cli: the synchronizer {impl.get('sync')} ran")
        secs = time.perf_counter() - t0
        lines = [json.loads(line) for line in open(out_path)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    est = np.array([[j["position"][a] for a in "xyz"] for j in lines])
    t_out = np.array([j["time"] for j in lines])
    floats = np.array([[*j["position"].values(), *j["orientation"].values(),
                        *j["velocity"].values(), *np.ravel(j["positionCovariance"])]
                       for j in lines])
    finite = bool(len(lines)) and bool(np.isfinite(floats).all())
    gt_i = np.stack([np.interp(t_out, gt_t, gt_p[:, a]) for a in range(3)], axis=1)
    ate = float(ate_rmse(est, gt_i)) if finite and len(lines) >= 3 else float("nan")
    steady = [w for i, w in enumerate(wall) if i not in (0, API_SYNC_STEP)]
    say(f"euroc cli (-useStereo -useRectification, the reference's defaults, B=1): "
        f"{EUROC_FRAMES} frames in, {len(lines)} outputs out in {secs:.1f} s; per-frame wall "
        f"time: median {1e3 * statistics.median(steady):.2f} ms, p90 "
        f"{1e3 * float(np.percentile(steady, 90)):.2f} ms, first step {1e3 * wall[0]:.1f} ms; "
        f"ATE {ate:.4f} m over {len(lines)} outputs")
    say(f"euroc cli: host syncs in step {API_SYNC_STEP} (the retirement excluded): "
        f"{sum(syncs.values())} {json.dumps(dict(sorted(syncs.items())))}; kernel launches "
        f"{json.dumps(launches)}")
    say("euroc cli: kernel launches by input shape " + json.dumps(
        {f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
    if not finite:
        raise AssertionError("euroc cli: a non-finite output")
    if len(lines) < EUROC_FRAMES - 3:
        raise AssertionError(f"euroc cli: {len(lines)} outputs for {EUROC_FRAMES} frames")
    if not ate <= ATE_LIMIT_M:
        raise AssertionError(f"euroc cli: ATE {ate} m > {ATE_LIMIT_M} m")
    if sum(syncs.values()):
        raise AssertionError(f"euroc cli: host syncs in a step: {dict(syncs)}")
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"euroc cli: kernels not launched: {missing}")
    return launches, by_shape, sum(syncs.values())


TEXTURED_ATE = {}  # phase 10: each long run's per-frame positions and ground truth


def run_long(dev, name, family, seconds, sqrt):
    """Phase 10, one long textured run (eval/long_probe.py's family at one
    lane, its preset, the scene seed TEXTURED_SEED): the frames rendered on
    the card a chunk at a time outside the timed step, the step timed on the
    host clock around torch.cuda.synchronize(). Prints per-frame median and
    p90 ms (without the warm-up step and the counted one), finite, ATE,
    the host syncs of step TEXTURED_SYNC_STEP and the launches; with
    ``sqrt`` the smallest eigenvalue of W W^T at the end. Returns (launches,
    launches by shape, host syncs)."""
    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.config import DerivedParameters
    from hybvio_tpu_torch.eval import long_probe as lp
    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.eval.textured_probe import imu_batches
    from hybvio_tpu_torch.geometry.cameras import build_camera_from_params
    from hybvio_tpu_torch.parallel.batched import make_batched_vio

    overrides = {"odometry.useSquareRootEkf": True} if sqrt else None
    p, W, H, fx, coeffs = lp._geometry(family, overrides, None, None, None)
    cams = [build_camera_from_params(p.tracker, W, H)]
    if p.tracker.useStereo:
        cams.append(build_camera_from_params(p.tracker, W, H, second=True))
    seq = lp._make_sequence(seconds, TEXTURED_SEED, 10.0, 100.0)
    renderers, _ = lp._build_world(family, seq, W, H, fx, coeffs, TEXTURED_SEED, device=dev)
    frames = lp._FrameCache(seq, renderers)
    init, step, _ = make_batched_vio(p, DerivedParameters.from_parameters(p), tuple(cams),
                                     batch_size=1, max_tracks=p.tracker.maxTracks,
                                     dtype=torch.float32, device=dev)
    stereo = len(cams) == 2

    def frame(fi):
        imgs = tuple(im[None] for im in frames.get(fi))
        return imgs if stereo else imgs[0]

    F = len(seq.frame_sample_idx)
    S = int(np.max(np.diff(np.concatenate([[0], seq.frame_sample_idx + 1]))))
    batches = [b for b, _ in imu_batches(seq, F, S, torch.float32, dev)]
    t0 = time.perf_counter()
    first = frame(0)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    state = init(first, np.full(1, seq.frame_times[0]), np.arange(1))
    positions, wall, syncs = [], [], None
    for fi in range(1, F):
        t0 = time.perf_counter()
        images = frame(fi)  # a new chunk renders here, outside the timed step
        torch.cuda.synchronize()
        render_s += time.perf_counter() - t0
        ts = time.perf_counter()
        if fi == TEXTURED_SYNC_STEP:
            (state, out), syncs = host_syncs(lambda: step(state, batches[fi - 1], images))
        else:
            state, out = step(state, batches[fi - 1], images)
        torch.cuda.synchronize()
        wall.append(1000.0 * (time.perf_counter() - ts))
        positions.append(out.position[0])
    launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
    est = torch.stack(positions).double().cpu().numpy()
    gt = seq.pos[seq.frame_sample_idx[1:F]] - seq.pos[0]
    finite = bool(np.isfinite(est).all())
    ate = float(ate_rmse(est, gt)) if finite else float("nan")
    TEXTURED_ATE[name] = (est, gt)
    timed_ms = [w for i, w in enumerate(wall) if i >= 1 and i != TEXTURED_SYNC_STEP - 1]
    say(f"{name}: {family} textured, B=1, {W}x{H}, float32 filter"
        f"{', square-root filter' if sqrt else ''}, {seconds:.0f} s ({F - 1} steps): per-frame "
        f"median {statistics.median(timed_ms):.2f} ms, p90 "
        f"{float(np.percentile(timed_ms, 90)):.2f} ms, first step {wall[0]:.1f} ms; frames "
        f"rendered on the card in {render_s:.1f} s")
    say(f"{name}: finite {finite}, ATE {ate:.4f} m over {len(est)} frames; host syncs in step "
        f"{TEXTURED_SYNC_STEP}: {sum(syncs.values())} {json.dumps(dict(sorted(syncs.items())))}")
    say(f"{name}: kernel launches {json.dumps(launches)}")
    say(f"{name}: kernel launches by input shape " + json.dumps(
        {f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
    if not finite:
        raise AssertionError(f"{name}: a non-finite position")
    if sqrt:
        Wf = state.backend.ekf.P[0].double()
        eig = torch.linalg.eigvalsh(Wf @ Wf.T)
        lo, hi = float(eig.min()), float(eig.max())
        ref_est, ref_gt = TEXTURED_ATE["long_stereo"]
        n = len(est)
        ref_ate = float(ate_rmse(ref_est[:n], ref_gt[:n]))
        say(f"{name}: W W^T eigenvalues {lo:.4g} .. {hi:.4g} (floor {-SQRT_EIG_TOL:g} x max); "
            f"ATE {ate:.4f} m beside the dense filter's {ref_ate:.4f} m over the same {n} frames")
        if not lo >= -SQRT_EIG_TOL * hi:
            raise AssertionError(f"{name}: W W^T has eigenvalue {lo} < -{SQRT_EIG_TOL} x {hi}")
    if name == "long_stereo" and not ate <= ATE_LIMIT_M:
        raise AssertionError(f"{name}: ATE {ate} m > {ATE_LIMIT_M} m")
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    return launches, by_shape, sum(syncs.values())


def run_zoom(dev):
    """Phase 10d: VioApi on synthetic_bench_params("mono") at 752x480 over
    ZOOM_FRAMES frames of the blob world whose lens zooms by ZOOM (the
    focal length of frame i f0 (1 + ZOOM i / (F - 1)), each frame rendered
    on the card through its own lens beforehand), once through
    add_frame_mono_varying with each frame's intrinsics and once through
    add_frame_mono (the session camera kept at the first lens). Prints each
    run's per-frame wall time, finite outputs, ATE, the host syncs of step
    TEXTURED_SYNC_STEP and launches; fails unless both are finite, the
    varying run makes no host sync and its ATE is under ZOOM_ATE_RATIO of
    the fixed lens's. Returns {run: (launches, launches by shape, syncs)}."""
    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.io.synthetic import SYNTH_IMU_TO_CAMERA, generate_sequence
    from hybvio_tpu_torch.io.synthetic_device import make_blob_renderer
    from hybvio_tpu_torch.models import synthetic_bench_params

    params = synthetic_bench_params("mono")
    pt = params.tracker
    W, H = int(2 * pt.principalPointX), int(2 * pt.principalPointY)
    f0, cx, cy = pt.focalLength, pt.principalPointX, pt.principalPointY
    seq = generate_sequence(duration=ZOOM_FRAMES / 10.0 + 0.05, imu_rate=100.0, frame_rate=10.0,
                            n_landmarks=500, landmark_radius=6.0, gyro_noise=5e-4,
                            acc_noise=5e-3, seed=3)
    F = min(ZOOM_FRAMES, len(seq.frame_sample_idx))
    fxs = [f0 * (1.0 + ZOOM * fi / (F - 1)) for fi in range(F)]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    t0 = time.perf_counter()
    frames = []
    for fi, k in enumerate(seq.frame_sample_idx[:F]):
        render = make_blob_renderer([SYNTH_IMU_TO_CAMERA], fxs[fi], fxs[fi], cx, cy, W, H,
                                    blob_sigma=1.4, device=dev)
        frames.append(render(f32(seq.landmarks[None]), f32(seq.pos[k][None]),
                             f32(seq.quat[k][None]))[0, 0])
    torch.cuda.synchronize()
    say(f"zoom: rendered {F} frames of {W}x{H} on the card, focal length {fxs[0]:.1f} -> "
        f"{fxs[-1]:.1f} px ({100 * ZOOM:.0f}%), in {time.perf_counter() - t0:.1f} s")
    frame_of = {int(k): fi for fi, k in enumerate(seq.frame_sample_idx[:F])}
    out, ates = {}, {}
    for run, varying in (("zoom", True), ("zoom_fixed_lens", False)):
        api = VioApi(params, W, H, device=dev)
        outputs, wall, counted = [], [], {}
        api.on_output = outputs.append
        process, step = api._process_frame, api._step_frame

        def timed_process(synced):
            stepped = api._state is not None
            ts = time.perf_counter()
            process(synced)
            if stepped:
                wall.append(time.perf_counter() - ts)

        def counted_step(*a):
            if len(wall) == TEXTURED_SYNC_STEP and "syncs" not in counted:
                counted["syncs"] = host_syncs(lambda: step(*a))[1]
            else:
                step(*a)

        api._process_frame, api._step_frame = timed_process, counted_step
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(int(seq.frame_sample_idx[F - 1]) + 1):
            t = float(seq.times[k])
            api.add_gyro(t, seq.gyro[k])
            api.add_acc(t, seq.acc[k])
            fi = frame_of.get(k)
            if fi is None:
                continue
            if varying:
                api.add_frame_mono_varying(t, frames[fi], {
                    "focalLengthX": fxs[fi], "focalLengthY": fxs[fi],
                    "principalPointX": cx, "principalPointY": cy})
            else:
                api.add_frame_mono(t, frames[fi])
        api.finish()
        torch.cuda.synchronize()
        launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
        est = np.stack([o.position for o in outputs])
        est_t = np.array([o.t for o in outputs])
        gt = np.stack([np.interp(est_t, seq.times, seq.pos[:, a] - seq.pos[0, a])
                       for a in range(3)], axis=1)
        finite = bool(np.isfinite(est).all())
        ates[run] = float(ate_rmse(est, gt)) if finite else float("nan")
        syncs = counted.get("syncs")
        steady = [w for i, w in enumerate(wall) if i >= 1 and i != TEXTURED_SYNC_STEP]
        say(f"{run}: {'add_frame_mono_varying' if varying else 'add_frame_mono (first lens)'}, "
            f"B=1 {W}x{H}, {F} frames in, {len(outputs)} outputs out; per-frame wall median "
            f"{1e3 * statistics.median(steady):.2f} ms, p90 "
            f"{1e3 * float(np.percentile(steady, 90)):.2f} ms; finite {finite}, ATE "
            f"{ates[run]:.4f} m; host syncs in step {TEXTURED_SYNC_STEP}: "
            f"{sum(syncs.values()) if syncs is not None else 'not counted'} "
            f"{json.dumps(dict(sorted((syncs or {}).items())))}")
        say(f"{run}: kernel launches {json.dumps(launches)}")
        say(f"{run}: kernel launches by input shape " + json.dumps(
            {f"{k} {shape_key(sh)}": v for (k, sh), v in sorted(by_shape.items())}))
        if not finite:
            raise AssertionError(f"{run}: a non-finite output")
        if syncs is None:
            raise AssertionError(f"{run}: step {TEXTURED_SYNC_STEP} was never run")
        out[run] = (launches, by_shape, sum(syncs.values()))
    say(f"zoom: varying-lens ATE {ates['zoom']:.4f} m against the fixed lens's "
        f"{ates['zoom_fixed_lens']:.4f} m (ratio {ates['zoom'] / ates['zoom_fixed_lens']:.3f}, "
        f"limit {ZOOM_ATE_RATIO})")
    if not ates["zoom"] < ZOOM_ATE_RATIO * ates["zoom_fixed_lens"]:
        raise AssertionError(f"zoom: ATE {ates['zoom']} m not under {ZOOM_ATE_RATIO} x the "
                             f"fixed lens's {ates['zoom_fixed_lens']} m")
    return out


def _cli_outputs(out_path, ds):
    """(output lines, all their floats finite, ATE against the dataset's
    ground truth at the output times)."""
    from hybvio_tpu_torch.eval.ate import ate_rmse

    gt = [json.loads(l) for l in open(f"{ds}/data.jsonl") if "groundTruth" in l]
    gt_t = np.array([j["time"] for j in gt])
    gt_p = np.array([[j["groundTruth"]["position"][a] for a in "xyz"] for j in gt])
    lines = [json.loads(l) for l in open(out_path)]
    floats = np.array([[*j["position"].values(), *j["orientation"].values(),
                        *j["velocity"].values()] for j in lines])
    finite = bool(len(lines)) and bool(np.isfinite(floats).all())
    est = np.array([[j["position"][a] for a in "xyz"] for j in lines])
    t_out = np.array([j["time"] for j in lines])
    gt_i = np.stack([np.interp(t_out, gt_t, gt_p[:, a]) for a in range(3)], axis=1)
    ate = float(ate_rmse(est, gt_i)) if finite and len(lines) >= 3 else float("nan")
    return lines, finite, ate


def _sync_us_per_sample(ds):
    """Each synchronizer alone on the host over a dataset's samples and
    frames (read by the native reader): microseconds a sample, median of 5."""
    from hybvio_tpu_torch.config import Parameters
    from hybvio_tpu_torch.io import jsonl
    from hybvio_tpu_torch.io.native_sync import NativeSampleSync
    from hybvio_tpu_torch.odometry.sample_sync import SampleSync

    events = list(jsonl.read_jsonl_events(f"{ds}/data.jsonl"))
    n = sum(e.kind in (jsonl.GYROSCOPE, jsonl.ACCELEROMETER) for e in events)
    out = {}
    for cls in (NativeSampleSync, SampleSync):
        times = []
        for _ in range(5):
            sync = cls(Parameters().odometry)
            t0 = time.perf_counter()
            for e in events:
                if e.kind == jsonl.GYROSCOPE:
                    sync.add_sample_leader(e.t, e.values)
                elif e.kind == jsonl.ACCELEROMETER:
                    sync.add_sample_follower(e.t, e.values)
                elif e.kind == jsonl.FRAME:
                    sync.add_frame(e.t)
                while sync.poll_synced_sample() is not None:
                    pass
            times.append(time.perf_counter() - t0)
        out[cls.__name__] = 1e6 * statistics.median(times) / n
    return out, n


def run_host_layers(dev):
    """Phase 11, the host layers at full width (752x480, B=1) over phase
    7's worlds: (a) the CLI at the reference's defaults, mono and
    -useStereo, HOST_FRAMES frames each, through the native JSONL reader and
    the native synchronizer, per-frame median and p90 beside phase 7's, and
    each synchronizer alone on the host; (b) the same CLI (stereo) with
    every -display* flag and -visualizationPath over DISPLAY_FRAMES frames:
    each view's file for each retired output, each view's render ms, the
    corner response's launches from the CORNER_MEASURE view; (c) vislam
    (phase 8b's run) with a RecordingPublisher on the API, its counts
    against the outputs'; (d) vislam on the native ORB detector with the
    SLAM viewers on, beside phase 8b's torch detector. Fails on a module
    that fell back, a non-finite output or view, a view file missing, a
    host sync in a step (collected in main), an ATE over ATE_LIMIT_M or a
    CORNER_MEASURE view that launched no corner-response kernel. Returns
    {run: (launches, launches by shape, host syncs)}."""
    import shutil
    import tempfile

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.api.visualizations import VisualizationMode
    from hybvio_tpu_torch.api.vio import VioApi
    from hybvio_tpu_torch.odometry.debug import RecordingPublisher

    runs = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_", dir=build)
    try:
        for config in API_CONFIGS:  # (a)
            ds, out_path = f"{tmp}/{config}", f"{tmp}/{config}.jsonl"
            write_api_dataset(ds, config, HOST_FRAMES)
            launches, by_shape, syncs, wall, err, impl = run_cli(dev, config, ds, out_path,
                                                                 HOST_FRAMES)
            lines, finite, ate = _cli_outputs(out_path, ds)
            steady = [w for i, w in enumerate(wall) if i not in (0, API_SYNC_STEP)]
            med7, p907 = PHASE7_WALL.get(config, (float("nan"), float("nan")))
            say(f"host {config} (11a, the CLI at the defaults): the {impl.get('reader')} JSONL "
                f"reader, the synchronizer {impl.get('sync')}; {HOST_FRAMES} frames in, "
                f"{len(lines)} outputs out; per-frame wall time at B=1: median "
                f"{1e3 * statistics.median(steady):.2f} ms, p90 "
                f"{1e3 * float(np.percentile(steady, 90)):.2f} ms (phase 7 in this call: "
                f"{med7:.2f} ms, p90 {p907:.2f} ms); ATE {ate:.4f} m; host syncs in step "
                f"{API_SYNC_STEP}: {sum(syncs.values())} {json.dumps(dict(sorted(syncs.items())))}")
            check_native_host(f"host {config}", impl)
            if not finite:
                raise AssertionError(f"host {config}: a non-finite output")
            if len(lines) < HOST_FRAMES - 3 or not ate <= ATE_LIMIT_M:
                raise AssertionError(f"host {config}: {len(lines)} outputs, ATE {ate} m")
            missing = [k for k in PATH_KERNELS if not launches[k]]
            if missing:
                raise AssertionError(f"host {config}: kernels not launched: {missing}")
            runs[f"host_{config}"] = (launches, by_shape, sum(syncs.values()))
        us, n = _sync_us_per_sample(f"{tmp}/stereo")
        say(f"host: each synchronizer alone over the stereo dataset's {n} samples: "
            + ", ".join(f"{k} {v:.2f} us a sample" for k, v in us.items()))

        # (b) every display flag
        vis, out_path = f"{tmp}/vis", f"{tmp}/display.jsonl"
        render, render_ms, corner, bad = VioApi.render_visualization, {}, [0], []

        def timed_render(self, mode=None, epipolar_select=None):
            before = ops.LAUNCHES["corner_response"]
            t0 = time.perf_counter()
            img = render(self, mode, epipolar_select)
            view = VisualizationMode(int(mode)).name
            render_ms.setdefault(view, []).append(1e3 * (time.perf_counter() - t0))
            if view == "CORNER_MEASURE":
                corner[0] += ops.LAUNCHES["corner_response"] - before
            if img is not None and not np.isfinite(img).all():
                bad.append(view)
            return img

        VioApi.render_visualization = timed_render
        try:
            launches, by_shape, syncs, wall, err, impl = run_cli(
                dev, "stereo", f"{tmp}/stereo", out_path, DISPLAY_FRAMES,
                extra=(*DISPLAY_FLAGS, f"-visualizationPath={vis}"))
        finally:
            VioApi.render_visualization = render
        lines, finite, ate = _cli_outputs(out_path, f"{tmp}/stereo")
        files = sorted(os.listdir(vis))
        want = {f"{v}_{k:06d}" for v in DISPLAY_VIEWS for k in range(len(lines))}
        missing = sorted(want - {f.rsplit(".", 1)[0] for f in files})
        say(f"host display (11b, the CLI -useStereo with {len(DISPLAY_FLAGS)} -display* flags and "
            f"-visualizationPath): {DISPLAY_FRAMES} frames in, {len(lines)} outputs out, "
            f"{len(files)} view files ({sorted({f.rsplit('.', 1)[1] for f in files})}), missing "
            f"{missing}; render ms a view (median over the outputs): " + ", ".join(
                f"{v} {statistics.median(ms):.2f}" for v, ms in sorted(render_ms.items()))
            + f"; CORNER_MEASURE launched the corner-response kernel {corner[0]} times; host "
            f"syncs in step {API_SYNC_STEP}: {sum(syncs.values())}")
        check_native_host("host display", impl)
        if "failed" in err:
            raise AssertionError(f"host display: a view failed: {err[-2000:]}")
        if missing or bad or not finite:
            raise AssertionError(f"host display: views missing {missing}, non-finite {bad}, "
                                 f"outputs finite {finite}")
        if corner[0] < len(lines):
            raise AssertionError(f"host display: CORNER_MEASURE launched the kernel {corner[0]} "
                                 f"times for {len(lines)} outputs")
        runs["host_display"] = (launches, by_shape, sum(syncs.values()))

        # (c) a debug publisher on vislam
        pub = RecordingPublisher()
        runs["vislam_publisher"] = run_vislam(dev, "vislam_publisher", PUBLISHER_FRAMES,
                                              publisher=pub)
        st = VISLAM_STATS["vislam_publisher"]
        outs = st["outputs"]
        tri = np.array(pub.triangulations).reshape(-1, 3)
        clouds = np.concatenate(pub.point_clouds) if pub.point_clouds else np.zeros((0, 3))
        say(f"vislam_publisher (11c): published {len(pub.frames)} frames for {len(outs)} "
            f"outputs (times equal: {pub.frames == [o.t for o in outs]}), "
            f"{len(pub.visual_updates)} visual updates, {len(pub.successful_updates)} "
            f"successful, {len(tri)} triangulations, {len(pub.point_clouds)} clouds of "
            f"{len(clouds)} points; all finite: "
            f"{bool(np.isfinite(tri).all() and np.isfinite(clouds).all())}")
        if pub.frames != [o.t for o in outs] or not pub.visual_updates:
            raise AssertionError("vislam_publisher: the publisher's frames are not the outputs'")
        if not (np.isfinite(tri).all() and np.isfinite(clouds).all()):
            raise AssertionError("vislam_publisher: a non-finite published point")

        # (d) the native ORB detector with the SLAM viewers on
        slam_vis = f"{tmp}/slam_vis"
        os.makedirs(slam_vis)
        runs["vislam_native_orb"] = run_vislam(dev, "vislam_native_orb", vis_dir=slam_vis)
        nat, tor = VISLAM_STATS["vislam_native_orb"], VISLAM_STATS.get("vislam", {})
        files = sorted(os.listdir(slam_vis))
        views = {v: sum(f.startswith(v + "_") for f in files) for v in SLAM_VIEWS + ("loop_match",)}
        nan = float("nan")
        row = lambda d: (f"keyframes {d.get('keyframes')}, keypoints {d.get('kp_ms', nan):.3f} "
                         f"ms a keyframe, per-frame median {d.get('median', nan):.2f} ms, p90 "
                         f"{d.get('p90', nan):.2f} ms ({d.get('p90', nan) / d.get('median', nan):.2f}"
                         f"x), finish() {d.get('finish', nan):.3f} s, ATE {d.get('ate', nan):.4f} m")
        say(f"vislam_native_orb (11d): the {nat['detector']} detector: {row(nat)}; phase 8b's "
            f"{tor.get('detector')} detector in this call: {row(tor)}; SLAM viewer files "
            f"{json.dumps(views)}")
        if nat["detector"] != "native":
            raise AssertionError(f"vislam_native_orb: the {nat['detector']} detector ran")
        if not all(views[v] for v in SLAM_VIEWS):
            raise AssertionError(f"vislam_native_orb: SLAM viewer files missing: {views}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def run_textured(dev):
    """Phase 10: the long textured runs (TEXTURED_RUNS) and the zoom."""
    runs = {name: run_long(dev, name, family, seconds, sqrt)
            for name, family, seconds, sqrt in TEXTURED_RUNS}
    runs.update(run_zoom(dev))
    return runs


def run_mesh(dev, mesh):
    """Phase 12a: stereo_per_lane at MESH_LANES lanes (lane b's world
    seeded 1000 + b, as phase 4's) over ``mesh`` (B lanes a shard),
    MESH_STEPS steps. Fails on a non-finite lane, an ATE median over
    ATE_LIMIT_M, a host sync in a step, a path kernel not launched, or
    shard 0's positions parting from phase 4's stereo_per_lane positions
    over the same steps by more than MESH_POS_TOL. Returns (launches,
    launches by input shape, host syncs of one step)."""
    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.eval.ate import ate_rmse
    from hybvio_tpu_torch.parallel.batched import make_batched_vio

    L, H, W = MESH_LANES, *FRAME_HW["stereo_per_lane"]
    t0 = time.perf_counter()
    # phase 4's sequences (their length sets their noise): lanes 0..B-1 are its lanes
    params, derived, cams, start, gt, frame, batches = per_lane_inputs(
        dev, frames=PATH_FRAMES.get("stereo_per_lane", FRAMES), lanes=L)
    binit, bstep, vios = make_batched_vio(params, derived, cams, batch_size=L, mesh=mesh)
    torch.cuda.synchronize()
    say(f"mesh_stereo_per_lane (12a): {L} distinct worlds, {W}x{H} stereo rendered on the card "
        f"each step, over a mesh of {mesh.size} shards on {sorted(set(map(str, mesh.devices)))} "
        f"({L // mesh.size} lanes and one replica a shard); set-up "
        f"{time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    states = binit(frame(0), np.full(L, start), np.arange(L))
    positions, step_ms = [], []
    for fi in range(1, MESH_STEPS + 1):
        images = frame(fi)  # rendered here, outside the timed step
        torch.cuda.synchronize()
        ts = time.perf_counter()
        if fi == 2:  # the host syncs of one step (not timed)
            (states, out), syncs = host_syncs(lambda: bstep(states, batches[fi - 1], images))
        else:
            states, out = bstep(states, batches[fi - 1], images)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - ts))
        positions.append(out.position)
    launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
    est = torch.stack(positions).cpu().numpy()  # (steps, L, 3)
    finite = [b for b in range(L) if np.isfinite(est[:, b]).all()]
    ates = [float(ate_rmse(est[:, b], gt[b][:MESH_STEPS])) for b in finite]
    ate_med = float(np.median(ates)) if ates else float("nan")
    shard0 = float(np.abs(est[:, :B] - PATH_POSITIONS["stereo_per_lane"][:MESH_STEPS]).max())
    timed = step_ms[2:]
    med = statistics.median(timed)
    say(f"mesh_stereo_per_lane (12a): B={L} over {mesh.size} shards, float32 filter, "
        f"{MESH_STEPS} steps: median step {med:.2f} ms over steps 3-{MESH_STEPS} (stereo_per_lane "
        f"at B={B} in phase 4: {PATH_MEDIAN_MS['stereo_per_lane']:.2f} ms), aggregate "
        f"{L * len(timed) / (sum(timed) / 1000.0):.1f} frames/s, step 1 {step_ms[0]:.1f} ms; "
        f"placement on one card, not scaling")
    say(f"mesh_stereo_per_lane (12a): finite lanes {len(finite)}/{L}, ATE median {ate_med:.4f} m "
        f"(max {max(ates) if ates else float('nan'):.4f} m); shard 0 against phase 4's "
        f"stereo_per_lane over steps 1-{MESH_STEPS}: max position difference {shard0:.3g} m "
        f"(tol {MESH_POS_TOL}); host syncs in one step (step 2): {sum(syncs.values())} "
        f"{json.dumps(dict(sorted(syncs.items())))}")
    say(f"mesh_stereo_per_lane (12a, 13f): kernel launches {json.dumps(launches)}; each shard's "
        f"graph: " + "; ".join(f"shard {i} captures {g.captures}, replays {g.replays}"
                                for i, g in enumerate(bstep.graphs))
        + f"; all: {graph_stats(bstep.graphs)}")
    COMPILED["mesh"] = dict(shard0=shard0, captures=sum(g.captures for g in bstep.graphs))
    if len(finite) != L:
        raise AssertionError(f"mesh_stereo_per_lane: only {len(finite)}/{L} lanes finite")
    if not ate_med <= ATE_LIMIT_M:
        raise AssertionError(f"mesh_stereo_per_lane: ATE median {ate_med} m > {ATE_LIMIT_M} m")
    if not shard0 <= MESH_POS_TOL:
        raise AssertionError(f"mesh_stereo_per_lane: shard 0 parts from phase 4 by {shard0} m")
    check_path_kernels("mesh_stereo_per_lane", launches)
    return launches, by_shape, sum(syncs.values())


def run_scan(dev):
    """Phase 12b (and 13b): make_batched_scan over phase 4's stereo inputs
    (B lanes, shared frames, the same seeds and frames), SCAN_STEPS frames:
    once to capture the step's graph, once under the sync check (replays;
    its launches counted), once timed. Fails on a host sync in scan_run, a
    path kernel not launched, or positions parting from phase 4's (the
    captured step's, bit-equal with the eager one in 13a) by more than
    MESH_POS_TOL. Returns (launches, launches by input shape, host syncs of
    the whole scan)."""
    import torch

    from hybvio_tpu_torch import ops
    from hybvio_tpu_torch.odometry.backend import ImuBatch
    from hybvio_tpu_torch.parallel.batched import make_batched_scan

    inp, F = STEREO_INPUTS, SCAN_STEPS
    binit, scan_run = make_batched_scan(inp["params"], inp["derived"], inp["cams"], batch_size=B,
                                        device=dev)
    frames = inp["frames"]
    frames_stack = tuple(torch.stack([frames[fi][c] for fi in range(1, F + 1)]) for c in (0, 1))
    imu_stack = ImuBatch(*(torch.stack(xs) for xs in zip(*inp["batches"][:F])))
    t0s = np.full(B, inp["start"])
    ts = time.perf_counter()
    _, first = scan_run(binit(frames[0], t0s, np.arange(B)), imu_stack, frames_stack)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - ts
    ops.reset_launch_counts()
    states = binit(frames[0], t0s, np.arange(B))
    (_, checked), syncs = host_syncs(lambda: scan_run(states, imu_stack, frames_stack))
    torch.cuda.synchronize()
    launches, by_shape = dict(ops.LAUNCHES), dict(ops.SHAPE_LAUNCHES)
    states = binit(frames[0], t0s, np.arange(B))
    torch.cuda.synchronize()
    ts = time.perf_counter()
    _, positions = scan_run(states, imu_stack, frames_stack)
    torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - ts) / F
    eager = PATH_POSITIONS["stereo"][:F]
    diff = max(float(np.abs(p.cpu().numpy() - eager).max()) for p in (first, checked, positions))
    COMPILED["scan"] = dict(ms=wall_ms, diff=diff, first_s=first_s)
    say(f"scan_stereo (12b, 13b): make_batched_scan, B={B} shared frames, {F} frames staged on "
        f"the card: {wall_ms:.2f} ms a frame (wall, the whole scan / {F}, replays; phase 4's "
        f"stereo median step {PATH_MEDIAN_MS['stereo']:.2f} ms; the first scan, with the "
        f"capture, {first_s:.2f} s); positions {tuple(positions.shape)} of the three scans "
        f"against phase 4's: max difference {diff:.3g} m (tol {MESH_POS_TOL}); host syncs in "
        f"scan_run: {sum(syncs.values())} {json.dumps(dict(sorted(syncs.items())))}; "
        f"{graph_stats(scan_run.step.graphs)}")
    say(f"scan_stereo (12b): kernel launches {json.dumps(launches)}")
    if tuple(positions.shape) != (F, B, 3) or not diff <= MESH_POS_TOL:
        raise AssertionError(f"scan_stereo: positions {tuple(positions.shape)} part from phase "
                             f"4's by {diff} m")
    check_path_kernels("scan_stereo", launches)
    return launches, by_shape, sum(syncs.values())


def ba_problem(dev, NK, MP, seed=0):
    """tools/scaling_bench.py's well-posed BA problem (cameras on a line
    looking at a point cloud, 0.002 observation noise, points off by 1%),
    float64 tensors on ``dev``."""
    import torch

    from hybvio_tpu_torch.slam.ba import BAProblem

    rng = np.random.RandomState(seed)
    poses = np.zeros((NK, 7))
    poses[:, 3] = 1.0
    poses[:, 0] = np.linspace(0, 2.0, NK)
    pts = rng.randn(MP, 3) * 2.0 + np.array([1.0, 0.0, 6.0])
    obs_ip = np.zeros((NK, MP, 2))
    obs_mask = np.zeros((NK, MP), bool)
    for i in range(NK):
        rel = pts - poses[i, :3]
        obs_ip[i] = rel[:, :2] / rel[:, 2:3]
        obs_mask[i] = rel[:, 2] > 1.0
    obs_ip += 0.002 * rng.randn(*obs_ip.shape)
    rel7 = np.zeros((NK - 1, 7))
    rel7[:, 3] = 1.0
    rel7[:, 0] = poses[1, 0] - poses[0, 0]
    t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
    return BAProblem(
        poses=t(poses), points=t(pts * (1 + 0.01 * rng.randn(MP, 3))), obs_ip=t(obs_ip),
        obs_mask=t(obs_mask), pose_valid=t(np.ones(NK, bool)), point_valid=t(np.ones(MP, bool)),
        prior_rel=t(rel7), prior_mask=t(np.ones(NK - 1, bool)), prior_w_pos=t(5.0),
        prior_w_rot=t(50.0))


def run_sharded_ba(dev, mesh):
    """Phase 12c: make_sharded_ba over ``mesh`` against ba_iterate on the
    card, BA_ITERATIONS iterations at NK = BA_NK, MP = BA_MP, float64:
    poses within BA_POSE_TOL, points within BA_POINT_TOL; each one's time
    between CUDA events around the call, the median of BA_TIMED_RUNS after
    a warm-up."""
    import torch

    from hybvio_tpu_torch.slam.ba import ba_iterate, make_sharded_ba

    prob = ba_problem(dev, BA_NK, BA_MP)
    sharded = make_sharded_ba(mesh, iterations=BA_ITERATIONS)
    runs = {"sharded": lambda: sharded(prob),
            "unsharded": lambda: ba_iterate(prob, iterations=BA_ITERATIONS)}
    out, ms = {}, {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(BA_TIMED_RUNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out[name] = fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms[name] = statistics.median(times)
    (sp, sx, sc), (up, ux, uc) = out["sharded"], out["unsharded"]
    pose_err = float((sp - up).abs().max())
    point_err = float((sx - ux).abs().max())
    say(f"sharded BA (12c): NK={BA_NK}, MP={BA_MP}, float64, {BA_ITERATIONS} iterations, "
        f"{mesh.size} shards of {BA_MP // mesh.size} points on {sorted(set(map(str, mesh.devices)))}: "
        f"{ms['sharded']:.3f} ms against ba_iterate's {ms['unsharded']:.3f} ms on the card (CUDA "
        f"events around the call, median of {BA_TIMED_RUNS}); max pose difference "
        f"{pose_err:.3g} (tol {BA_POSE_TOL}), max point difference {point_err:.3g} (tol "
        f"{BA_POINT_TOL}); cost {float(sc):.6g} / {float(uc):.6g}")
    if not (pose_err <= BA_POSE_TOL and point_err <= BA_POINT_TOL):
        raise AssertionError(f"sharded BA: poses part by {pose_err}, points by {point_err}")


def run_mesh_session(dev, mesh):
    """Phase 12d: phase 8a's MESH_SESSION scenario through a card session
    with set_ba_mesh(mesh) and a CPU session without: the same ids and loop
    events, poses and points within SLAM_POSE_TOL, and the mesh's BA run."""
    import torch

    from hybvio_tpu_torch.config import Parameters
    from hybvio_tpu_torch.slam.session import Slam

    name, settings, kw, frames, _ = next(sc for sc in slam_scenarios() if sc[0] == MESH_SESSION)
    sessions, calls = [], []
    for d in (dev, torch.device("cpu")):
        p = Parameters()
        for k, v in settings.items():
            setattr(p.slam, k, v)
        s = Slam(p, device=d, **kw)
        if d == dev:
            s.set_ba_mesh(mesh)
            ba = s._ba_sharded
            s._ba_sharded = lambda prob: calls.append(1) or ba(prob)
        t0 = time.perf_counter()
        for img, T, ids, ip, t, k in frames:
            s.add_frame(img, T, ids, ip, t=t, frame_num=k)
        sessions.append((s, time.perf_counter() - t0))
    (card, card_s), (cpu, cpu_s) = sessions
    same, pose_err, point_err = session_diff(card, cpu)
    say(f"slam session with set_ba_mesh (12d), {name}: {len(frames)} frames, card over "
        f"{mesh.size} BA shards {1e3 * card_s:.1f} ms, CPU without a mesh {1e3 * cpu_s:.1f} ms; "
        f"{len(calls)} sharded BA runs; keyframes {card.kf_order}, {len(card.points)} map "
        f"points; ids {'equal' if same else 'DIFFER'}, max pose diff {pose_err:.3g}, max point "
        f"diff {point_err:.3g} (tol {SLAM_POSE_TOL})")
    if not same or not (pose_err <= SLAM_POSE_TOL and point_err <= SLAM_POSE_TOL):
        raise AssertionError(f"slam session with set_ba_mesh: ids equal {same}, poses part by "
                             f"{pose_err}, points by {point_err}")
    if not calls:
        raise AssertionError("slam session with set_ba_mesh: the sharded BA never ran")


def run_multi_device(dev):
    """Phase 12, the multi-device layer: (a) run_mesh, (b) run_scan, (c)
    run_sharded_ba, (d) run_mesh_session over a mesh of MESH_SHARDS shards
    on ``dev``, then (e) graft_entry.dryrun_multichip over every card.
    Returns {path name: (launches, launches by shape, host syncs)} of (a)
    and (b)."""
    import torch

    from hybvio_tpu_torch import graft_entry
    from hybvio_tpu_torch.parallel.batched import Mesh

    t0 = time.perf_counter()
    mesh = Mesh((torch.device("cuda", torch.cuda.current_device()),) * MESH_SHARDS)
    runs = {"mesh_stereo_per_lane": run_mesh(dev, mesh), "scan_stereo": run_scan(dev)}
    run_sharded_ba(dev, mesh)
    run_mesh_session(dev, mesh)
    n = torch.cuda.device_count()
    ts = time.perf_counter()
    out = graft_entry.dryrun_multichip(n)
    say(f"dryrun_multichip({n}) (12e): {time.perf_counter() - ts:.1f} s over {out['devices']}, "
        f"positions finite {np.isfinite(out['positions']).all()}, BA cost {out['ba_cost']:.3g}; "
        f"phase 12 {time.perf_counter() - t0:.1f} s")
    return runs


def thread_syncs(fn):
    """Run ``fn()`` under torch.cuda.set_sync_debug_mode("warn"): (its
    result, the host syncs this thread made, by the Python line that made
    each); another thread's (the SLAM worker's) are not counted."""
    import threading
    import warnings

    import torch

    me, lines = threading.get_ident(), collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        if (threading.get_ident() == me and "synchroniz" in text
                and "prototype feature" not in text):
            lines[f"{filename.rsplit('/', 1)[-1]}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, lines


def program_line(programs):
    """One line on SLAM programs: each one's captures (signatures),
    capture seconds and replays."""
    return "; ".join(f"{p.name[5:]} {p.captures} ({p.keys}) in {p.capture_s:.2f} s, "
                     f"{p.replays} replays" for p in programs if p.captures or p.replays) \
        or "none called"


def double_captures(programs):
    """The programs that captured one signature (shapes, dtypes, host
    values) twice: a layout that changed between calls."""
    from hybvio_tpu_torch.graphs import describe

    return [p.name for p in programs
            if len({describe(k) for k in p._graphs}) < p.captures]


@contextlib.contextmanager
def eager_slam_programs(record=None):
    """Inside the block every SLAM program (a CapturedStep named "slam
    ...") runs its eager form, in any thread; with ``record`` (a dict),
    each call's program, inputs and outputs (cloned) are appended under the
    program's name. The VIO step stays captured."""
    from hybvio_tpu_torch import graphs

    call = graphs.CapturedStep.__call__

    def eager_call(self, *args, **kwargs):
        if not self.name.startswith("slam"):
            return call(self, *args, **kwargs)
        out = self.eager(*args, **kwargs)
        if record is not None:
            record.setdefault(self.name, []).append(
                (self, clone_tree((args, kwargs)), clone_tree(out)))
        return out

    graphs.CapturedStep.__call__ = eager_call
    try:
        yield
    finally:
        graphs.CapturedStep.__call__ = call


def slam_direct_calls(dev, session, mesh):
    """Phase 14a's inputs for the programs an eager session may not call
    (no loop in vislam, no 2D-3D fallback, no vocabulary training, no
    mesh): {name: (program, (args, kwargs))}, made from seeds: a PnP and a
    similarity problem with outliers, random descriptors for the matcher
    and k-means, phase 12c's BA problem for the sharded BA (a program of
    its own, into pools of its own)."""
    import torch

    from hybvio_tpu_torch import random as jr
    from hybvio_tpu_torch.graphs import GraphPools, capturing_into
    from hybvio_tpu_torch.slam.ba import make_sharded_ba

    rng = np.random.RandomState(14)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dev)
    P, M = 256, 60
    X = rng.randn(P, 3) + np.array([0.0, 0.0, 6.0])
    yaw = 0.1
    Rm = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
                   [0.0, 0.0, 1.0]])
    pc = X @ Rm.T + np.array([0.1, -0.2, 0.3])
    obs = pc[:, :2] / pc[:, 2:] + 1e-3 * rng.randn(P, 2)
    obs[:10] += 0.3  # outliers
    dst = 1.05 * X @ Rm.T + 0.5 + 0.01 * rng.randn(P, 3)
    dst[:10] += 2.0
    valid = torch.as_tensor(np.arange(P) < M).to(dev)
    key = jr.prng_key(torch.as_tensor(7).to(dev))
    desc = lambda n: torch.as_tensor(np.sign(rng.randn(n, 256)).astype(np.float32)).to(dev)
    with capturing_into(GraphPools("slam sharded BA (14a)")):
        sharded = make_sharded_ba(mesh, iterations=BA_ITERATIONS)
    return {
        "slam PnP RANSAC": (session._pnp_program, ((f64(X), f64(obs), valid, key),
                                                   dict(n_hyp=100, threshold=f64(0.02)))),
        "slam similarity RANSAC": (session._similarity_program, (
            (f64(X), f64(dst), valid, key), dict(n_hyp=100, threshold=f64(0.1),
                                                 with_scale=True))),
        "slam descriptor matcher": (session._match_program, (
            (desc(256), torch.ones(256, dtype=torch.bool, device=dev), desc(256),
             torch.ones(256, dtype=torch.bool, device=dev)), dict(lowe_ratio=0.7))),
        "slam vocabulary k-means": (session.vocabulary.kmeans_program, (
            (desc(512), desc(2048), torch.as_tensor(np.arange(2048) < 1900).to(dev), 8), {})),
        "slam sharded BA": (sharded.programs[0], ((ba_problem(dev, BA_NK, BA_MP),), {})),
    }


def replay_recorded(record):
    """Phase 14a: each recorded eager call replayed through its captured
    program (captured first where its signature is new): {name: (calls,
    leaves not bit-equal, largest difference)}."""
    import torch

    torch.cuda.synchronize()
    rows = {}
    for name, calls in record.items():
        unequal, worst = 0, 0.0
        for program, (args, kwargs), want in calls:
            before = program.replays
            for _ in range(3):  # a warm-up, a capture, then a replay at the latest
                got = program(*args, **kwargs)
                if program.replays > before:
                    break
            n, w = bit_diff(got, want)
            unequal, worst = unequal + n, max(worst, w)
        rows[name] = (len(calls), unequal, worst)
    torch.cuda.synchronize()
    return rows


def time_ba(dev, mesh, NK, MP):
    """Phase 14c at one problem size (ba_problem's, float64,
    BA_ITERATIONS iterations): ba_iterate and the sharded BA over ``mesh``,
    each captured (replays, in pools that capture at a signature's second
    call, as a session's) and eager, between CUDA events, the median of
    BA_TIMED_RUNS after two calls (a warm-up and the capture); ba_iterate on the host
    CPU (device="cpu", the reference's placement, host clock, the median of
    BA_CPU_RUNS). The captured results bit-equal with the eager ones, the
    CPU's within BA_POSE_TOL / BA_POINT_TOL. Returns {variant: ms}."""
    import torch

    from hybvio_tpu_torch.graphs import CapturedStep, GraphPools, capturing_into
    from hybvio_tpu_torch.slam.ba import BAProblem, ba_iterate, make_sharded_ba

    prob = ba_problem(dev, NK, MP)
    pools = GraphPools("slam BA (14c)", eager_calls=1)  # as a session's
    with capturing_into(pools):
        ba = CapturedStep(lambda p: ba_iterate(p, iterations=BA_ITERATIONS), "slam BA (14c)")
        sharded = make_sharded_ba(mesh, iterations=BA_ITERATIONS)
    runs = {"ba_iterate captured": lambda: ba(prob), "ba_iterate eager": lambda: ba.eager(prob),
            "sharded captured": lambda: sharded(prob),
            "sharded eager": lambda: sharded.programs[0].eager(prob)}
    out, ms = {}, {}
    for name, fn in runs.items():
        fn()
        fn()  # the captured ones: a warm-up, then the capture
        torch.cuda.synchronize()
        times = []
        for _ in range(BA_TIMED_RUNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out[name] = fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms[name] = statistics.median(times)
    cpu_prob = BAProblem(*(x.cpu() for x in prob))
    times = []
    for _ in range(BA_CPU_RUNS):
        t0 = time.perf_counter()
        cpu_out = ba_iterate(cpu_prob, iterations=BA_ITERATIONS)
        times.append(1e3 * (time.perf_counter() - t0))
    ms["ba_iterate on the CPU"] = statistics.median(times)
    diffs = {what: bit_diff(out[f"{what} captured"], out[f"{what} eager"])
             for what in ("ba_iterate", "sharded")}
    pose_err = float((cpu_out[0] - out["ba_iterate eager"][0].cpu()).abs().max())
    point_err = float((cpu_out[1] - out["ba_iterate eager"][1].cpu()).abs().max())
    say(f"phase 14c BA at NK={NK}, MP={MP}, float64, {BA_ITERATIONS} iterations: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f" (CUDA events on the card, median of {BA_TIMED_RUNS}; host clock on the CPU, "
        f"{torch.get_num_threads()} threads, median of {BA_CPU_RUNS}); captured vs eager: "
        f"leaves not bit-equal ba_iterate {diffs['ba_iterate'][0]}, sharded "
        f"{diffs['sharded'][0]}; CPU vs card: poses {pose_err:.3g}, points {point_err:.3g}; "
        f"captures ba_iterate {ba.captures} in {ba.capture_s:.2f} s, sharded "
        f"{sharded.programs[0].captures} in {sharded.programs[0].capture_s:.2f} s; pool "
        f"{pools.nbytes() / 2**20:.1f} MiB")
    if any(n for n, _ in diffs.values()):
        raise AssertionError(f"phase 14c: captured BA differs from eager: {diffs}")
    if not (pose_err <= BA_POSE_TOL and point_err <= BA_POINT_TOL):
        raise AssertionError(f"phase 14c: the CPU's BA parts from the card's by {pose_err} / "
                             f"{point_err}")
    return ms


def run_compiled_slam(dev):
    """Phase 14, the compiled SLAM side: (b) vislam (8b) with every SLAM
    program eager (its calls recorded), then captured, with the steps after
    step VISLAM_SYNC_STEP watched for host syncs of the stepping thread,
    then captured and eager again (the medians of all four);
    (a) phase 8a's SLAM_RECORD_SCENARIOS through eager card sessions
    (recorded, held to 8a's CPU sessions), direct calls of the programs no
    session called, and every recorded call replayed through its captured
    program, bit-equal; (c) time_ba at vislam's and phase 12c's problem
    sizes; (d) each program's captures, seconds, replays and signatures,
    the SLAM pools beside the step's. Returns {path: (launches, by shape,
    host syncs)} of the four vislam runs."""
    import torch

    from hybvio_tpu_torch.config import Parameters
    from hybvio_tpu_torch.graphs import graph_pool_bytes
    from hybvio_tpu_torch.parallel.batched import Mesh
    from hybvio_tpu_torch.slam.session import Slam

    t0 = time.perf_counter()
    record = {}
    runs = {}
    with eager_slam_programs(record):
        runs["vislam_eager_slam"] = run_vislam(dev, "vislam_eager_slam")
    runs["vislam_captured_slam"] = run_vislam(dev, "vislam_captured_slam", watch=True)
    runs["vislam_captured_slam_2"] = run_vislam(dev, "vislam_captured_slam_2")
    with eager_slam_programs():
        runs["vislam_eager_slam_2"] = run_vislam(dev, "vislam_eager_slam_2")
    four = [VISLAM_STATS[n] for n in runs]
    say("phase 14b vislam in the order eager, captured, captured, eager SLAM programs: "
        "per-frame median " + " / ".join(f"{st['median']:.2f}" for st in four) + " ms, p90 "
        + " / ".join(f"{st['p90']:.2f}" for st in four) + " ms, finish() "
        + " / ".join(f"{st['finish']:.3f}" for st in four) + " s, ATE "
        + " / ".join(f"{st['ate']:.4f}" for st in four) + " m")
    eager, captured = VISLAM_STATS["vislam_eager_slam"], VISLAM_STATS["vislam_captured_slam"]
    for name, st in (("eager", eager), ("captured", captured)):
        say(f"phase 14b vislam, SLAM programs {name}: per-frame median {st['median']:.2f} ms, "
            f"p90 {st['p90']:.2f} ms (p90/median {st['p90'] / st['median']:.2f}), finish() "
            f"{st['finish']:.3f} s, keyframes {st['keyframes']}, BA runs {st['ba_runs']}, loop "
            f"events {st['loops']}, dropped candidates {st['dropped']}, ATE {st['ate']:.4f} m; "
            f"each local BA call (how it ran, ms to its result on the worker): "
            + ", ".join(f"{kind} {ms:.1f}" for kind, ms in st["ba_calls"]))
    stage = {label: (ms_e, [ms for lb, ms, _ in captured["table"] if lb == label])
             for label, ms_e, _ in eager["table"]}
    say("phase 14b SLAM stages, ms a keyframe, eager / captured: " + "; ".join(
        f"{label} {e:.3f} / {c[0] if c else float('nan'):.3f}" for label, (e, c) in stage.items()))
    watched = captured["watched"]
    syncs = {k: v for k, v in watched.items() if not k.startswith("(")}
    say(f"phase 14b host syncs of the stepping thread in {watched.get('(steps)', 0)} steps after "
        f"step {VISLAM_SYNC_STEP} ({watched.get('(steps beside a busy worker)', 0)} beside a busy "
        f"SLAM worker, {watched.get('(steps that captured)', 0)} captured): "
        f"{sum(syncs.values())} {json.dumps(syncs)}")
    if syncs:
        raise AssertionError(f"phase 14b: host syncs in a VIO step beside the SLAM worker: {syncs}")
    if not watched.get("(steps beside a busy worker)"):
        raise AssertionError("phase 14b: no watched step ran beside a busy SLAM worker")
    # a dropped candidate that would not have become a keyframe leaves the
    # session as it was: two runs whose keyframes came from the same frames
    # saw the same session inputs
    se, sc = eager["session"], captured["session"]
    frames_of = lambda s: [s.keyframes[k].frame_num for k in s.kf_order]
    if frames_of(sc) == frames_of(se):
        same, pose_err, point_err = session_diff(sc, se)
        say(f"phase 14b captured vs eager session (keyframes of frames {frames_of(sc)}): ids "
            f"{'equal' if same else 'DIFFER'}, max pose diff {pose_err:.3g}, max point diff "
            f"{point_err:.3g}")
        if not same or not (pose_err <= SLAM_POSE_TOL and point_err <= SLAM_POSE_TOL):
            raise AssertionError(f"phase 14b: the captured session parts from the eager one: "
                                 f"ids equal {same}, {pose_err}, {point_err}")
    else:
        say(f"phase 14b captured vs eager session: not compared (keyframes of frames "
            f"{frames_of(sc)} / {frames_of(se)}: the worker dropped other candidates)")

    for name, settings, kw, frames, end in slam_scenarios():
        if name not in SLAM_RECORD_SCENARIOS:
            continue
        p = Parameters()
        for k, v in settings.items():
            setattr(p.slam, k, v)
        s = Slam(p, device=dev, **kw)
        with eager_slam_programs(record):
            for img, T, ids, ip, t, k in frames:
                s.add_frame(img, T, ids, ip, t=t, frame_num=k)
            if end:
                s.end()
        card, cpu = SLAM_SESSIONS[name]
        same, pose_err, point_err = session_diff(s, cpu)
        say(f"phase 14a eager card session {name}: against 8a's CPU session ids "
            f"{'equal' if same else 'DIFFER'}, max pose diff {pose_err:.3g}, max point diff "
            f"{point_err:.3g}; 8a's captured card session: {program_line(card.graph_pools.programs)}")
        if not same or not (pose_err <= SLAM_POSE_TOL and point_err <= SLAM_POSE_TOL):
            raise AssertionError(f"phase 14a: the eager card session {name} parts from the CPU's")
    mesh = Mesh((torch.device("cuda", torch.cuda.current_device()),) * MESH_SHARDS)
    for name, (program, (args, kwargs)) in slam_direct_calls(dev, se, mesh).items():
        if name not in record:
            record[name] = [(program, (args, kwargs), clone_tree(program.eager(*args, **kwargs)))]
    replayed = replay_recorded(record)
    say("phase 14a recorded calls replayed through the captured programs (calls, leaves not "
        "bit-equal, largest difference): " + "; ".join(
            f"{name[5:]} {n} / {u} / {w:.3g}" for name, (n, u, w) in sorted(replayed.items())))
    missing = [n for n in SLAM_PROGRAMS if n not in replayed]
    if missing:
        raise AssertionError(f"phase 14a: programs never replayed: {missing}")
    bad = {n: r for n, r in replayed.items() if r[1]}
    if bad:
        raise AssertionError(f"phase 14a: replays not bit-equal with the eager calls: {bad}")
    programs = list({id(p): p for calls in record.values() for p, _, _ in calls}.values())
    doubled = double_captures(programs + captured["programs"])
    if doubled:
        raise AssertionError(f"phase 14: a signature captured twice in {doubled}")

    ba = {"vislam": time_ba(dev, mesh, sc.NK, sc.MP), "12c": time_ba(dev, mesh, BA_NK, BA_MP)}
    progs = captured["programs"]
    say("phase 14d vislam's programs (captures (signatures) in s, replays): " + program_line(progs)
        + f"; the session's SLAM pools {sc.graph_pools.nbytes() / 2**20:.1f} MiB, the VIO "
        f"steps' pool {graph_pool_bytes('cuda:0') / 2**20:.1f} MiB; phase 14 "
        f"{time.perf_counter() - t0:.1f} s")
    idle = [p.name for p in progs if p.captures and not p.replays]
    say(f"phase 14d vislam's programs captured and never replayed: {idle or 'none'}")
    COMPILED_SLAM.update(eager=eager, captured=captured, four=four, ba=ba, replayed=replayed,
                         capture_s=sum(p.capture_s for p in progs), idle=idle)
    return runs


def report_compiled(seconds):
    """Phase 13's summary: each path's eager and captured median step
    (13a), the scan (13b), the API at B=1 (13c) and the mesh's shard 0
    (13f), and the script's wall time."""
    for config in PATHS:
        c = COMPILED[config]
        say(f"phase 13a {config}: median step eager {c['eager_ms']:.2f} ms, captured "
            f"{c['captured_ms']:.2f} ms ({c['eager_ms'] / c['captured_ms']:.2f}x); "
            f"{c['captures']} capture(s) in {c['capture_s']:.2f} s; leaves not bit-equal "
            f"{c['unequal']}")
    sc = COMPILED["scan"]
    say(f"phase 13b scan: {sc['ms']:.2f} ms a frame, {sc['diff']:.3g} m from phase 4")
    for config in API_CONFIGS:
        a = COMPILED[f"api_{config}"]
        say(f"phase 13c api_{config}: per-frame median (p90) eager {a['eager'][0]:.2f} "
            f"({a['eager'][1]:.2f}) ms, captured {a['captured'][0]:.2f} ({a['captured'][1]:.2f}) "
            f"ms; positions {a['diff']:.3g} m apart")
    say(f"phase 13f mesh: shard 0 {COMPILED['mesh']['shard0']:.3g} m from phase 4, "
        f"{COMPILED['mesh']['captures']} captures; the script {seconds:.1f} s")


def main() -> int:
    t_script = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        return fail(f"torch not importable: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")
    try:
        from hybvio_tpu_torch import ops, runtime
    except ImportError as e:
        return fail(f"the port is not importable here: {e}")
    if "jax" in sys.modules:
        return fail("jax was imported")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        return fail(f"nvidia-smi gave no card name and power limit: {smi.stderr.strip()}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    runtime.configure_precision()
    dev = runtime.default_device()
    try:
        import threading

        from hybvio_tpu_torch.io import native_image

        from hybvio_tpu_torch.utils import native

        decoder = {}  # the image decoder and the native library (g++) build while nvcc runs

        def build_decoder():
            try:
                decoder["s"] = native_image.build(force=True)
            except RuntimeError as e:
                decoder["error"] = str(e)
            try:
                decoder["native"] = native.build(force=True)
            except RuntimeError as e:
                decoder["native_error"] = str(e)

        decoder_build = threading.Thread(target=build_decoder)
        decoder_build.start()
        secs = ops.build(force=True)
        decoder_build.join()
        say(f"build: nvcc sm_90a, {len(list(ops._lib.CSRC.glob('*.cu')))} sources, "
            f"{secs:.1f} s; the image decoder (g++): "
            + (f"{decoder['s']:.1f} s, reads "
               + ("PNG and PGM" if native_image.png_supported() else "PGM only (no zlib)")
               if "s" in decoder else f"FAILED: {decoder['error']}")
            + "; the native library (g++: the synchronizer, the JSONL reader, the ORB detector): "
            + (f"{decoder['native']:.1f} s" if "native" in decoder
               else f"FAILED: {decoder['native_error']}"))
        why = decoder.get("error") or native_image.unavailable_reason()
        if why:
            raise RuntimeError(f"the image decoder: {why}")
        why = decoder.get("native_error") or native.unavailable_reason()
        if why:
            raise RuntimeError(f"the native library: {why}")
        ops._lib.library()
        kern, floor_ms = check_kernels(dev)
        runs = {}
        for config in PATHS:
            runs[config], runs[f"compiled_{config}"] = run_path(dev, config)
        option_syncs = run_options(dev)
        runs.update(run_api_paths(dev))
        with torch_detector():
            run_slam_sessions(dev)
            runs["vislam"] = run_vislam(dev)
        if VISLAM_STATS["vislam"]["detector"] != "torch":
            raise AssertionError("vislam: the torch detector did not run")
        runs["cli_vislam"] = run_cli_vislam(dev)
        runs.update(run_stereo_options(dev))
        runs["euroc_cli"] = run_euroc_cli(dev)
        runs.update(run_textured(dev))
        runs.update(run_host_layers(dev))
        runs.update(run_multi_device(dev))
        with torch_detector():
            runs.update(run_compiled_slam(dev))
        torch.cuda.synchronize()
        paths = list(runs)
        rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": sum(runs[c][0][name] for c in paths),
                 "launches_by_path": {c: runs[c][0][name] for c in paths}, **kern[name]}
                for name, (src, rep) in KERNELS.items()]
        for r in rows:  # each input shape timed in phase 3 or launched on a path, by path
            counts = {c: {shape_key(sh): v for (k, sh), v in runs[c][1].items() if k == r["name"]}
                      for c in paths}
            keys = set(r["shapes"]).union(*counts.values())
            r["shapes"] = {key: {**r["shapes"].get(key, {}),
                                 "launches": {c: counts[c].get(key, 0) for c in paths}}
                           for key in sorted(keys)}
        rankings = {c: rank(rows, c) for c in paths}
        rankings[f"the {len(paths)} paths"] = rank(rows)
    except (AssertionError, RuntimeError, ValueError, TypeError, NotImplementedError) as e:
        return fail(f"{type(e).__name__}: {e}")
    if "jax" in sys.modules:
        return fail("jax was imported")
    say("host syncs per step: " + ", ".join(f"{c} {runs[c][2]}" for c in paths)
        + "; options: " + ", ".join(f"{o} {n}" for o, n in option_syncs.items()))
    synced = [c for c in paths if runs[c][2]] + [o for o, n in option_syncs.items() if n]
    if synced:
        return fail(f"host syncs in the step of {synced}")
    report_compiled(time.perf_counter() - t_script)
    for which, ranking in rankings.items():
        say(f"ranking, {which} (sum over input shapes of launches x (device - bound) per "
            f"run; launch floor {floor_ms:.5f} ms): " + "; ".join(
                f"{name} {loss:.3f} ms{' SLOWER THAN ITS LIBRARY CALL' if slower else ''}"
                f"{' (>= 50% of its bound: left alone)' if alone else ''}"
                for name, loss, slower, alone in ranking))
    for r in rows:
        say(f"  {r['name']}: " + ("; ".join(
            f"{key} {json.dumps(s['launches'])} launches x ({s['ms']:.5f} - "
            f"{s['bound_ms']:.5f}) ms"
            for key, s in r["shapes"].items() if any(s["launches"].values()))
            or "not launched on the paths"))
    print(json.dumps({"kernels": rows}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
