"""Command-line parameter surface: a copy of the reference package's
``config/cmd_params_generated.py`` (GENERATED there -- do not edit by hand).

Generated by tools/gen_cmd_params.py from the reference CLI schema
(reference: codegen/cmd_parameter_definitions.json, consumed by
codegen/generate_parameters.py:220-233). Keys are flat on the command line:
either the long name or the short alias, no group prefix
(generate_parameters.py:145-151).

Groups: "main" = offline runner flags; "viewer" = 3D viewer settings (the
runner is headless -- these are accepted for command-line compatibility
and exposed to the raster renderers where meaningful); "slam" = SLAM debug
visualization toggles.
"""

# group -> name -> (short_or_None, python_type_name, default, doc)
CMD_PARAMS = {
    'main': {
        'inputPath': ('i', 'str', '', 'input video path'),
        'outputPath': ('o', 'str', '', 'VIO output JSONL path. See also `-outputJsonExtras`.'),
        'outputType': (None, 'str', '', "extra output for `-outputPath` CSV format. Options: '', 'tail'"),
        'recordingPath': ('r', 'str', '', 'recording JSONL path'),
        'videoRecordingPath': ('vr', 'str', '', 'recording video path'),
        'parametersPath': (None, 'str', '', 'override parameters.txt'),
        'calibrationPath': (None, 'str', '', 'override calibration.json'),
        'pointCloudOutputPath': ('pc', 'str', '', 'point cloud CSV output path'),
        'slamMapPosesPath': (None, 'str', '', 'Final SLAM map poses output CSV path'),
        'displayVideo': ('c', 'bool', True, 'show video with odometry and/or tracker visualizations'),
        'displayPose': ('p', 'bool', False, 'show odometry xy position in a window'),
        'visuUpdateInterval': ('ui', 'int', 1, 'update visualizations every Nth frame'),
        'windowResolution': (None, 'float', 1000.0, 'max. dimension of the video window. Use 0 to display in algorithm width'),
        'datasetVideoIndex': ('j', 'int', -1, 'index of ADVIO video to use as input (1-23)'),
        'logLevel': ('v', 'int', 1, 'log level (-2,-1,...,9)'),
        'stepMode': ('step', 'bool', False, 'start video playback paused'),
        'targetFrameWidth': ('width', 'int', 1280, 'algorithm image width (longer side)'),
        'targetFrameWidthUpsample': ('width', 'int', -1, 'algorithm image width (longer side), allowing upsampling. overrides -targetFrameWidth'),
        'maxFrames': ('frames', 'int', -1, 'process only this many frames'),
        'gpu': ('gpu', 'bool', False, 'Enable OpenGL GPU processing'),
        'displayCorrelation': ('corr', 'bool', False, 'show KF covariance correlation in a window'),
        'displayCovarianceMagnitude': ('magn', 'bool', False, 'show KF covariance magnitude in a window'),
        'displayPointCloud': ('showPc', 'bool', False, 'show point cloud history. requires -p=true'),
        'displayImuSamples': ('showImu', 'bool', False, 'show IMU sample graph'),
        'displayStereoMatching': (None, 'bool', False, 'show stereo matching visualization'),
        'displayStereoDisparity': (None, 'bool', False, 'show stereo disparity (computed using OpenCV). Requires also -useRectification and -useStereo'),
        'displayStereoDepth': (None, 'bool', False, 'show single-frame stereo depth (computed using OpenCV). Requires also -useRectification and -useStereo'),
        'displayTracks': (None, 'bool', False, 'show active odometry tracks. requires -c'),
        'displayTracksAll': (None, 'bool', False, 'show all odometry tracks. requires -c'),
        'displayOpticalFlow': ('flow', 'str', 'NONE', 'show optical flow. requires -c Options: NONE, PREDICT, COMPARE, FAILURES'),
        'displayCornerMeasure': (None, 'bool', False, 'show tracker corner measure for each pixel'),
        'displayStereoEpipolarCurves': (None, 'str', 'NONE', 'show feature location prediction based on epipolar geometry. Requires -useStereo and -c. Options: NONE, TRACKED, DETECTED, FAILED'),
        'displayPlainVideo': (None, 'bool', False, 'display video without any debug visualizations'),
        'visualUpdateViewer': ('vu', 'bool', False, 'show 3D visualization of visual updates'),
        'timer': (None, 'bool', False, 'time algorithm functions'),
        'skipOpenGlCleanup': (None, 'bool', False, 'skip cleanup of accelerated-arrays OpenGL things to check nothing breaks'),
    },
    'viewer': {
        'viewerPaused': (None, 'bool', False, ''),
        'followCamera': (None, 'bool', True, ''),
        'showGrid': (None, 'bool', True, ''),
        'showKeyframes': (None, 'bool', True, ''),
        'showGraph': (None, 'bool', True, ''),
        'showOdometryPoses': (None, 'bool', False, ''),
        'showMps': (None, 'bool', True, ''),
        'showStereoPc': (None, 'bool', True, ''),
        'showLocalMap': (None, 'bool', False, ''),
        'showLoops': (None, 'bool', True, ''),
        'showLoopCandidates': (None, 'bool', False, ''),
        'normalColors': (None, 'bool', False, ''),
        'naturalColors': (None, 'bool', False, ''),
        'frameSize': (None, 'float', 0.2, ''),
        'mpSize': (None, 'float', 1.2, ''),
        'theme': (None, 'int', 0, ''),
    },
    'slam': {
        'displayViewer': ('s', 'bool', False, 'Show Pangolin window for 3D visualizations. Requires -useSlam=true.'),
        'displayKeyframe': ('kf', 'bool', False, 'Show SLAM keyframe visualization. Requires -useSlam=true.'),
        'visualizeOrbMatching': ('orb', 'bool', False, 'Show a separate visualization window with ORB matching between the latest keyframes'),
        'visualizeLoopOrbMatching': (None, 'bool', False, 'Select visualizing ORB matching between the latest keyframes and ORB matches for loop closures. Requires slam.visualizeOrbMatching = true'),
        'visualizeMapPointSearch': (None, 'bool', False, 'Visualize map point search via projection for new keyframes.'),
        'visualizeOrbPyramid': (None, 'bool', False, 'Visualize ORB image pyramid on keyframe.'),
        'visualizeOrbs': (None, 'bool', False, 'Visualize raw ORB data on the keyframe'),
    },
}

SHORT_TO_NAME = {'i': ('main', 'inputPath'), 'o': ('main', 'outputPath'), 'r': ('main', 'recordingPath'), 'vr': ('main', 'videoRecordingPath'), 'pc': ('main', 'pointCloudOutputPath'), 'c': ('main', 'displayVideo'), 'p': ('main', 'displayPose'), 'ui': ('main', 'visuUpdateInterval'), 'j': ('main', 'datasetVideoIndex'), 'v': ('main', 'logLevel'), 'step': ('main', 'stepMode'), 'width': ('main', 'targetFrameWidthUpsample'), 'frames': ('main', 'maxFrames'), 'gpu': ('main', 'gpu'), 'corr': ('main', 'displayCorrelation'), 'magn': ('main', 'displayCovarianceMagnitude'), 'showPc': ('main', 'displayPointCloud'), 'showImu': ('main', 'displayImuSamples'), 'flow': ('main', 'displayOpticalFlow'), 'vu': ('main', 'visualUpdateViewer'), 's': ('slam', 'displayViewer'), 'kf': ('slam', 'displayKeyframe'), 'orb': ('slam', 'visualizeOrbMatching')}


def flat_keys():
    """Every accepted command-line key (long names + shorts)."""
    keys = set(SHORT_TO_NAME)
    for items in CMD_PARAMS.values():
        keys.update(items)
    return keys


def lookup(key):
    """key (long or short) -> (group, name, type_name, default, doc)."""
    if key in SHORT_TO_NAME:
        group, name = SHORT_TO_NAME[key]
        short, tname, default, doc = CMD_PARAMS[group][name]
        return group, name, tname, default, doc
    for group, items in CMD_PARAMS.items():
        if key in items:
            short, tname, default, doc = items[key]
            return group, key, tname, default, doc
    return None


def coerce(tname: str, value: str):
    if tname == "bool":
        return str(value).strip().lower() in ("true", "1", "yes", "on", "")
    if tname == "int":
        return int(round(float(value)))
    if tname == "float":
        return float(value)
    return str(value)


def help_text() -> str:
    """Reference-style flag listing (main.cpp prints HELPS the same way)."""
    lines = []
    for group, items in CMD_PARAMS.items():
        lines.append(f"[{group}]")
        for name, (short, tname, default, doc) in items.items():
            flag = f"-{name}"
            if short:
                flag += f" / -{short}"
            lines.append(f"  {flag} ({tname}, default {default!r})")
            if doc:
                lines.append(f"      {doc}")
    return "\n".join(lines)
