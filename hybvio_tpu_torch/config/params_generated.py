"""Parameter definitions: the ``Parameters`` dataclasses and
``parameter_names`` of the reference's generated ``config/params_generated.py``,
copied whole so that the port reads the same parameter surface without
importing the reference package.

Field names, defaults and help strings mirror the original parameter
definitions, so config files and CLI flags written for them work unchanged.
"""
from dataclasses import dataclass, field, fields
from typing import Tuple

OPTICALFLOWVISUALIZATION_VALUES = ('NONE', 'PREDICT', 'COMPARE', 'FAILURES')
STEREOEPIPOLARVISUALIZATION_VALUES = ('NONE', 'TRACKED', 'DETECTED', 'FAILED')
TRACKSAMPLING_VALUES = ('GAP', 'ALL', 'RANDOM')

@dataclass
class ParametersOdometry:
    # do visual update
    visualUpdateEnabled: bool = True
    # do visual update for every Nth frame
    visualUpdateForEveryNFrame: int = 1
    # max number of visual update attempts per frame. -1 means no limit this is actually the
    # number of attempted triangulations or non-hybrid map update, which are the heaviest part
    maxVisualUpdates: int = 20
    # max number of successful visual updates per frame. -1 means no limit
    maxSuccessfulVisualUpdates: int = 5
    # apply visual update in batches
    batchVisualUpdate: bool = False
    # maximum size of the visual batch, relative to the odometry state size with values <= 1, the
    # batched update should always be more computationally efficient than the non-batched one.
    # Note: a max. size matrix is preallocated so do not set this to something like 99999. The
    # minimum safe ~0.286 (2/7)
    batchVisualUpdateMaxSizeMultiplier: float = 1.0
    # minimum length for tracks used in visual update
    trackMinFrames: int = 4
    # Type 1 threshold for rejecting tracks in visual updates (pixels, -1 to disable check)
    trackRmseThreshold: float = -1.0
    # Type 2 threshold for rejecting tracks in visual updates (pixels, -1 to disable check)
    trackChiTestOutlierR: float = 1.5
    # On each failed RMSE/Chi2 outlier check, grow both thresholds with this factor. Resets on the
    # next frame. Helps to use at least some tracks if all are bad. (larger than 1 to enable, 1 to
    # disable)
    trackOutlierThresholdGrowthFactor: float = 1.0
    scoreVisualUpdateTracks: bool = True
    # Use a faster linear method for multi-view triangulation
    useLinearTriangulation: bool = False
    # Triangulate stereo image pairs independently and combine as Gaussian weighted average in
    # multi-view triangulation. This effectively overrides useLinearTriangulation with useStereo.
    # Faster than the iterative PIVO method
    useIndependentStereoTriangulation: bool = False
    # Thresholds for iterative triangulation to consider succeeded and converged.
    triangulationConvergenceThreshold: float = 0.01
    triangulationConvergenceR: float = 11.0
    triangulationRcondThreshold: float = 1e-08
    triangulationGaussNewtonIterations: int = 10
    # minimum accepted triangulation distance
    triangulationMinDist: float = 0.0
    # maximum accepted distance: should probably be larger than this default in vehicular cases
    triangulationMaxDist: float = 1e+300
    # Track points to use in visual updates: GAP: The singe oldest one and all new unused ones.
    # ALL: All the points (may be slow and bad from theoretical perspective). RANDOM: Use
    # `randomTrackSamplingRatio` of randomly selected points and mark them to be ignored for later
    # samples.
    # one of: GAP, ALL, RANDOM
    trackSampling: str = 'GAP'
    # With trackSampling=RANDOM, use this fraction of available points and save rest. If set to 1,
    # RANDOM becomes like GAP with the difference of not reusing the oldest point.
    randomTrackSamplingRatio: float = 0.75
    # Triangulate all tracks on each frame to get the full point cloud Increases computation load
    # but should not change accuracy
    fullPointCloud: bool = False
    # How many IMU samples the odometry output lags on average. Too small value may break sample
    # synchronization.
    sampleSyncLag: int = 15
    # How many frames sample sync buffers before using one. Sensible values: 1 or 2.
    sampleSyncFrameCount: int = 2
    # How many frames can be queued in SampleSync
    sampleSyncFrameBufferSize: int = 10
    # Enable frame rate limiter that will start dropping frames if processing can't keep up before
    # hitting sampleSyncFrameBufferSize
    sampleSyncSmartFrameRateLimiter: bool = False
    # camera trail length used in KF
    cameraTrailLength: int = 20
    # how many elements (at the end) of the camera trail are used as non-FIFO memory slots
    # (Towers-of-Hanoi scheme). This can be used to extend the length trail (in time), but with a
    # non uniform stride.
    cameraTrailHanoiLength: int = 3
    # Optional strided part of the pose trail before the "Hanoi" part. In this part of the trail,
    # the elements are also kept in a FIFO queue, but new elements are accepted only every
    # N-frames
    cameraTrailStridedLength: int = 0
    cameraTrailStridedStride: int = 2
    # Keep Hanoi form of the pose trail with increasing deltas, even if features are not tracked
    # from some keyframes anymore. This makes the pose trail behave more consistently, which may
    # help with certain visualizations
    cameraTrailFixedScheme: bool = False
    # hybrid EKF-SLAM map point count in the state. Set to 0 to disable the hybrid method
    hybridMapSize: int = 0
    # noise scale used in KF. Tweaking this can increase numerical robustness, or it can be used
    # as a tweak factor for making the uncertainty estimates of the filter more realistic
    noiseScale: float = 100.0
    # make continuous zupts in the beginning
    useDecayingZeroVelocityUpdate: bool = False
    # blacklist bad tracks from being used again
    blacklistTracks: bool = True
    # visual_r parameter that (inversely) weights the visual updates
    visualR: float = 0.05
    # Pose trail augmentation update weight.
    augmentR: float = 1e-09
    # Prevent xy velocity from growing beyond `pseudoVelocityLimit` using Kalman filter updates.
    usePseudoVelocity: bool = False
    # pseudo velocity update threshold velocity (m/s)
    pseudoVelocityLimit: float = 1.4
    # which value to update velocity towards ('normally' = pseudo_limit)
    pseudoVelocityTarget: float = 0.0
    # pseudo velocity update noise parameter R
    pseudoVelocityR: float = 0.0001
    # Uncertainty parameter for zero velocity update aka ZUPT. Sets velocity to zero.
    zuptR: float = 1e-06
    # Uncertainty parameter for zero rotation update aka ZRUPT. Sets gyroscope bias to given
    # sample.
    rotationZuptR: float = 1e-06
    # Uncertainty parameter for ZUPT where the variance is scaled by expired time since start of
    # session.
    initZuptR: float = 0.0001
    # is visual ZUPT enabled in odometry
    useVisualStationarity: bool = True
    # How many consecutive non-keyframes (frames that look stationary to tracker) are needed to
    # trigger the visual ZUPT
    visualStationarityFrameCountThreshold: int = 3
    # Uncertainty parameter for ZUPT used on visual stationarity the smaller, the stronger the
    # update
    visualZuptR: float = 1e-07
    # gravity vector length TODO Is this the best estimate for the local value?
    gravity: float = 9.819
    # odometry EKF noise parameters all of these are standard deviations, not variances initial
    # position uncertainty (standard deviation, meters)
    noiseInitialPos: float = 1e-05
    # initial orientation uncertainty (standard deviation) sqrt(1e-4 * 10) = 0.01 * 3.16227766
    noiseInitialOri: float = 0.0316227766
    # initial velocity uncertainty (standard deviation, m/s)
    noiseInitialVel: float = 0.1
    # initial position trail uncertainty (standard deviation, meters)
    noiseInitialPosTrail: float = 100.0
    # initial orientation trail uncertainty (standard deviation) sqrt(10) = 3.16227766
    noiseInitialOriTrail: float = 3.16227766
    # initial BGA uncertainty (standard deviation, 0 to disable)
    noiseInitialBGA: float = 0.001
    # initial BAA uncertainty (standard deviation, 0 to disable)
    noiseInitialBAA: float = 1e-06
    # initial BAT uncertainty (standard deviation, 0 to disable)
    noiseInitialBAT: float = 1e-05
    # initial SFT uncertainty (standard deviation)
    noiseInitialSFT: float = 1e-05
    # acc process noise (standard deviation)
    noiseProcessAcc: float = 0.003
    # gyro process noise X (standard deviation)
    noiseProcessGyro: float = 0.00017
    # BAA process noise (standard deviation, 0 to disable)
    noiseProcessBAA: float = 0.0001
    # BGA process noise (standard deviation, 0 to disable)
    noiseProcessBGA: float = 0.0
    # BAA mean reversion rate. Has effect only if noiseProcessBAA > 0. (0 to disable)
    noiseProcessBAARev: float = 0.1
    # BGA mean reversion rate. Has effect only if noiseProcessBGA > 0. (0 to disable)
    noiseProcessBGARev: float = 0.1
    # Esimate IMU-to-camera time shift (SFT) in the EKF.
    estimateImuCameraTimeShift: bool = True
    # Seed for odometry pseudo random number generators
    rngSeed: int = 0
    # If greater than 0, odometry will run in its own thread with this maximum number of
    # unprocessed (gyro/synced) samples in the buffer
    processingQueueSize: int = 0
    # Represents a 4x4 homogeneous matrix in column-major format NOTE: If the video data has been
    # rotated at some point (cv::rotate or equivalent) this matrix needs to change accordingly,
    # e.g., 0,-1,0,-1,0,0,0,0,-1. There also exists a conmmand-line parameter:
    # videoRotation=NONE|CW90|CW180|CW270 that applies the appropriate modifications (see
    # parameters_base.cpp) For backwwards compatiblity, also accepts a 3x3 matrix in column-major
    # format.
    imuToCameraMatrix: Tuple[float, ...] = (1,0,0,0,-1,0,0,0,-1)
    # The 4x4 IMU to camera matrix for the second camera. If set to "0", the First IMU to camera
    # matrix is used to compute this matrix. If set to a 4x4 homogeneous matrix, the
    # "stereoCameraTranslation" is ignored. If 3x3 or smaller, then "stereoCameraTranslation" is
    # used for the translation part
    secondImuToCameraMatrix: Tuple[float, ...] = (0,)
    # t - translation between two cameras
    stereoCameraTranslation: Tuple[float, ...] = (0.0075,0.013,-0.0003)
    # Add this amount to IMU timestamp to get camera timestamp corresponding to same wall clock.
    imuToCameraShiftSeconds: float = 0.0
    secondImuToCameraShiftSeconds: float = 0.0
    # Reset in the beginning until init succeeds
    resetUntilInitSucceeds: bool = False
    # Reset tracking if it fails
    resetOnFailedTracking: bool = False
    # Reset after tracking fails to initialize after LOST_TRACKING for X seconds
    resetAfterTrackingFailsToInitialize: float = 3.0
    # Freeze output pose when tracking fails
    freezeOnFailedTracking: bool = False
    # Required share of "good frames" where visual tracking succeeds
    goodFramesToTracking: float = 0.75
    goodFramesToTrackingFailed: float = 0.05
    # Time window for calculating share of "good frames"
    goodFramesTimeWindowSeconds: float = 2.0
    # Number of clockwise 90 degree rotations to display window. This is also set in the stored
    # parameters of benchmark sessions. Therefore not set in cmd_parameter_definition.json
    rot: int = 1
    # tolerate missing frames in data JSONL. Command-line-only flag but useful to set in
    # parameters.txt and hence defined here
    allowSkippedFrames: bool = False
    # If true, output first camera pose instead of IMU pose.
    outputCameraPose: bool = False
    # Output extra data such as biases in JSONL produced by `-outputPath`.
    outputJsonExtras: bool = False
    outputJsonPoseTrail: bool = False
    # Output buffer size for compensating for uneven frame processing rate not really a part of
    # odometry but rather API
    targetOutputDelaySeconds: float = 0.0
    # Print statistics about how tracker tracks are processed by the odometry.
    printVisualUpdateStats: bool = False
    # TPU extension (not in the reference): carry the covariance as a Cholesky-style square-root
    # factor P = W W^T, propagated by QR (predict/augment) and updated via the triangular
    # pre-array method. Bounds the covariance dynamic range so the filter stays accurate in
    # float32; the reference instead relies on float64 Joseph-form updates
    # (ekf.cpp:848-885,1024-1067).
    useSquareRootEkf: bool = False


@dataclass
class ParametersTracker:
    # Maximum movement of features on screen to consider the device visually stationary.
    visualStationarityMovementThreshold: float = 3.0
    # Minimum fraction of RANSAC-2 inliers on screen to consider the device visually stationary.
    visualStationarityScoreThreshold: float = 0.95
    # Use odometry poses and camera parameters to predict and guide optical flow computation.
    predictOpticalFlow: bool = True
    # If true, compute optical flow for right frame from previous right frame. If false, compute
    # from left frame.
    independentStereoOpticalFlow: bool = False
    # Cutoff beyond which to trust triangulation results.
    predictOpticalFlowMinTriangulationDistance: float = 3.0
    # Reject stereo LK matches that are further than this from the epipolar curve (-1 = disabled.
    # in scale units = min dim / 720)
    maxStereoEpipolarDistance: float = 10.0
    # fps to target with frame subsampling
    targetFps: float = 30.0
    # Camera focal length in pixels (-1 = set automatically). If set, applies to both fx and fy
    # The alternative is settings focalLengthX and focalLengthY separately.
    focalLength: float = -1.0
    # Focal length X. Do not set both this and focalLength
    focalLengthX: float = -1.0
    # Focal length Y. Do not set both this and focalLength
    focalLengthY: float = -1.0
    # principal point X (-1 = set automatically)
    principalPointX: float = -1.0
    # principal point Y (-1 = set automatically)
    principalPointY: float = -1.0
    # second camera focal length in pixels (-1 = set automatically)
    secondFocalLength: float = -1.0
    secondFocalLengthX: float = -1.0
    secondFocalLengthY: float = -1.0
    # second camera principal point X (-1 = set automatically)
    secondPrincipalPointX: float = -1.0
    # second camera principal point Y (-1 = set automatically)
    secondPrincipalPointY: float = -1.0
    # Use an equidistant fisheye instead of the pinhole camera model
    fisheyeCamera: bool = False
    # Valid field-of-view angle for the (fisheye) camera, degerees This is required since (LK)
    # feature tracking does not generally work near the extremely distorted fisheye image
    # boundaries
    validCameraFov: float = 140.0
    # Non-linear camera calibration parameters. The interpretation depends on the camera model
    # (fishey vs pinhole). Set to 0 (= a vector of length 1) for no distortion
    distortionCoeffs: Tuple[float, ...] = (0,)
    # Distortion coefficients for the second camera in stereo mode
    secondDistortionCoeffs: Tuple[float, ...] = (0,)
    # max number of feature tracks
    maxTracks: int = 200
    # Use a large enough number when collecting statistics (e.g. 50). NOTE: must be at least
    # cameraTrailLength+1
    maxTrackLength: int = 21
    # Tracker RANSAC parameters.
    useHybridRansac: bool = True
    # maximum iterations for custom RANSAC implementation
    ransacMaxIters: int = 75
    # Logic for deciding whether to use RANSAC2 or RANSAC5.
    ransac2InliersToSkipRansac5: float = 0.9
    # Logic for deciding whether to use RANSAC2 or RANSAC5.
    ransac2InliersOverRansac5Needed: float = 0.9
    # threshold parameter for RANSAC2 (in scale units = min dim / 720)
    ransac2Threshold: float = 4.0
    # threshold parameter for RANSAC5
    ransac5Threshold: float = 2.0
    # probability parameter for RANSAC5
    ransac5Prob: float = 0.999
    # minimum inlier fraction threshold for RANSAC2 and RANSAC5
    ransacMinInlierFraction: float = 0.3
    # Theia RANSAC5 parameters
    useTheiaRansac5: bool = False
    theiaRansac5ErrorThresh: float = 5e-05
    theiaRansac5FailureProbability: float = 0.0001
    theiaRansac5MaxIterations: int = 500
    theiaRansac5MinIterations: int = 50
    theiaRansac5UseMle: bool = True
    # Theia RANSAC3 parameters
    useRansac3: bool = True
    ransac3ErrorThresh: float = 0.0001
    ransac3FailureProbability: float = 0.0001
    ransac3MaxIterations: int = 500
    ransac3MinIterations: int = 50
    ransac3UseMle: bool = True
    # "stereo upright 2p" parameters
    useStereoUpright2p: bool = False
    ransacStereoUpright2pErrorThresh: float = 0.0001
    ransacStereoUpright2pFailureProbability: float = 0.0001
    ransacStereoUpright2pMaxIterations: int = 500
    ransacStereoUpright2pMinIterations: int = 50
    ransacStereoUpright2pUseMle: bool = True
    # Seed for tracker ransac pipeline pseudo random number generator
    ransacRngSeed: int = 4649
    # feature selection mask radius as a fraction of the smaller image dimension
    relativeMaskRadius: float = 0.0667
    # feature detector options: GPU-GFTT, FAST, GFTT
    featureDetector: str = 'GPU-GFTT'
    # GFTT parameters GFFT quality level
    gfttQualityLevel: float = 0.01
    # GFFT min distance (in scale units = smaller dim / 720)
    gfttMinDistance: float = 50.0
    # GFFT block size
    gfttBlockSize: int = 3
    # GFFT K parameter (only used by Legacy & Harris detectorss?)
    gfttK: float = 0.04
    # Reject features with too low corner response. Unlike gfttQualityLevel, this is not relative
    # to any "max response" but in similar units as pyrLKMinEigThreshold
    gfttMinResponse: float = 0.001
    # Corner sub-pixel refinement parameters cornerSubPix window size
    subPixWindowSize: int = 10
    # cornerSubPix max iterations
    subPixMaxIter: int = 20
    # cornerSubPix epsilon (termination criterion)
    subPixEpsilon: float = 0.03
    # Pyramidal LK parameters pyramidal LK: max level
    pyrLKMaxLevel: int = 3
    # pyramidal LK: window size
    pyrLKWindowSize: int = 31
    # pyramidal LK: max iterations
    pyrLKMaxIter: int = 20
    # pyramidal LK: epsilon (termination criterion)
    pyrLKEpsilon: float = 0.03
    # pyramidal LK: min eigenvalue threshold
    pyrLKMinEigThreshold: float = 0.001
    displayMaxTrackLength: int = 10
    # stereo mode parameters
    useStereo: bool = False
    leftCameraId: int = 0
    rightCameraId: int = 1
    partOfImageToDetectFeatures: float = 1.0
    # enable image rectification
    useRectification: bool = False
    rectificationZoom: float = 1.0
    computeDenseStereoDepth: bool = False
    computeStereoPointCloud: bool = False
    # The stride using which the depth image is traversed/downsampled (applies to both x and y
    # coordinates). Usually a good idea to set this to something like 5-20
    stereoPointCloudStride: int = 5
    # * Tracker code doesn't have access to the command line parameters. Copy feature positions to
    # enable an optical flow visualization. Automatically enabled by the command line parameters
    # `-flow` and `-flow2` and meaningless without it.
    # one of: NONE, PREDICT, COMPARE, FAILURES
    saveOpticalFlow: str = 'NONE'
    # Save data for stereo epipolar visualization, set via cmd parameter
    # `displayStereoEpipolarCurves`.
    # one of: NONE, TRACKED, DETECTED, FAILED
    saveStereoEpipolar: str = 'NONE'
    # Process input video using ffmpeg. Set here to allow use in `parameters.txt` and in
    # benchmarks.
    ffmpeg: bool = False
    # Video filters to apply to input video. Requires -ffmpeg.
    vf: str = ''
    # use own threads for video reading (faster and utilizes more CPU cores)
    videoReaderThreads: bool = True
    # convert video to grayscale in VideoReader threads (can increase performance)
    convertVideoToGray: bool = False
    # Match grayscale pixel intensities of stereo frames to ease visual tracking between them.
    matchStereoIntensities: bool = False
    matchSuccessiveIntensities: float = 0.0


@dataclass
class ParametersSlam:
    # enable SLAM (also remember the USE_SLAM CMake flag)
    useSlam: bool = False
    slamThread: bool = True
    maxKeypoints: int = 1000
    # minimum number of map point matches for a loop closure
    minLoopClosureFeatureMatches: int = 6
    loopClosureRansacMinInliers: int = 5
    loopClosureRansacIterations: int = 100
    # Require tringulation for features before counting them for loop closures
    requireTringulationForLoopClosures: bool = False
    # Threshold for matching features based on descriptors. In interval [0, 1], smaller is more
    # strict.
    loopClosureFeatureMatchLoweRatio: float = 0.7
    # Maximum accumulated drift in meters per second allowed before loop closure will be rejected
    maximumDriftMetersPerSecond: float = 0.1
    # Maximum accumulated drift in radians per second allowed before loop closure will be rejected
    maximumDriftRadiansPerSecond: float = 0.01
    # Maximum accumulated drift in meters per meters traveled allowed before loop closure will be
    # rejected
    maximumDriftMetersPerTraveled: float = 0.1
    # Maximum accumulated drift in radians per meters traveled allowed before loop closure will be
    # rejected
    maximumDriftRadiansPerTraveled: float = 0.01
    loopClosureRansacFixScale: bool = True
    loopClosureInlierThreshold: float = 0.02
    # In addition to detecting loop closures, use them to correct the map.
    applyLoopClosures: bool = False
    # Do local bundle adjustment on new keyframe.
    applyLocalBundleAdjustment: bool = True
    # reprojection error threshold, relative to image size
    relativeReprojectionErrorThreshold: float = 0.02
    # was hardcoded as 0.2 in OpenVSLAM. The original Japanese commnt said that was equivalent to
    # 2 pixesls on a 90deg FOV camera with resolution 900px.
    epipolarCheckThresholdDegrees: float = 2.0
    # minimum number of observation from different keyframes until a map point is accepted for
    # (local) Bundle Adjustment
    minObservationsForBA: int = 3
    # Don't cull map points younger than this, so they have enough time to gather observations
    minMapPointCullingAge: float = 0.4
    # skip BA unless these criteria are met
    minKeyframesInBA: int = 3
    minVisibleMapPointsInCurrentFrameBA: int = 100
    minVisibleMapPointsInNeighborhoodBA: int = 150
    minVisibleMapPointsInForNonKeyframeBA: int = 50
    nonKeyFramePoseAdjustment: bool = True
    # Number of keyframes searched over in most SLAM tasks, excluding BA.
    adjacentSpaceSize: int = 20
    # Number of keyframes considered in local BA.
    localBAProblemSize: int = 20
    # Number of keyframes considered in local BA after a loop closure.
    loopClosureLocalBAProblemSize: int = 40
    globalBAIterations: int = 20
    poseBAIterations: int = 5
    # How much to rely on odometry poses in SLAM. Used as a prior for the relative pose between
    # consecutive keyframes in bundle adjustment
    odometryPriorStrengthPosition: float = 500.0
    odometryPriorStrengthRotation: float = 5000.0
    odometryPriorSimpleUncertainty: bool = False
    odometryPriorFixed: bool = True
    # Number of covisible map points needed before keyframes are considered neighbours in the SLAM
    # pose graph
    minNeighbourCovisiblitities: int = 10
    # add keyframe every N frames
    keyframeCandidateInterval: int = 8
    # When enabled, slam is split into light frontend and heavy backend, and slam map is copied
    # from backend to frontend periodically
    useFrontendSlam: bool = False
    # Copies SLAM map from backend to frontend every N SLAM frames... which typically occur every
    # few frames, depending other settings
    copySlamMapEveryNSlamFrames: int = 2
    # Delays backend slam processing by N frames and uses latest odometry pose trail information
    backendProcessDelay: int = 0
    # Copy only partial map to frontend
    copyPartialMapToFrontend: bool = True
    # When true slam map is copied at fixed frames to ensure deterministic outcome
    deterministicSlamMapCopy: bool = True
    # how many times keyframeCandidateInterval we delay the slam calculations to get better pose
    # trail from odometry, keyframeCandidateInterval=4 delayIntervalMultiplier=2 => 8 frames
    # Crashes unless cameraTrailLength > keyframeCandidateInterval * (delayIntervalMultiplier + 1)
    delayIntervalMultiplier: int = 1
    # Do not let the PIVO -> SLAM transformations tilt the z-axis
    removeOdometryTransformZAxisTilt: bool = True
    # When enabled, uses delta between odometry posetrail for odometry priors
    useOdometryPoseTrailDelta: bool = False
    # Use variable-length odometry deltas
    useVariableLengthDeltas: bool = False
    # skip keyframe decision logic (always true)
    keyframeDecisionAlways: bool = False
    # minimum time between two accepted keyframes
    keyframeDecisionMinIntervalSeconds: float = 0.2584
    # if less than this many map points in common (ratio), add keyframe
    keyframeDecisionCovisibilityRatio: float = 0.7
    # if at moved at least this much since the last keyframe (meters), add keyframe
    keyframeDecisionDistanceThreshold: float = 0.15
    keyframeCullMaxCriticalRatio: float = 0.15
    keyframeCullEnabled: bool = True
    cullMapPoints: bool = True
    # path to the ORB vocabulary file that has to be loaded on startup
    vocabularyPath: str = '../data/orb_vocab.dbow2'
    # Ratio for specifying min number of inliers required in getBowSimilar inliers_required =
    # bowMinInCommonRatio * max_inliers
    bowMinInCommonRatio: float = 0.3
    # Ratio for specifying min score required in getBowSimilar score_required = bowScoreRatio *
    # best_score
    bowScoreRatio: float = 0.5
    # Minimum allowed triangulation angles in SLAM for two and many-view cases
    minTriangulationAngleTwoObs: float = 1.0
    minTriangulationAngleMultipleObs: float = 2.0
    # Move part of the map rigidly before graph optimization when doing a loop closure.
    loopClosureRigidTransform: bool = False
    # Apply global Bundle Adjustment after a loop closure
    globalBAAfterLoop: bool = False
    # Orb feature parameters
    orbScaleLevels: int = 8
    orbScaleFactor: float = 1.2
    orbInitialFastThreshold: int = 20
    orbMinFastThreshold: int = 7
    orbLkTrackLevel: int = 2
    orbExtraKeyPoints: bool = True
    useGpuImagePyramid: bool = False
    # valid choices for the SLAM ORB feature detector * all choices for tracker.featureDetector *
    # empty string means "same as tracker.featureDetector"
    slamFeatureDetector: str = ''
    # * SLAM code doesn't have access to the command line parameters. Width of keyframe ASCII
    # visualization in terminal characters.
    kfAsciiWidth: int = 200
    # Enable keyframe ASCII visualization for local BA.
    kfAsciiBA: bool = False
    # Enable keyframe ASCII visualization for "adjacent" keyframes.
    kfAsciiAdjacent: bool = False
    # Print statistics about attempted loop closures.
    printLoopCloserStats: bool = False
    # Print statistics about bundle adjustments.
    printBaStats: bool = False


@dataclass
class Parameters:
    odometry: ParametersOdometry = field(default_factory=ParametersOdometry)
    tracker: ParametersTracker = field(default_factory=ParametersTracker)
    slam: ParametersSlam = field(default_factory=ParametersSlam)

    def set_parameter(self, group: str, name: str, value):
        """Set one parameter from a (typed or string) value, with type coercion."""
        sub = getattr(self, group)
        cur = getattr(sub, name)  # raises AttributeError for unknown keys
        setattr(sub, name, _coerce(type(cur), value))


def _coerce(t, value):
    if isinstance(value, t) and t is not bool:
        return value
    if t is bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in ("true", "1", "yes", "on"):
            return True
        if s in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"not a bool: {value!r}")
    if t is tuple:
        if isinstance(value, (list, tuple)):
            return tuple(float(x) for x in value)
        return tuple(float(x) for x in str(value).split(","))
    if t is int:
        return int(round(float(value)))
    return t(value)


def parameter_names():
    out = []
    p = Parameters()
    for g in ("odometry", "tracker", "slam"):
        for f in fields(getattr(p, g)):
            out.append(f"{g}.{f.name}")
    return out
