from .state import (  # noqa: F401
    BAA, BAT, BGA, CAM, INER_DIM, MAP_POINT_DIM, ORI, POS, POSE_DIM, Q_ACC,
    Q_BAA_DRIFT, Q_BGA_DRIFT, Q_DIM, Q_GYRO, SFT, VEL, EKFState, init_state,
    process_noise_q, state_dim,
)
from .predict import make_predict, predict_mean_and_jacobians, process_noise_diag  # noqa: F401
from .update import (  # noqa: F401
    VisualUpdateResult, kf_update, normalize_quaternions, update_pseudo_velocity,
    update_zupt, update_zupt_initialization, visual_track_gate, visual_track_update,
)
from .augment import augment_pose, undo_augmentation  # noqa: F401
from .transforms import (  # noqa: F401
    MAP_POINT_PRIOR_STD, condition_on_last_pose, initialize_orientation, insert_map_point,
    lock_biases, transform_to, translate_to,
)
from .chi2 import CHI2INV95  # noqa: F401
