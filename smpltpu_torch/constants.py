"""Constants of the fit, copied from ``smpltpu/constants.py``.

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_import.py`` pins every name here against the original.
The parity notes (reference source lines) are in the original.
"""

import numpy as np

# MediaPipe (33 landmarks) -> SMPL (24 joints): MP_MAP[smpl_jid] is the
# MediaPipe landmark index, or -1 where the joint is not observed.
MP_MAP = np.array(
    [-1, 23, 24, -1, 25, 26, -1, 27, 28, -1,
     31, 32, -1, -1, -1, 0, 11, 12, 13, 14,
     15, 16, -1, -1],
    dtype=np.int32,
)

# The SMPL joint ids used as keypoint observations, in the reference's
# 17-slot order: the pelvis (joint 0) fills the last two slots, so it is
# observed twice (SURVEY.md section 2.1).
USE_SMPL = np.array(
    [1, 2, 4, 5, 7, 8, 10, 11, 15, 16, 17, 18, 19, 20, 21, 0, 0],
    dtype=np.int32,
)

# Number of keypoint slots per frame in the dense layout.
N_KP_SLOTS = len(USE_SMPL)

# Joints held at zero rotation by the pose-only single-frame fit: MediaPipe
# never observes them (feet tips and hands).
FIXED_JOINTS_POSE_ONLY = (10, 11, 22, 23)

# Huber scale of the keypoint reprojection residuals.
HUBER_DELTA = 3.0

# Sim3 scale bounds.
SCALE_MIN = 0.3
SCALE_MAX = 3.0

# Keypoints with a lower MediaPipe visibility are dropped.
VISIBILITY_THRESHOLD = 0.5

# Pinhole intrinsics heuristic: f = 0.9*max(W,H), fx=fy, cx=W/2, cy=H/2.
FOCAL_FACTOR = 0.9

# Initial body placement: this many metres in front of the camera.
INIT_ROOT_DEPTH = 3.0

# Skeleton-edge table for keypoint visualizations. The reference declares
# this and never uses it (src/main_single_frame.cpp:32-37); kept for
# drop-in parity and available to plotting tools.
BONES = np.array(
    [[1, 2], [1, 4], [2, 5], [4, 7], [5, 8],
     [16, 17], [15, 16], [15, 17],
     [16, 18], [17, 19], [18, 20], [19, 21],
     [1, 16], [2, 17]],
    dtype=np.int32,
)

# SMPL topology dimensions (standard basicModel_{f,m}_lbs_10_207_0).
SMPL_NUM_JOINTS = 24
SMPL_NUM_SHAPES = 10
SMPL_NUM_VERTS = 6890
SMPL_NUM_FACES = 13776

# Canonical SMPL parent table (root's parent is -1).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21],
    dtype=np.int32,
)


def init_root_rotation() -> np.ndarray:
    """Initial root orientation R0 = yaw(pi) @ diag(1,-1,1): facing the
    camera with Y flipped (image Y grows downward)."""
    yaw_pi = np.array([[-1.0, 0.0, 0.0],
                       [0.0, 1.0, 0.0],
                       [0.0, 0.0, -1.0]])
    flip_y = np.diag([1.0, -1.0, 1.0])
    return yaw_pi @ flip_y
