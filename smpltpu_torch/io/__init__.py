"""Data IO (copies of ``smpltpu/io``): SMPL npz model loading, GMM
pose-prior parsing, MediaPipe keypoint JSON loading."""

from smpltpu_torch.io.smpl_npz import load_smpl_npz, save_smpl_npz, fix_kintree  # noqa: F401
from smpltpu_torch.io.gmm import load_pose_prior_txt, save_pose_prior_txt  # noqa: F401
from smpltpu_torch.io.keypoints import (  # noqa: F401
    load_mp_json,
    load_keypoint_dir,
    list_sorted,
)
