"""Convert a SMPLify GMM pickle (gmm_08.pkl: means/covars/weights, K=8,
D=69) into the avatar pose-prior text format (the twin of
``scripts/convert_gmm_to_avatar.py``, on
``smpltpu_torch.io.save_pose_prior_txt``).

    python -m smpltpu_torch.tools.convert_gmm_to_avatar gmm_08.pkl pose_prior.txt

The text format (header 'K D', a weights line, K mean rows, K row-major
DxD covariance rows) round-trips through
``smpltpu_torch.io.load_pose_prior_txt``.
"""

import pickle
import sys

import numpy as np

from smpltpu_torch.io import save_pose_prior_txt


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("Usage:  convert_gmm_to_avatar.py  gmm_08.pkl  pose_prior.txt")
        return 1
    src, dst = argv[0], argv[1]

    with open(src, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    means = np.asarray(gmm["means"])
    covs = np.asarray(gmm["covars"]).reshape(means.shape[0], means.shape[1],
                                             means.shape[1])
    weights = np.asarray(gmm["weights"])
    assert means.shape[1] == 69, f"Expected 69-D pose, got {means.shape[1]}"
    save_pose_prior_txt(dst, weights, means, covs)
    print(f"pose prior written: {means.shape[0]} components, "
          f"{means.shape[1]} dims each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
