"""GMM pose-prior text-format parser: a copy of ``smpltpu/io/gmm.py``,
which the port may not import; pinned against it by
``tests/test_torch_cli.py``.

The reference stores an 8-component, 69-dimensional Gaussian mixture pose
prior as a text file (data/avatar-model/pose_prior.txt) whose format is
defined by the converter scripts/convert_gmm_to_avatar.py:16-29:

    line 1: "K D"
    line 2: K mixture weights
    next K lines: component means (D values each)
    next K lines: row-major D x D covariance matrices (D*D values each)

The consumer contract (``ark::GaussianMixture``) is documented at
include/Sim3BA.h:246-249: expose ``prec_cho`` — per-component L with
Precision = L @ L.T — plus a whitened residual. The numeric contract of
``residual()`` itself lives in the reference's ``smpltpu/energy/priors.py`` (the avatar
submodule is not checked out in the reference, so its exact constant-row
convention is re-derived there and documented).
"""

from __future__ import annotations

import numpy as np


def load_pose_prior_txt(path: str, dtype=np.float64) -> dict:
    """Parse the avatar pose-prior text format.

    Returns a dict with:
      weights   (K,)
      means     (K, D)
      covs      (K, D, D)
      prec_cho  (K, D, D)  lower-triangular L with  inv(cov) = L @ L.T
      logdet_cov (K,)
    """
    with open(path) as f:
        tokens_header = f.readline().split()
        k, d = int(tokens_header[0]), int(tokens_header[1])
        weights = np.array(f.readline().split(), dtype=np.float64)
        assert weights.shape == (k,), f"expected {k} weights, got {weights.shape}"
        means = np.array([f.readline().split() for _ in range(k)], dtype=np.float64)
        assert means.shape == (k, d)
        covs = np.array(
            [np.array(f.readline().split(), dtype=np.float64).reshape(d, d) for _ in range(k)]
        )

    prec = np.array([np.linalg.inv(c) for c in covs])
    # lower-triangular L with prec = L @ L.T
    prec_cho = np.array([np.linalg.cholesky(p) for p in prec])
    sign, logdet = np.linalg.slogdet(covs)
    assert np.all(sign > 0), "covariance matrices must be positive definite"
    return {
        "weights": weights.astype(dtype),
        "means": means.astype(dtype),
        "covs": covs.astype(dtype),
        "prec_cho": prec_cho.astype(dtype),
        "logdet_cov": logdet.astype(dtype),
    }


def save_pose_prior_txt(path: str, weights, means, covs) -> None:
    """Write a GMM in the avatar text format (scripts/convert_gmm_to_avatar.py:16-29)."""
    weights = np.asarray(weights, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    k, d = means.shape
    with open(path, "w") as f:
        f.write(f"{k} {d}\n")
        f.write(" ".join(map(repr, weights.tolist())) + "\n")
        for row in means:
            f.write(" ".join(map(repr, row.tolist())) + "\n")
        for c in covs:
            f.write(" ".join(map(repr, c.reshape(-1).tolist())) + "\n")
