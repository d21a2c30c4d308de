"""SMPL body model (port of ``smpltpu/models``)."""

from smpltpu_torch.models.smpl import SMPLModel, rodrigues, smpl_forward  # noqa: F401
from smpltpu_torch.models.synthetic import (  # noqa: F401
    make_synthetic_gmm,
    make_synthetic_model,
)
