"""Camera, write-back and metric helpers (port of ``smpltpu/utils``)."""

from smpltpu_torch.utils.camera import default_intrinsics  # noqa: F401
from smpltpu_torch.utils.metrics import mean_pixel_error  # noqa: F401
from smpltpu_torch.utils.writeback import params_to_pose  # noqa: F401
