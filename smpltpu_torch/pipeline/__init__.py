"""Pipeline stages after the fit and the drivers (port of
``smpltpu/pipeline``): the CLIs ``single``, ``multi`` and ``stream``, the
one-command ``video`` driver and the library entry point ``fit_video``."""

from smpltpu_torch.pipeline.api import FitResult, fit_video  # noqa: F401
