"""smpltpu_torch — the PyTorch/CUDA port of :mod:`smpltpu` for NVIDIA Hopper.

The JAX package ``smpltpu/`` stays the reference; every module here has its
twin at the same relative path there (``smpltpu_torch/solve/multi_frame.py``
ports ``smpltpu/solve/multi_frame.py``, and so on). This package imports
``torch`` and never ``jax``, and nothing of the reference package either:
what it needs from the reference's JAX-free modules is copied
(``constants.py``, ``render/raster.py``, ``models/synthetic.py``).

The slices ported so far: the fused two-stage multi-frame fit (stage-1
anchors, in-graph interpolation, batched stage-2 windows) with the
arrowhead PCG solve in a hand-written CUDA kernel (``ops/cg.py``), then
write-back, skinning through a CUDA LBS kernel (``ops/lbs.py``) and the
render of every frame through a CUDA z-buffer (``render/zbuffer.py``).

Precision: the port runs in float32 on the card and float64 in the CPU
tests. TF32 is switched off here, once, for matmuls and cuDNN: the
arrowhead solve is sensitive to matvec precision (lower-precision matvecs
move the fitted residual, BASELINE.md).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
