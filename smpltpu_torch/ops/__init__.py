"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:
K1 the arrowhead PCG solve (``cg``), K2 blendshapes + skinning (``lbs``);
K3, the z-buffer rasterizer, lives with the render stage
(``smpltpu_torch/render/zbuffer.py``).

``LAUNCHES`` counts kernel launches by wrapper name ("arrow_pcg", "lbs",
"raster", and "raster_setup" where K3 also ran its per-face setup; K1 also
under "arrow_pcg@{W}x{F}", by system shape): each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that it went through the kernels."""

from collections import Counter

LAUNCHES: Counter = Counter()
