"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:
K1 the arrowhead PCG solve (``cg``), K2 blendshapes + skinning (``lbs``),
K4 the online LM trip's linearization (``online``, CUDA only), K5 its
trust-region step (``trust_region``); K3, the z-buffer rasterizer, lives
with the render stage (``smpltpu_torch/render/zbuffer.py``).

``LAUNCHES`` counts kernel launches by wrapper name ("arrow_pcg", "lbs",
"raster", and "raster_setup" where K3 also ran its per-face setup,
"online_normal", "tr_step"; K1 also under "arrow_pcg@{W}x{F}", by system
shape, K4 under "online_normal@linearize" and "online_normal@cost", by
mode): each wrapper adds one where it launches its kernel and nowhere
else, so a run can show that it went through the kernels. A launch
recorded into a CUDA graph counts once per replay where the graph's owner
replays it (``solve/online.py::OnlineGraph``)."""

from collections import Counter

LAUNCHES: Counter = Counter()
