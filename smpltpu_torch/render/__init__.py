"""Mesh rendering (port of ``smpltpu/render``): the host painter
(``raster``) and the on-device z-buffer K3 (``zbuffer``)."""

from smpltpu_torch.render.raster import render_mesh_overlay  # noqa: F401
from smpltpu_torch.render.zbuffer import (  # noqa: F401
    face_setup,
    rasterize,
    rasterize_torch,
    rasterize_verts,
)
