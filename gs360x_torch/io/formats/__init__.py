"""Camera/point format hub.

Canonical in-memory model = COLMAP (PINHOLE intrinsics, world→camera wxyz
quaternion + translation), mirroring the reference converter
(``cli_tools/gs360_CameraFormatConverter.py``). Importers
normalize every supported format into it; exporters derive every output
from it — one conversion graph hub instead of N² format pairs.

Formats: COLMAP text model, transforms.json (OpenGL c2w), RealityScan
CSV / XMP / PLY, Metashape perspective & spherical XML.
"""

from gs360x_torch.io.formats.model import (  # noqa: F401
    Camera, ColmapModel, Image, Point3,
)
from gs360x_torch.io.formats import (  # noqa: F401
    colmap_text, hub, metashape, realityscan, transforms_json,
)
