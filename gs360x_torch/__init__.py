"""gs360x_torch — the PyTorch / CUDA (NVIDIA Hopper) port of :mod:`gs360x`.

The JAX package stays the reference; this package mirrors its layout and
names so each module's counterpart is easy to find:

- :mod:`gs360x_torch.core`    — camera rays, the angle helper, colour
  curves, matrix moves and the ``.cube`` LUT
- :mod:`gs360x_torch.rig`     — view plan datatypes, presets and grammar
- :mod:`gs360x_torch.kernels` — the plain torch warp twin, the hand-written
  CUDA kernels (``csrc/``) and their build, sharpness metrics and optical
  flow
- :mod:`gs360x_torch.io`      — image, video and PLY files and the camera
  formats (Metashape XML, COLMAP text, transforms.json, RealityScan)
- :mod:`gs360x_torch.native`  — bindings of the C++ host library
- :mod:`gs360x_torch.runtime` — the RenderPlan executor, stage timers,
  cancellation and the memory throttle
- :mod:`gs360x_torch.tools`   — CLI entry points (``--device {cuda,cpu}``)

The package imports ``torch``, never ``jax``, and nothing of :mod:`gs360x`:
the host modules it shares with that package (image and video IO, the
camera formats, pose algebra) are its own copies under the same names.
"""

__version__ = "0.1.0"
