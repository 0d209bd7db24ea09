"""gs360x_torch — the PyTorch / CUDA (NVIDIA Hopper) port of :mod:`gs360x`.

The JAX package stays the reference; this package mirrors its layout and
names so each module's counterpart is easy to find:

- :mod:`gs360x_torch.core`    — camera rays, the angle helper, video colour
- :mod:`gs360x_torch.rig`     — view plan datatypes, presets and grammar
- :mod:`gs360x_torch.kernels` — the plain torch warp twin, the hand-written
  CUDA kernels (``csrc/``) and their build
- :mod:`gs360x_torch.runtime` — the RenderPlan executor
- :mod:`gs360x_torch.tools`   — CLI entry points (``--device {cuda,cpu}``)

The package imports ``torch`` and never ``jax``. Host modules of
:mod:`gs360x` that are themselves JAX-free (``gs360x.io.image``,
``gs360x.io.video``, ``gs360x.runtime.profiling``,
``gs360x.runtime.cancel``, ``gs360x.native``) are reused by import.
"""

__version__ = "0.1.0"
