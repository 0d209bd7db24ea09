"""Kernels: the plain torch warp twin (:mod:`.warp`), the hand-written
CUDA kernels with their wrappers (:mod:`.warp_cuda`, :mod:`.remap_cuda`,
sources in ``gs360x_torch/csrc``, built by :mod:`._build` at first use),
and the FrameSelector's plain torch metrics (:mod:`.sharpness`,
:mod:`.flow`)."""
