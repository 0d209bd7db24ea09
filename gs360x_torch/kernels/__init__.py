"""Warp kernels: the plain torch twin (:mod:`.warp`) and the hand-written
CUDA kernels with their wrappers (:mod:`.warp_cuda`, sources in
``gs360x_torch/csrc``, built by :mod:`._build` at first use)."""
