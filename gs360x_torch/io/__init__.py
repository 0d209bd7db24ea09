"""Host-side IO of the port: images, video, point clouds and the camera
formats. Everything here feeds or drains the device pipeline; nothing
computes on pixels (that is :mod:`gs360x_torch.kernels`). An ffmpeg-backed
video reader is used when ffmpeg is on PATH, with pure-Python Y4M /
MJPEG-AVI codecs as the always-available fallback.
"""
