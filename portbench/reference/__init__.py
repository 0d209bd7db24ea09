"""The benchmark's plain reference, in plain PyTorch: the perspective cut
of an equirect frame (``equirect``), the SFM10 views of a calibrated
equisolid lens pair (``fisheye``), the ``.cube`` LUT decode (``cube``), and
the comparison that decides ``correct`` (``compare``).

It works everything out again from the inputs the benchmark made and from
its own copies of the tools' published tables (presets, the SFM10 layout,
the Osmo 360 calibration): it imports nothing of the program and takes
nothing that the program computed. Every function takes the float ``dtype``
it computes in: float64 is the reference, bfloat16 the control (the
precision below the float32 the kernels compute in).
"""
