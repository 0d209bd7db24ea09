"""Desktop GUI (Tkinter): tabbed front-end over the port's CLI tools.

The port's copy of the GUI, every module held to its counterpart in the
JAX package; the tools it launches and the preview it runs are the port's,
on the card. Rebuild of the reference ``gs360_GUI.py`` at the same
architectural seam: the GUI treats each tool's argv surface as its API and
launches tools as streamed subprocesses (reference ``:8949-9173``), with an
in-process preview for the 360PerspCut tab (view-footprint overlays on the
equirect panorama, ``:342-499``). Pure logic (argv builders, overlay math,
settings, process manager) lives in importable modules so it is testable
headlessly; only :mod:`gs360x_torch.gui.app` touches Tk.
"""
