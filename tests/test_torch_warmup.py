"""The port's warmup tool (``gs360x_torch.tools.warmup``) against
``gs360x.tools.warmup`` on the CPU.

The parser takes the JAX tool's flags with the same defaults and choices,
plus ``--device`` (``cuda`` by default; without a card it raises, no CPU
fallback). ``main`` visits the same (preset view set × interp) combinations,
de-duplicated by view key, and says so in the same ``[OK]`` lines: at a small
source with the warp run, and with ``--all`` at the JAX tool's own sizes,
where the warp and the remap are replaced by recorders in both packages (an
8K frame and 3600² fisheye views are the card's work). ``warm_remap`` at a
small size gives the JAX remap's outputs at the remap gate, 1e-5."""

import argparse
import io
import re
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.kernels import remap_pallas
from gs360x.kernels import warp as jax_warp
from gs360x.runtime import executor as jexec
from gs360x.tools import warmup as jwarm
from gs360x_torch.kernels import remap_cuda, warp_cuda
from gs360x_torch.runtime import executor as texec
from gs360x_torch.tools import warmup as twarm

REMAP_TOL = 1e-5


def _actions(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_parser_against_jax():
    jax_actions = _actions(jwarm.build_arg_parser())
    port = _actions(twarm.build_arg_parser())
    assert port.pop("device") == (("--device",), "cuda", ["cuda", "cpu"],
                                  None)
    assert port == jax_actions
    argv = ["--src", "5760x2880", "--size", "1600", "2048", "--preset",
            "fisheyelike", "fisheyeXY", "--interp", "bicubic", "bilinear",
            "--all"]
    assert vars(twarm.build_arg_parser().parse_args(argv)) == {
        **vars(jwarm.build_arg_parser().parse_args(argv)), "device": "cuda"}


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twarm.main(["--src", "64x32", "--size", "16"])


def _run(main, argv) -> list:
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _ok_lines(lines) -> list:
    """The [OK] lines without their seconds."""
    return [re.sub(r" in [0-9.]+s.*", "", ln) for ln in lines
            if ln.startswith("[OK]")]


def test_main_visits_the_jax_combinations_on_the_cpu(monkeypatch, tmp_path):
    """A 256×128 source at size 64, three presets (``2views``' default
    and explicit sizes differ; ``fisheyeXY`` is two fisheye views), both
    interps: the same combinations in the same order, the port's each
    warped once on the CPU (its plain versions, no kernel launch)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    argv = ["--src", "256x128", "--size", "64", "--preset", "default",
            "2views", "fisheyeXY", "--interp", "bicubic", "bilinear"]
    jlines = _run(jwarm.main, argv)
    warp_cuda.reset_counters()
    tlines = _run(twarm.main, argv + ["--device", "cpu"])
    assert tlines[0] == "[INFO] device: cpu  source 256x128"
    assert _ok_lines(tlines) == _ok_lines(jlines)
    assert _ok_lines(tlines)[-1] == "[OK] warmed 6 configuration(s)"
    assert warp_cuda.LAUNCHES == {"planarize": 0, "warp": 0}
    assert warp_cuda.PLAIN_CALLS["warp"] == 6


def test_all_visits_the_jax_combinations(monkeypatch, tmp_path):
    """``--all --size 1600 2048``: every preset at its own default size
    plus the two explicit sizes, de-duplicated by view key, and the remap
    first, in both packages; each warp call gets the same views, interp
    and quantize bits."""
    monkeypatch.setenv("HOME", str(tmp_path))
    calls = {"jax": [], "torch": []}

    def recorder(name):
        def warp(frame, views, *, interp, backend, quantize_bits,
                 device=None, keep_rec709=None):
            calls[name].append((frame.shape, [
                (v.view_id, v.yaw_deg, v.pitch_deg, v.roll_deg, v.width,
                 v.height, v.hfov_deg, v.projection) for v in views],
                interp, backend, quantize_bits))
            return []
        return warp

    monkeypatch.setattr(jexec, "_warp_frame_views", recorder("jax"))
    monkeypatch.setattr(texec, "_warp_frame_views", recorder("torch"))
    remaps = []
    monkeypatch.setattr(jwarm, "warm_remap",
                        lambda **kw: remaps.append(("jax", kw)))
    monkeypatch.setattr(twarm, "warm_remap",
                        lambda **kw: remaps.append(
                            ("torch", {k: v for k, v in kw.items()
                                       if k != "device"})))
    argv = ["--src", "64x32", "--all", "--size", "1600", "2048"]
    jlines = _run(jwarm.main, argv)
    tlines = _run(twarm.main, argv + ["--device", "cpu"])
    assert _ok_lines(tlines) == _ok_lines(jlines)
    assert calls["torch"] == calls["jax"]
    assert len(calls["torch"]) == int(_ok_lines(tlines)[-1].split()[2]) > 7
    assert remaps == [("jax", {"src_size": 3840}),
                      ("torch", {"src_size": 3840})]


def test_warm_remap_against_jax(monkeypatch, tmp_path):
    """The first SFM10 view of the default calibration at 64 px (its maps
    address a 3840² lens), bicubic then bilinear: the port's outputs, each
    computed by its plain version on the CPU, within 1e-5 of the JAX
    tool's remap run through the JAX package's plain reference
    (``gs360x.kernels.warp.remap`` on the lens / 255, as
    ``tests/test_torch_remap.py`` holds the port; the Pallas kernel's own
    window budget takes no view this small, and its interpret mode takes a
    minute at 1750 px). Both tools warm on a zero lens; here each call's
    lens is replaced by one seeded lens of the same shape, so the maps'
    taps meet values."""
    monkeypatch.setenv("HOME", str(tmp_path))
    size, px = 3840, 64
    lens = (np.random.default_rng(5).random((size, size * 3)) * 255
            ).astype(np.uint8)
    got_jax = []

    class PlainPrepared:
        """``remap_pallas.PreparedRemap``'s interface over the plain
        reference."""

        def __init__(self, map_x, map_y, valid=None, *, src_w, src_h):
            assert (src_w, src_h) == (size, size)
            self.maps = [jnp.asarray(m) for m in (map_x, map_y, valid)]

        def __call__(self, frame, *, interp="bilinear", fill=0.0):
            assert frame.shape == lens.shape and not frame.any()
            src = lens.reshape(size, size, 3).astype(np.float32) / 255.0
            out = jax_warp.remap(jnp.asarray(src), *self.maps[:2],
                                 interp=interp, valid=self.maps[2],
                                 fill=fill)
            got_jax.append(np.asarray(out).transpose(2, 0, 1))
            return out

    monkeypatch.setattr(remap_pallas, "PreparedRemap", PlainPrepared)
    call = remap_cuda.PreparedRemap.__call__

    def with_lens(self, frame, **kw):
        assert frame.shape == lens.shape and not frame.any()
        return call(self, lens, **kw)

    monkeypatch.setattr(remap_cuda.PreparedRemap, "__call__", with_lens)
    jwarm.warm_remap(src_size=size, view_px=px)
    remap_cuda.reset_counters()
    got = twarm.warm_remap(src_size=size, view_px=px,
                           device=torch.device("cpu"))
    assert remap_cuda.PLAIN_CALLS["remap"] == 2
    assert remap_cuda.LAUNCHES["remap"] == 0
    assert len(got) == len(got_jax) == 2
    for port, ref in zip(got, got_jax):
        assert port.shape == ref.shape == (3, px, px)
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(port, ref, rtol=0, atol=REMAP_TOL)
