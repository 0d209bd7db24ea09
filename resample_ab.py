#!/usr/bin/env python3
"""Device time of the image-mode resampling paths of ``gs360x_torch`` on one
NVIDIA GPU, for this checkout and for other checkouts of the port beside it,
measured in turns inside one process tree so that one card serves all.

    python3 resample_ab.py                          # this checkout alone
    python3 resample_ab.py --tree parent=build/parent [--tree name=dir ...]

A ``--tree`` is another checkout of the repository (for example ``git
archive <commit> | tar -x -C build/parent``; ``build/`` is not tracked).
Every tree is measured in its own subprocess, which builds that tree's
kernels and imports that tree's ``gs360x_torch`` and ``chip_smoke``: first
in the order given, this checkout last, then in the reverse order, so each
tree is measured twice and no tree always runs first.

For each of the eight u8 shapes of ``chip_smoke.py`` (six warp view sets of
an 8K u8 frame, the SFM10 remap batch and the undistort of a 3840² u8 lens
image), and for the two remaps over resident f32 planes (no source pass),
it times, with CUDA events around launches issued back to back:

* ``source``: the source pass of the u8 frame (``planarize.cu``: planes, or
  RGBX texels where the tree has ``warp_cuda.texelize_rows``);
* ``f32``: the resampling kernel storing f32;
* ``quantize``: the four-pass ``_quantize_device`` of that f32 output;
* ``u8``: the resampling kernel storing u8 (trees whose kernels take
  ``out_dtype``; null otherwise);
* ``path``: source pass + resample + quantize as the image-mode main path
  of that tree issues them.

It also hashes the f32 output and the path's u8 output of every shape, and
fails when a tree's hashes differ from this checkout's: the outputs are
bitwise the same across trees. ptxas's register counts and spills of the
warp and remap kernels are printed for trees that have
``_build.ptxas_report``. Results go to standard output, and with
``--out FILE`` every run's numbers to that file as JSON.

With ``--micro-ops`` it times ``micro_ops`` kernels instead, the
primitives ``--keys`` names (by default ``gather_lane8``, ``x[r, c] =
x[r, idx[r, c]] + 0.5`` 64 times over an (8,128) tile, in 2048 chains;
any of the 14, for example the two products ``matmul64,matmul8``, the
composite ``chunk``, ``concat``, ``loop``, ``where`` or ``mul8``), in the
same turns: the
kernel's device time a launch
without the wrapper's host time (events around a CUDA graph's replay of 10
launches, by this checkout's ``profiling.device_ms`` for every tree)
and its event time; its error against the plain version relative to
max|plain| at the depths of this checkout's ``micro_ops_cuda.CHECK_LOOPS``
(nominal loops for a key it does not name; a tree fails above the gate)
and the hash of its output there (it fails unless every tree's outputs are
bitwise this checkout's); for the products one cuBLAS f32 product of the
2048 blocks stacked, times 64, with TF32 off.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile

PRODUCTS = ("matmul64", "matmul8")
MICRO_KEYS = ("gather_lane8",)   # --micro-ops default
SHAPES = ("yaw ring 8x1920x1080", "default 8x1600²", "full360coverage 12x1600²",
          "fisheyeXY 2x3600²", "pole 1x1600²", "equisolid 1x2048²",
          "SFM10 10x1750²", "undistort 3840²",
          "SFM10 10x1750² f32 planes", "undistort 3840² f32 planes")


def _sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def measure() -> dict:
    """Runs inside one tree (the current directory): every shape's times
    and output hashes, the card, and ptxas's lines for the two kernels."""
    sys.path[0] = os.getcwd()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("resample_ab: torch.cuda.is_available() is False")
    import chip_smoke as cs
    from gs360x_torch.kernels import _build, remap_cuda, warp_cuda
    from gs360x_torch.runtime.executor import _quantize_device
    from gs360x_torch.runtime.profiling import cuda_ms
    from gs360x_torch.tools import dualfisheye

    dev = torch.device("cuda", torch.cuda.current_device())
    u8 = torch.uint8
    texels = hasattr(warp_cuda, "texelize_rows")
    _build.load()

    def timed(source, resample, resample_u8):
        """``source()`` -> the kernel's source; ``resample(src)`` -> f32;
        ``resample_u8(src)`` -> u8 from the kernel, or None."""
        src = source()
        out = resample(src)
        if resample_u8 is None:
            def path():
                return _quantize_device(resample(source()), 8)
        else:
            def path():
                return resample_u8(source())
        got = path()
        torch.cuda.synchronize()
        if not torch.equal(got, _quantize_device(out, 8)):
            raise AssertionError("the path's u8 output is not the quantized "
                                 "f32 output")
        return {
            "source": cuda_ms(source),
            "f32": cuda_ms(lambda: resample(src)),
            "quantize": cuda_ms(lambda: _quantize_device(out, 8)),
            "u8": None if resample_u8 is None
            else cuda_ms(lambda: resample_u8(src)),
            "path": cuda_ms(path),
            "sha_f32": _sha(out), "sha_u8": _sha(got),
        }

    frame = cs.lonlat_frame(cs.SRC_H, cs.SRC_W, 0.3, dev).clamp_min(1)
    rows = frame.reshape(cs.SRC_H, cs.SRC_W * 3)
    files = [pathlib.Path("frame.png")]
    cover_plan, ((cover_key, cover_idx),) = cs._preset_plan(
        "full360coverage", 1600, files, pathlib.Path("out"))
    fish_plan, ((fish_key, fish_idx),) = cs._preset_plan(
        "fisheyeXY", None, files, pathlib.Path("out"))
    zeros = [0.0] * len(cs.RING)

    def key_kw(key):
        projection, width, height, hfov, vfov = key
        return dict(width=width, height=height, hfov_deg=hfov, vfov_deg=vfov,
                    projection=projection)

    warps = [
        (SHAPES[0], (cs.RING, zeros, zeros), cs.HEADLINE),
        (SHAPES[1], (cs.RING, zeros, zeros), cs.MAIN),
        (SHAPES[2], cs._angles(cover_plan, cover_idx), key_kw(cover_key)),
        (SHAPES[3], cs._angles(fish_plan, fish_idx), key_kw(fish_key)),
        (SHAPES[4], ([30.0], [90.0], [0.0]),
         key_kw(("perspective", 1600, 1600, cover_key[3], cover_key[4]))),
        (SHAPES[5], ([90.0], [-20.0], [10.0]),
         key_kw(("equisolid", 2048, 2048, 190.0, 190.0))),
    ]
    results = {}
    for name, angles, kw in warps:
        if texels:
            results[name] = timed(
                lambda: warp_cuda.texelize_rows(rows),
                lambda s: warp_cuda.warp_texels(s, *angles, interp="bicubic",
                                                **kw),
                lambda s: warp_cuda.warp_texels(s, *angles, interp="bicubic",
                                                out_dtype=u8, **kw))
        else:
            results[name] = timed(
                lambda: warp_cuda.planarize_rows(rows, 1.0, u8),
                lambda s: warp_cuda.warp_planes(s, *angles, interp="bicubic",
                                                **kw), None)

    with tempfile.TemporaryDirectory(prefix="gs360x_ab_") as tmp:
        os.environ["HOME"] = tmp   # the generated default calibration
        sensors, _cams = dualfisheye.load_metashape_calibration(
            dualfisheye.default_calibration_path())
        cache = dualfisheye.build_remap_cache(sensors["0"], None, 190.0)
        specs = dualfisheye.build_sfm10_specs(cs.SFM10_SIZE, 14.0, "36 36",
                                              40.0, 40.0)
        views = dualfisheye.build_perspective_spec_maps(
            sensors, "0", "0", specs, 0.0, 180.0, 190.0)
    lens = cs.fisheye_frame(cs.FISH, 3, dev).reshape(cs.FISH, cs.FISH * 3)
    und = remap_cuda.PreparedRemap(cache.map_x, cache.map_y, cache.valid,
                                   src_w=cs.FISH, src_h=cs.FISH, device=dev)
    batch = remap_cuda.PreparedRemapBatch(
        [(views[s["view_id"]]["map_x"], views[s["view_id"]]["map_y"],
          views[s["view_id"]]["valid"]) for s in specs],
        src_w=cs.FISH, src_h=cs.FISH, interp="catmull-rom", device=dev)
    if texels:
        def source():
            return remap_cuda.remap_source(lens, cs.FISH, cs.FISH)
    else:
        def source():
            return remap_cuda.source_planes(lens, cs.FISH, cs.FISH)
    results[SHAPES[6]] = timed(
        source, lambda s: batch(s),
        (lambda s: batch(s, out_dtype=u8)) if texels else None)
    results[SHAPES[7]] = timed(
        source, lambda s: und(s, interp="catmull-rom"),
        (lambda s: und(s, interp="catmull-rom", out_dtype=u8))
        if texels else None)
    # the same maps over resident f32 planes (LUT-decoded lenses, video
    # frames after the colour move): no source pass
    planes_f32 = (remap_cuda.source_planes(lens, cs.FISH, cs.FISH)
                  .to(torch.float32) / 255.0).contiguous()
    results[SHAPES[8]] = timed(
        lambda: planes_f32, lambda s: batch(s),
        (lambda s: batch(s, out_dtype=u8)) if texels else None)
    results[SHAPES[9]] = timed(
        lambda: planes_f32, lambda s: und(s, interp="catmull-rom"),
        (lambda s: und(s, interp="catmull-rom", out_dtype=u8))
        if texels else None)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    report = [r for r in getattr(_build, "ptxas_report", list)()
              if "warp_equirect" in r[0] or "remap_kernel" in r[0]]
    return {"card": smi, "build_s": _build.build_seconds, "shapes": results,
            "ptxas": {"kernels": len(report),
                      "registers": [min((r[1] for r in report), default=0),
                                    max((r[1] for r in report), default=0)],
                      "spilling": [f"{r[0]}: {r[3]}" for r in report if r[2]]}}


def _this_checkouts_device_ms():
    """:func:`device_ms` of this checkout's ``gs360x_torch`` (an older tree
    may lack it), loaded from its file: every tree is timed alike."""
    import importlib.util
    path = (pathlib.Path(__file__).resolve().parent / "gs360x_torch"
            / "runtime" / "profiling.py")
    spec = importlib.util.spec_from_file_location("_ab_profiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.device_ms


def measure_micro_ops(keys, check_loops) -> dict:
    """Runs inside one tree: for each of ``keys`` at grid 2048 (composite
    256), reps 64, the kernel's device time without the wrapper's host time
    (a CUDA graph of 10 launches replayed between events) and its event time;
    its error against the plain version at the check depths (a tree fails
    above the gate); the output's hash at each depth; for the products one
    cuBLAS f32 product of the grid's blocks stacked, times 64 (TF32 off);
    and the card."""
    sys.path[0] = os.getcwd()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("resample_ab: torch.cuda.is_available() is False")
    from gs360x_torch.kernels import _build
    from gs360x_torch.kernels import micro_ops_cuda as mo
    from gs360x_torch.runtime.profiling import cuda_ms
    device_ms = _this_checkouts_device_ms()

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.load()
    inputs = mo.make_inputs(dev)
    out = {}
    for key in keys:
        op = mo.OPS[key]
        tensors = [inputs[name] for name in op.inputs]
        grid = op.grid or mo.GRID
        loops = mo.bench_loops(op)
        errs, shas = [], []
        for depth in check_loops.get(key, (loops,)):
            got = mo.micro_op(key, tensors, depth, grid)
            ref = op.plain(*tensors, depth)
            errs.append(float((got - ref).abs().max() / ref.abs().max()))
            shas.append(_sha(got))
            tol = mo.rel_tolerance(key, depth)
            if errs[-1] > tol or (tol == 0.0 and not torch.equal(got, ref)):
                raise SystemExit(f"{key}: rel {errs[-1]:.3e} at {depth} "
                                 f"loops, gate {tol:g}")

        def launch():
            return mo.micro_op(key, tensors, loops, grid)

        cell = {"device_ms": device_ms(launch)[0],
                "events_ms": cuda_ms(launch), "rel_err": errs, "sha": shas}
        if key in PRODUCTS:
            x, b = tensors
            blocks = x.expand(grid, *x.shape).contiguous()
            cell["cublas_ms"] = device_ms(
                lambda: torch.matmul(blocks, b))[0] * loops
        out[key] = cell
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # kernels by another name in older trees: a template, or mul_kernel<8>
    names = {"gather_lane64": ("gather_lane",),
             "mul8": ("mul8_kernel", "mul_kernelILi8E")}
    ptxas = [f"{r[0]}: {r[3]}" for r in _build.ptxas_report()
             if any(n in r[0] for k in keys for n in names.get(k, (k,)))]
    return {"card": smi, "build_s": _build.build_seconds, "micro_ops": out,
            "ptxas": ptxas}


def _report_micro_ops(trees, runs, keys, check_loops) -> dict:
    """Prints each tree's cells in turn order; returns, for each tree,
    whether every output hash equals this checkout's."""
    ref = runs["change"][0]["micro_ops"]
    same = {name: all(r["micro_ops"][k]["sha"] == ref[k]["sha"]
                      for r in runs[name] for k in keys)
            for name, _d in trees}
    for name, _d in trees:
        print(f"== {name}: {runs[name][0]['card']} | outputs bitwise equal "
              f"to this checkout's: {same[name]}")
        for line in runs[name][0]["ptxas"]:
            print(f"   [ptxas] {line}")
        for key in keys:
            cells = [r["micro_ops"][key] for r in runs[name]]
            print(f"   {key}: device "
                  + "/".join(f"{c['device_ms']:.4f}" for c in cells)
                  + " ms | events "
                  + "/".join(f"{c['events_ms']:.4f}" for c in cells)
                  + " ms" + ("" if "cublas_ms" not in cells[0] else
                             " | cuBLAS f32 " + "/".join(
                                 f"{c['cublas_ms']:.4f}" for c in cells)
                             + " ms")
                  + " | rel err at " + ",".join(
                      map(str, check_loops.get(key, ("nominal",))))
                  + " loops " + "/".join(
                      ",".join(f"{e:.2e}" for e in c["rel_err"])
                      for c in cells))
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout to measure")
    ap.add_argument("--out", metavar="FILE",
                    help="also write every run's numbers there as JSON")
    ap.add_argument("--micro-ops", action="store_true",
                    help="time micro_ops kernels instead")
    ap.add_argument("--keys", default=",".join(MICRO_KEYS),
                    help="with --micro-ops: the primitives to time, comma "
                         "separated (default: %(default)s)")
    ap.add_argument("--one", action="store_true",
                    help="measure the tree in the current directory and "
                         "print one JSON line (what each subprocess runs)")
    ap.add_argument("--check-loops", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args()
    keys = args.keys.split(",")
    if args.one:
        result = (measure_micro_ops(keys, json.loads(args.check_loops))
                  if args.micro_ops else measure())
        print(json.dumps(result), flush=True)
        return 0

    here = pathlib.Path(__file__).resolve()
    trees = [tuple(t.split("=", 1)) for t in args.tree] \
        + [("change", str(here.parent))]
    order = trees + trees[::-1] if len(trees) > 1 else trees
    runs = {name: [] for name, _d in trees}
    flags = ["--one"]
    if args.micro_ops:
        # every tree is checked and hashed at this checkout's depths
        from gs360x_torch.kernels.micro_ops_cuda import CHECK_LOOPS
        flags += ["--micro-ops", "--keys", args.keys,
                  "--check-loops", json.dumps(CHECK_LOOPS)]
    for name, directory in order:
        proc = subprocess.run([sys.executable, str(here), *flags],
                              cwd=directory, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n")
            raise SystemExit(f"resample_ab: tree {name} failed")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[{name}] measured ({runs[name][-1]['card']}, build "
              f"{runs[name][-1]['build_s']:.1f}s)", flush=True)
    if args.micro_ops:
        same = _report_micro_ops(trees, runs, keys, CHECK_LOOPS)
        if args.out:
            pathlib.Path(args.out).write_text(json.dumps(
                {"runs": runs, "bitwise_equal_to_change": same}, indent=1))
        print(json.dumps({"runs": runs, "bitwise_equal_to_change": same}))
        if not all(same.values()):
            raise SystemExit("resample_ab: outputs differ between trees")
        return 0

    keys = ("source", "f32", "quantize", "u8", "path")
    table = {}
    for name, _d in trees:
        table[name] = {}
        for shape in SHAPES:
            cells = [r["shapes"][shape] for r in runs[name]]
            table[name][shape] = {
                k: None if cells[0][k] is None
                else [c[k] for c in cells] for k in keys}
    ref = runs["change"][0]["shapes"]
    same = {name: all(r["shapes"][s][h] == ref[s][h] for r in runs[name]
                      for s in SHAPES for h in ("sha_f32", "sha_u8"))
            for name, _d in trees}
    for name, _d in trees:
        print(f"== {name}: {runs[name][0]['card']} | outputs bitwise equal "
              f"to this checkout's: {same[name]}")
        said = next((r["ptxas"] for r in runs[name] if r["ptxas"]["kernels"]),
                    runs[name][0]["ptxas"])
        print(f"   [ptxas] {said['kernels']} warp and remap kernels, "
              f"{said['registers'][0]}-{said['registers'][1]} registers, "
              f"{len(said['spilling'])} spilling")
        for line in said["spilling"]:
            print(f"   [spill] {line}")
        for shape in SHAPES:
            cell = table[name][shape]
            print(f"   {shape}: " + " | ".join(
                f"{k} " + ("n/a" if cell[k] is None
                           else "/".join(f"{v:.4f}" for v in cell[k]))
                for k in keys) + " ms")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"runs": runs, "bitwise_equal_to_change": same}, indent=1))
    print(json.dumps({"table": table, "bitwise_equal_to_change": same}))
    if not all(same.values()):
        raise SystemExit("resample_ab: outputs differ between trees")
    return 0


if __name__ == "__main__":
    sys.exit(main())
