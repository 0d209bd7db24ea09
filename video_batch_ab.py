#!/usr/bin/env python3
"""Wall of ``gs360x-torch-perspcut``'s video mode on one NVIDIA GPU on a long
8K clip, frames batched 4 a launch against 1 a launch, measured in turns in
one process.

    python3 video_batch_ab.py [--frames 200] [--turns 2] [--out FILE]

It writes an N-frame 8K (7680x3840) 4:2:0 Y4M of ``chip_smoke.py``'s
self-checking lon/lat panorama (8 shifted frames, repeated) into
``build/video_batch_ab/`` and runs perspcut's video mode in process on it
at ``--preset default`` (8 views of 1600², PNG), every frame taken, with
``executor.CARD_FRAMES_PER_LAUNCH`` at 4 and at 1 in turns (4, 1, 1, 4 for
two turns), after one untimed warm-up of each on an 8-frame clip. Each
run's files are hashed, held byte-equal to the first run's, and deleted.
It prints each run's wall, views/s and ``[STATS]`` line and each setting's
mean wall, and with ``--out`` writes the numbers as JSON. The clip shrinks
to what the disk holds beside one run's outputs (at least 24 frames).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as smoke
from gs360x_torch.runtime import executor
from gs360x_torch.tools import perspcut

DISTINCT = 8                      # distinct frames, repeated to --frames
OUTPUT_GB = 12.0                  # disk kept free for one run's PNGs
SETTINGS = (4, 1)                 # frames a launch: batched, per frame


def write_clip(path: pathlib.Path, n_frames: int, fps: int, dev) -> None:
    """An n-frame 8K 4:2:0 Y4M: DISTINCT frames written once by
    ``chip_smoke.write_y4m_420``, then their bytes repeated."""
    seed = path.with_suffix(".seed.y4m")
    smoke.write_y4m_420(seed, [smoke.lonlat_frame(
        smoke.SRC_H, smoke.SRC_W, 0.3 * k, dev) for k in range(DISTINCT)],
        fps)
    data = seed.read_bytes()
    seed.unlink()
    header, body = data.split(b"\n", 1)
    frame_bytes = len(body) // DISTINCT
    frames = [body[k * frame_bytes:(k + 1) * frame_bytes]
              for k in range(DISTINCT)]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        for k in range(n_frames):
            f.write(frames[k % DISTINCT])


def run(clip: pathlib.Path, out_dir: pathlib.Path, fps: int,
        per_launch: int, device: str = "cuda") -> dict:
    """One perspcut video run: wall, [STATS] line, file hashes."""
    saved = executor.CARD_FRAMES_PER_LAUNCH
    executor.CARD_FRAMES_PER_LAUNCH = per_launch
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = perspcut.main(["-i", str(clip), "-o", str(out_dir),
                                "--preset", "default", "--size", "1600",
                                "-f", str(fps), "--ext", "png", "--device",
                                device, "--stats"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        executor.CARD_FRAMES_PER_LAUNCH = saved
    lines = buf.getvalue().splitlines()
    if rc != 0:
        raise SystemExit(f"video_batch_ab: perspcut exited {rc}: {lines[-3:]}")
    hashes = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in sorted(out_dir.iterdir())}
    shutil.rmtree(out_dir)
    stats = next((ln for ln in lines if ln.startswith("[STATS]")), "")
    return {"per_launch": per_launch, "wall_s": wall, "files": len(hashes),
            "views_per_s": len(hashes) / wall, "stats": stats,
            "hashes": hashes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--out", metavar="FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("video_batch_ab: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    work = pathlib.Path("build/video_batch_ab").resolve()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    frame_bytes = smoke.SRC_H * smoke.SRC_W * 3 // 2
    free = shutil.disk_usage(work).free
    fit = int((free - OUTPUT_GB * 2 ** 30) // frame_bytes)
    n_frames = min(args.frames, fit)
    if n_frames < 24:
        raise SystemExit(f"video_batch_ab: {free / 2 ** 30:.1f} GiB free "
                         f"holds {fit} frames")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[video_batch_ab] {smi} | {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} | {free / 2 ** 30:.1f} GiB free",
          flush=True)

    t0 = time.perf_counter()
    warm = work / "warm.y4m"
    write_clip(warm, DISTINCT, args.fps, dev)
    clip = work / "clip.y4m"
    write_clip(clip, n_frames, args.fps, dev)
    print(f"[video_batch_ab] clip {n_frames} frames 7680x3840 4:2:0 "
          f"({clip.stat().st_size / 2 ** 30:.2f} GiB), written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for per_launch in SETTINGS:      # builds and first calls, untimed
        run(warm, work / "out", args.fps, per_launch)

    order = []
    for turn in range(args.turns):
        order += list(SETTINGS if turn % 2 == 0 else SETTINGS[::-1])
    runs = []
    for k, per_launch in enumerate(order):
        r = run(clip, work / "out", args.fps, per_launch)
        if runs and r["hashes"] != runs[0]["hashes"]:
            differ = [n for n in runs[0]["hashes"]
                      if r["hashes"].get(n) != runs[0]["hashes"][n]]
            raise SystemExit(f"video_batch_ab: run {k + 1}'s files differ "
                             f"from run 1's: {differ[:4]}")
        runs.append(r)
        print(f"[video_batch_ab] run {k + 1} frames a launch {per_launch}: "
              f"wall {r['wall_s']:.3f}s, {r['files']} files, "
              f"{r['views_per_s']:.2f} views/s | {r['stats']}", flush=True)
    means = {p: statistics.mean(r["wall_s"] for r in runs
                                if r["per_launch"] == p) for p in SETTINGS}
    print(f"[video_batch_ab] {n_frames} frames, mean wall: "
          + ", ".join(f"{p} a launch {w:.3f}s" for p, w in means.items())
          + f" | 4 against 1: {means[4] / means[1] - 1:+.2%} | files "
          "byte-equal over every run", flush=True)
    shutil.rmtree(work)
    if args.out:
        for r in runs:
            del r["hashes"]
        pathlib.Path(args.out).write_text(json.dumps(
            {"device": smi, "frames": n_frames, "runs": runs,
             "mean_wall_s": {str(p): w for p, w in means.items()}},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
