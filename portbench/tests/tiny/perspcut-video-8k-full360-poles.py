"""``perspcut-video-8k-full360-poles`` at the size the CPU tests run in a
few seconds: a 256x128 clip and 48 px views, the same 14 view ids; 2
distinct frames, a warm-up clip of 5 frames, and a clip of 4 frames a
second of the run (on the CPU video mode warps one frame a batch)."""


def config(cfg: dict) -> dict:
    cfg["frame"].update(width=256, height=128)
    cfg["views"]["size"] = 48
    cfg["args"] = ["--preset", "full360coverage", "--size", "48", "--ext",
                   "jpg", "--add-top", "--add-bottom", "-f", "30", "-j", "2"]
    return cfg


def traffic(t: dict) -> dict:
    t.update(distinct=2, check_sample=16, warmup_frames=5,
             frames_per_s_sizing=4.0)
    return t
