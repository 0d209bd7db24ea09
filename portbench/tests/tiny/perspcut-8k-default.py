"""``perspcut-8k-default`` at the size the CPU tests run in a second: a
256x128 frame and 48 px views; 2 distinct frames, one warm-up frame, and a
plan of 4 frames a second of the run."""


def config(cfg: dict) -> dict:
    cfg["frame"].update(width=256, height=128)
    cfg["views"]["size"] = 48
    cfg["args"] = ["--preset", "default", "--size", "48", "--ext", "jpg",
                   "-j", "2"]
    return cfg


def traffic(t: dict) -> dict:
    t.update(distinct=2, check_sample=8, warmup_frames=1,
             frames_per_s_sizing=4.0)
    return t
