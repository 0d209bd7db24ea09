"""``dualfisheye-masks-osmo360-sfm10`` at the jpg-pairs tiny size: 192 px
lenses and their masks under a calibration scaled with them, which the
driver hands the tool as ``--camera-xml``, and 40 px views; 2 distinct
pairs, 2 warm-up pairs, and 3 pairs a second of the run."""


def config(cfg: dict) -> dict:
    cal = cfg["calibration"]
    s = 192 / cal["width"]
    cal.update(width=192, height=192, f=cal["f"] * s, cx=cal["cx"] * s,
               cy=cal["cy"] * s)
    cfg["program_calibration"] = "xml"
    cfg["views"]["size"] = 40
    cfg["args"] = ["--interpolation", "cubic", "--perspective-size", "40",
                   "--perspective-focal-mm", "14", "--workers", "1",
                   "--mask-input-dir", "masks"]
    return cfg


def traffic(t: dict) -> dict:
    t.update(distinct=2, check_sample=8, warmup_pairs=2,
             pairs_per_s_sizing=3.0)
    return t
