"""The control of a cell's check: the reference, computed in bfloat16 (the
precision below the float32 the kernels compute in), put in the program's
place, must come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--cpu]

For each seed it makes the cell's distinct inputs as a run does (the
driver's ``inputs``), computes every (distinct input, view) the cell's
outputs can be, once in float64 (the reference) and once in bfloat16 (the
control), sends the control's views through the encoder settings the tool
writes with, and prints the numbers the check compares, one JSON line a
seed, beside the cell's limits. The benchmark's own runs never run this.
It runs the program not at all, so it needs no card; on a card it runs
where the check runs.
"""

import argparse
import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(spec, name: str, seed: int, device, work_root) -> dict:
    """The control's numbers of one seed."""
    import torch
    from portbench.reference import compare

    cfg, traffic = spec.config(name), spec.workload(name)
    driver = spec.driver(cfg)
    work = pathlib.Path(work_root) / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        n = int(traffic["distinct"])
        distinct = driver.inputs(cfg, traffic, seed, work)
        keys = [(d, v) for d in range(n) for v in cfg["views"]["layout"]]
        t = time.perf_counter()
        ref = driver.reference(cfg, distinct, keys, torch.float64, device,
                               traffic, work)
        low = driver.reference(cfg, distinct, keys, torch.bfloat16, device,
                               traffic, work)
        quality = cfg["output"]["jpeg_quality"]
        pairs = [(compare.jpeg_roundtrip(low[k].cpu().numpy(), quality),
                  ref[k]) for k in ref]
        found = compare.numbers(pairs, 0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    limits = traffic["limits"]
    return {"workload": name, "seed": seed, "views": len(pairs),
            "seconds": round(time.perf_counter() - t, 3),
            "correct": compare.verdict(found, limits),
            "check": {k: [found[k], limits[k]] for k in limits}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the CPU (small shapes only)")
    args = ap.parse_args(argv)
    import torch
    from portbench import harness

    device = torch.device("cpu" if args.cpu else "cuda", 0)
    spec = harness.Spec.load()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(spec, args.workload, seed, device,
                                  harness.WORK_ROOT / "control")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
