"""One run of one cell of the port's benchmark, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then ``check``: each compared number
beside its limit, which are also the last lines of standard error). With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. Exits non-zero and prints no result
without a CUDA card, when a module of JAX or of the JAX package is loaded
once the window has closed, or when the program or the harness fails.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import importlib.util
    import json
    import torch
    from portbench import harness

    found = importlib.util.find_spec("gs360x_torch")
    origin = pathlib.Path(found.origin).resolve() if found else ROOT
    if ROOT not in origin.parents:
        print(f"gs360x_torch is not in this checkout ({ROOT})",
              file=sys.stderr)
        return 4

    spec = harness.Spec.load()
    if args.workload not in spec.cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(spec.cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(
            spec, args.workload, seed=args.seed, seconds=args.seconds,
            traced=bool(args.trace), device=torch.device("cuda", 0), t0=T0)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
