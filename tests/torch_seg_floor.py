#!/usr/bin/env python3
"""The JAX package's capability floor for a U-Net trained on the card.

Trains the ``tools/seg_eval.py`` recipe with the JAX package on the CPU —
features (16, 32, 64) at 64², batch 16, lr 3e-3 with the warmup-cosine
schedule over ``--steps``, 448 corpus scenes at ``photo_frac`` 0.7, init key
and corpus seed ``s``, batch rng ``s + 1``, flips, ``augment_batch``,
``fg_weight`` 4 — for seeds 0 .. ``--seeds`` − 1, and measures each model's
four capability numbers with the port's
:func:`gs360x_torch.checks.capability`, the function
``chip_smoke.py`` measures the port's card-trained model with. The floor
``chip_smoke.py`` holds that model to is the lowest seed's number less
``MARGIN`` on each metric.

With ``--port-runs N`` (on a machine with a card; JAX is then not needed
with ``--seeds 0``) it also trains ``chip_smoke.py``'s (d), the same recipe
at its ``CAP_STEPS``, with the port on the card by the route users train
by — cuDNN, autotuned — in N fresh processes, four
at a time, and prints each model's four numbers and how many fall below
``chip_smoke.CAP_FLOOR``: the autotuner chooses anew in every process, so
each process is one more draw of the model.

    python3 tests/torch_seg_floor.py [--seeds 3] [--steps 3000] \
        [--port-runs 0] [--out floor.json]

The seeds need JAX and run on the CPU (about 10 minutes a seed on 8
cores).
It lives with the tests because it imports both packages; pytest collects
no file of this name.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

# both packages and chip_smoke import from the repository's root
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARGIN = 0.05
FEATS = (16, 32, 64)
SIZE = 64
METRICS = ("heldout", "photo", "transfer", "AP@0.5")


def train(seed: int, steps: int):
    """The seg_eval recipe with the JAX package; the trained params."""
    import jax
    import jax.numpy as jnp

    from gs360x.models import segmentation as seg
    from gs360x.models import synthseg

    state = seg.create_train_state(jax.random.key(seed), 3e-3,
                                   input_size=SIZE, features=FEATS,
                                   decay_steps=steps)
    images, labels = synthseg.generate_corpus(448, size=SIZE, seed=seed,
                                              photo_frac=0.7)
    rng = np.random.default_rng(seed + 1)
    for step in range(steps):
        idx = rng.integers(0, len(images), 16)
        im, lb = images[idx].copy(), labels[idx]
        if rng.random() < 0.5:
            im = im[:, :, ::-1].copy()
            lb = lb[:, :, ::-1].copy()
        im = synthseg.augment_batch(rng, im)
        state, loss = seg.train_step(state, jnp.asarray(im),
                                     jnp.asarray(lb), fg_weight=4.0)
        if (step + 1) % 500 == 0:
            print(f"[seg_floor] seed {seed} step {step + 1}/{steps} loss "
                  f"{float(loss):.4f}", file=sys.stderr, flush=True)
    return state.params


def measure(params) -> dict:
    import jax.numpy as jnp

    from gs360x.models import segmentation as seg
    from gs360x_torch import checks

    model = seg.create_model(FEATS)

    def logits(images):
        out = model.apply({"params": params}, jnp.asarray(images))
        return np.asarray(out).transpose(0, 3, 1, 2)

    return checks.capability(logits)


def port_runs(n: int) -> list:
    """The four numbers of ``n`` models trained by the port on the card by
    its shipped route (``chip_smoke.py``'s (d) recipe and code, with the
    training scope left as ``train_step`` has it), one fresh process each,
    four at a time."""
    code = ("import contextlib, json, torch, chip_smoke as cs; "
            "got = cs._train_capability(torch.device('cuda'), "
            "contextlib.nullcontext)[0]; print(json.dumps(got))")
    env = dict(os.environ, OMP_NUM_THREADS="2")

    def one(_k):
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(one, range(n)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--port-runs", type=int, default=0,
                    help="models trained by the port on the card")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()

    rows = []
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        got = measure(train(seed, args.steps))
        got.update(seed=seed, train_s=time.perf_counter() - t0)
        rows.append(got)
        print(f"[seg_floor] seed {seed}: " + ", ".join(
            f"{k} {got[k]!r}" for k in (*METRICS, "n_gt", "train_s")),
            flush=True)
    floor = {k: min(r[k] for r in rows) - MARGIN for k in METRICS} \
        if rows else {}
    if rows:
        print(f"[seg_floor] floor (lowest seed - {MARGIN}): "
              + ", ".join(f"{k} {v!r}" for k, v in floor.items()),
              flush=True)
    port = port_runs(args.port_runs) if args.port_runs else []
    if port:
        from chip_smoke import CAP_FLOOR

        for k, got in enumerate(port):
            print(f"[seg_floor] port run {k}: " + ", ".join(
                f"{m} {got[m]!r}" for m in METRICS), flush=True)
        below = sum(any(got[m] < CAP_FLOOR[m] for m in METRICS)
                    for got in port)
        print(f"[seg_floor] port runs below chip_smoke's floor: {below} of "
              f"{len(port)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"steps": args.steps, "rows": rows, "floor": floor,
                       "margin": MARGIN, "port_runs": port}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
