#!/usr/bin/env python3
"""Time the headline 2D episode, the headline adversarial train step, the
supervised step and the 3D volume episode of several checkouts of the port
on one GPU, in turns, so that the trees are compared on one card under one
power limit.

    python3 scripts/compare_trees.py --out PATH TREE [TREE ...]
        [--order 0,1,1,0] [--reps 5] [--legacy3d] [--legacy2d] [--configs]

Each TREE is the root of a checkout (for instance a ``git archive`` of
another commit unpacked under ``build/``).  Every turn runs in a fresh
process from the root of its tree, so that tree's ``advchain_tpu_torch``
and ``chip_smoke`` are the ones imported and its kernels are built from
its own sources; the turn times ``chip_smoke.run_episode`` and
``chip_smoke.run_train_step`` (2 warm-ups, ``--reps`` timed, each ending in
a synchronize) at batch 128, 192x192, the supervised step alike, and
``run_episode`` on the 3D volume episode (batch 2, 1x12x192x192).  With
``--legacy3d`` a turn also times the 3D volume episode with
``ADVCHAIN_ZBAND=0`` (``chip_smoke.legacy_route(3)``: the 3D trilinear
samples on the tree's plane route) and profiles one such episode
(``chip_smoke.profile_episode``, written to PATH.legacy3d.<turn>.json):
its device busy time, kernel launches and idle share against the timed
median; ``--legacy2d`` does the same for the headline 2D episode with
``ADVCHAIN_BAND_KERNEL=0`` (``chip_smoke.legacy_route(2)``: the 2D samples
on the tree's corner route; PATH.legacy2d.<turn>.json).  ``--configs``
also times bench.py's random chain (config #2, ``chip_smoke.run_random_chain``,
batch 128) and constrained solve (config #3, ``chip_smoke.run_constrained``,
batch 4, with the share of solves that preserve the volume).  ``--order`` lists the trees' indices in turn order (default: each
tree forward, then backward).  Prints one JSON line per turn and writes
them all to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from advchain_tpu_torch.kernels import _build
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(cs.BUILD)
reps = int(sys.argv[1])
ep = cs.run_episode("cuda", cs.BATCH, cs.SHAPE, reps=reps)
tr = cs.run_train_step("cuda", cs.BATCH, cs.SHAPE, reps=reps)
su = cs.run_train_step("cuda", cs.BATCH, cs.SHAPE, supervised=True,
                       reps=reps)
e3 = cs.run_episode("cuda", cs.BATCH3D, cs.SHAPE3D, reps=reps)
extra = {}
for key, dims, n, shape, path in (
        ("episode3d_legacy", 3, cs.BATCH3D, cs.SHAPE3D, sys.argv[2]),
        ("episode_legacy2d", 2, cs.BATCH, cs.SHAPE, sys.argv[3])):
    if not path:
        continue
    with cs.legacy_route(dims):
        lr = cs.run_episode("cuda", n, shape, reps=reps)
        prof = cs.profile_episode("cuda", n, shape, path)
    extra[key] = dict(
        median_ms=lr[1] * 1e3, per_s=n / lr[1],
        reps_ms=[t * 1e3 for t in lr[2]], loss=lr[3], peak_gb=lr[4] / 1e9,
        launches=lr[0], profile=prof,
        idle_share=1 - prof["device_busy_ms"] / (lr[1] * 1e3))

if sys.argv[4]:
    rc = cs.run_random_chain("cuda", cs.BATCH, cs.SHAPE, reps=reps)
    extra["random_chain"] = dict(
        median_ms=rc[3] * 1e3, per_s=cs.BATCH / rc[3],
        reps_ms=[t * 1e3 for t in rc[4]], peak_gb=rc[5] / 1e9)
    co = cs.run_constrained("cuda", cs.CONSTRAINED_BATCH, cs.SHAPE,
                            reps=reps)
    extra["constrained"] = dict(
        median_ms=co[1] * 1e3, reps_ms=[t * 1e3 for t in co[2]],
        preserved=co[3], losses=co[4], peak_gb=co[5] / 1e9)


def rec(r, n, loss_key):
    return {"median_ms": r[1] * 1e3, "per_s": n / r[1],
            "reps_ms": [t * 1e3 for t in r[2]], loss_key: r[3],
            "peak_gb": r[4] / 1e9}


print(json.dumps({"card": cs.card_line(),
                  "episode": rec(ep, cs.BATCH, "loss"),
                  "train_step": rec(tr, cs.BATCH, "metrics"),
                  "supervised_step": rec(su, cs.BATCH, "metrics"),
                  "episode3d": rec(e3, cs.BATCH3D, "loss"), **extra}))
"""


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--out", required=True)
    parser.add_argument("--order")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--legacy3d", action="store_true",
                        help="also time and profile the 3D episode with "
                             "ADVCHAIN_ZBAND=0")
    parser.add_argument("--legacy2d", action="store_true",
                        help="also time and profile the 2D episode with "
                             "ADVCHAIN_BAND_KERNEL=0")
    parser.add_argument("--configs", action="store_true",
                        help="also time configs #2 and #3")
    args = parser.parse_args(argv)
    n = len(args.trees)
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(n)) + list(reversed(range(n))))
    turns = []
    for turn, i in enumerate(order):
        tree = os.path.abspath(args.trees[i])
        profiles = [os.path.abspath(f"{args.out}.legacy{d}.{turn}.json")
                    if wanted else "" for d, wanted in
                    (("3d", args.legacy3d), ("2d", args.legacy2d))]
        proc = subprocess.run([sys.executable, "-c", CHILD, str(args.reps),
                               *profiles, "1" if args.configs else ""],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"turn on {args.trees[i]} failed "
                               f"(exit {proc.returncode})")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["tree"] = args.trees[i]
        turns.append(result)
        line = {"tree": args.trees[i], "card": result["card"],
                **{f"{key}_per_s": result[key]["per_s"] for key in
                   ("episode", "train_step", "supervised_step",
                    "episode3d")},
                **{f"{key}_peak_gb": result[key]["peak_gb"] for key in
                   ("episode", "train_step", "episode3d")}}
        for key in ("episode3d_legacy", "episode_legacy2d"):
            legacy = result.get(key)
            if legacy is not None:
                line.update({
                    f"{key}_per_s": legacy["per_s"],
                    f"{key}_median_ms": legacy["median_ms"],
                    f"{key}_idle_share": legacy["idle_share"],
                    f"{key}_launches": legacy["profile"]["device_launches"],
                    f"{key}_busy_ms": legacy["profile"]["device_busy_ms"],
                    f"{key}_peak_gb": legacy["peak_gb"]})
        if "random_chain" in result:
            line.update(
                random_chain_per_s=result["random_chain"]["per_s"],
                random_chain_reps_ms=result["random_chain"]["reps_ms"],
                constrained_median_ms=result["constrained"]["median_ms"],
                constrained_reps_ms=result["constrained"]["reps_ms"],
                constrained_preserved=result["constrained"]["preserved"])
        print(json.dumps(line), flush=True)
    with open(args.out, "w") as f:
        json.dump(turns, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
