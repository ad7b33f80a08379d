#!/usr/bin/env python3
"""What the port's 2D sampling costs inside the headline train step and the
headline 2D episode, on one GPU: launches and device time of every 2D
sample (``ops.grid_sample.grid_sample_2d``), and of the host-side corner
fold inside it (``corner_weights``) where the route still calls one,
forward and backward, against the whole step's device busy time.

    cd <checkout> && python3 <this script> --out PATH [--batch 128]
        [--size 192] [--device cuda]

It imports ``advchain_tpu_torch`` and ``chip_smoke`` from the current
directory, so the same script measures any checkout of the port (run it
from the root of each).  The forward of a range is every op called inside
it; its backward is every autograd node whose sequence number one of those
ops recorded (``autograd::engine::evaluate_function: ...``), with the
device kernels of each node's subtree.  One step (or episode) is profiled
after one warm-up.  On the CPU the device columns are 0 and only the op
counts mean anything.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

RANGES = {"sample2d": ("grid_sample_2d",), "fold2d": ("corner_weights",)}
BACKWARD_NODE = "autograd::engine::evaluate_function"


def _walk(event):
    yield event
    for child in event.cpu_children:
        yield from _walk(child)


def _kernels(event):
    """(launches, device ms) of the device kernels of ``event``'s
    subtree."""
    n, us = 0, 0.0
    for e in _walk(event):
        n += len(e.kernels)
        us += sum(k.duration for k in e.kernels)
    return n, us / 1e3


@contextlib.contextmanager
def labelled(modules):
    """Wrap each function of RANGES in a ``record_function`` of its range's
    name, in every module of ``modules`` that has it (callers that bound
    the name at import are wrapped in their own module)."""
    from torch.profiler import record_function
    saved = []
    for label, names in RANGES.items():
        for module in modules:
            for name in names:
                fn = getattr(module, name, None)
                if fn is None:
                    continue

                def wrapper(*args, _fn=fn, _label=label, **kwargs):
                    with record_function(_label):
                        return _fn(*args, **kwargs)

                saved.append((module, name, fn))
                setattr(module, name, wrapper)
    try:
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def attribute(prof):
    """Per range: calls, aten ops and device kernels (launches, ms) of its
    forward and its backward; and the whole run's busy time and
    launches."""
    import torch
    events = prof.events()
    roots = [e for e in events if e.cpu_parent is None]
    out = {}
    for label in RANGES:
        # the host's ranges (the device timeline repeats each annotation)
        ranges = [e for e in events if e.name == label
                  and e.device_type == torch.autograd.DeviceType.CPU]
        seqs, ops, fwd_n, fwd_ms = set(), 0, 0, 0.0
        for r in ranges:
            for e in _walk(r):
                # aten ops called from Python, not from another aten op
                if e is not r and e.name.startswith("aten::") \
                        and not e.cpu_parent.name.startswith("aten::"):
                    ops += 1
                if e.sequence_nr >= 0:
                    seqs.add((e.thread, e.sequence_nr))
            n, ms = _kernels(r)
            fwd_n += n
            fwd_ms += ms
        bwd_nodes = [e for e in events
                     if e.name.startswith(BACKWARD_NODE)
                     and (e.fwd_thread, e.sequence_nr) in seqs]
        bwd_n, bwd_ms, bwd_ops = 0, 0.0, 0
        for node in bwd_nodes:
            n, ms = _kernels(node)
            bwd_n += n
            bwd_ms += ms
            bwd_ops += sum(1 for e in _walk(node)
                           if e.name.startswith("aten::")
                           and not e.cpu_parent.name.startswith("aten::"))
        out[label] = {"calls": len(ranges), "fwd_aten_ops": ops,
                      "fwd_launches": fwd_n, "fwd_device_ms": fwd_ms,
                      "bwd_nodes": len(bwd_nodes), "bwd_aten_ops": bwd_ops,
                      "bwd_launches": bwd_n, "bwd_device_ms": bwd_ms}
    busy_n, busy_ms = 0, 0.0
    for r in roots:
        n, ms = _kernels(r)
        busy_n += n
        busy_ms += ms
    out["run"] = {"device_launches": busy_n, "device_busy_ms": busy_ms}
    for label in RANGES:
        rec = out[label]
        rec["share_of_busy"] = ((rec["fwd_device_ms"] + rec["bwd_device_ms"])
                                / busy_ms if busy_ms else 0.0)
    return out


def profile(fn, modules, sync):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    sync()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with labelled(modules):
        t0 = time.perf_counter()
        with tprofile(activities=acts) as prof:
            fn()
            sync()
        wall = (time.perf_counter() - t0) * 1e3
    result = attribute(prof)
    result["run"]["wall_ms_profiled"] = wall
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--size", type=int, default=192)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import importlib

    import torch

    import chip_smoke as cs
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fold2d_profile: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (args.size, args.size)
    modules = [importlib.import_module(f"advchain_tpu_torch.ops.{m}")
               for m in ("grid_sample", "integrate")]

    def sync():
        cs.sync(args.device)

    step, state, data = cs.build_train_step(args.device, args.batch, shape)
    gen = torch.Generator(device=args.device).manual_seed(1)
    results = {"card": cs.card_line() if args.device == "cuda" else "cpu",
               "batch": args.batch, "shape": list(shape)}
    results["train_step"] = profile(lambda: step(state, data, gen), modules,
                                    sync)
    solver = cs.build_solver(args.batch, shape)
    model = cs.build_model(args.device)
    x = torch.as_tensor(cs.make_image(args.batch, shape), device=args.device)
    results["episode"] = profile(
        lambda: cs.episode_once(solver, model, x), modules, sync)
    for key in ("train_step", "episode"):
        print(f"[fold2d] {key}: {json.dumps(results[key])}", flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
