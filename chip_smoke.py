#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (advchain_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--profile PATH]

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit, build the CUDA kernels from
     ``advchain_tpu_torch/kernels/csrc`` and print the build time;
  2. hold each kernel against its plain PyTorch twin on the card at the main
     path's shapes (N=128, 192x192, C in {1, 2, 5}; a 30-degree rotation
     with zeros padding and a near-identity warp with border padding);
  3. check the episode on a small input against the same episode on the CPU
     (plain twins), with identical weights and transform parameters;
  4. run the headline adversarial episode (noise -> bias -> affine -> morph,
     batch 128 at 192x192, UNet_16 with 4 classes and seeded random
     weights, mse + contour, n_iter=1, smart power iteration), count the
     kernel launches of one episode and time 5 episodes after 2 warm-ups;
  5. time each kernel, its twin and ``F.grid_sample`` (the library
     yardstick, never used by the port) and print the ``kernels`` line.
The last line of standard output is the device record.  ``--profile PATH``
additionally writes a torch.profiler summary of one episode to PATH.

Convolutions and matmuls run in full f32 (TF32 off): morph's 8
self-compositions amplify rounding.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 128
SHAPE = (192, 192)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
TOL_FWD = 1e-5
TOL_DW = 1e-5
TOL_DIMG_REL = 1e-5          # of max|d_img|: atomics sum in no fixed order
KERNEL_SOURCE = "advchain_tpu_torch/kernels/csrc/band_sample.cu"


def chain_configs(batch, shape):
    """The headline transform configs (bench.py:156-168)."""
    size = [batch, 1, *shape]
    return {
        "noise": {"epsilon": 1.0, "xi": 1e-6, "data_size": size},
        "bias": {"epsilon": 0.3, "control_point_spacing": [48, 48],
                 "downscale": 2, "data_size": size,
                 "interpolation_order": 3, "init_mode": "random",
                 "space": "log"},
        "affine": {"rot": 30.0 / 180.0, "scale_x": 0.2, "scale_y": 0.2,
                   "shift_x": 0.1, "shift_y": 0.1, "data_size": size},
        "morph": {"epsilon": 1.5, "data_size": size,
                  "vector_size": [shape[0] // 16, shape[1] // 16]},
    }


def make_image(batch, shape):
    """The headline's synthetic image (bench.py make_image)."""
    ii, jj = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    cy, cx = shape[0] / 2, shape[1] / 2
    img = (np.exp(-(((ii - cy) / 30.0) ** 2 + ((jj - cx) / 24.0) ** 2))
           + 0.3 * np.exp(-(((ii - 0.3125 * shape[0]) / 15.0) ** 2
                            + ((jj - 0.625 * shape[1]) / 12.0) ** 2)))
    r = np.random.RandomState(0)
    x = np.broadcast_to(img, (batch, 1) + tuple(shape)).copy()
    return (x + 0.05 * r.rand(batch, 1, *shape)).astype(np.float32)


def build_solver(batch, shape, names=("noise", "bias", "affine", "morph")):
    from advchain_tpu_torch.augmentor import (
        AdvAffine, AdvBias, AdvMorph, AdvNoise,
        ComposeAdversarialTransformSolver)
    cls = {"noise": AdvNoise, "bias": AdvBias, "affine": AdvAffine,
           "morph": AdvMorph}
    cfg = chain_configs(batch, shape)
    chain = [cls[n](config_dict=cfg[n], seed=i) for i, n in enumerate(names)]
    return ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])


def build_model(device, seed=0):
    from advchain_tpu_torch.models import SegmentationModel, UNet
    return SegmentationModel.create(
        UNet(input_channel=1, num_classes=4, feature_scale=4), seed=seed,
        device=device)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sample_grids(n, h, w, device, seed=0):
    """(name, padding, grid): a 30-degree rotation and a near-identity warp
    of up to 1.5 px (the scaling-and-squaring compositions)."""
    import torch
    from advchain_tpu_torch.ops.affine import affine_grid
    gen = torch.Generator(device=device).manual_seed(seed)
    a = math.radians(30.0)
    theta = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                          [math.sin(a), math.cos(a), 0.0]],
                         device=device).expand(n, 2, 3)
    rot = affine_grid(theta, (n, 1, h, w))
    ident = affine_grid(torch.eye(2, 3, device=device).expand(n, 2, 3),
                        (n, 1, h, w))
    scale = torch.tensor([1.5 * 2 / (w - 1), 1.5 * 2 / (h - 1)],
                         device=device)
    near = ident + (2 * torch.rand(ident.shape, generator=gen,
                                   device=device) - 1) * scale
    return [("rot30", "zeros", rot), ("near_identity", "border", near)]


def kernel_inputs(n, c, h, w, grid, padding, device, seed=0):
    import torch
    from advchain_tpu_torch.ops.grid_sample import corner_weights
    gen = torch.Generator(device=device).manual_seed(seed + c)
    img = torch.randn(n, c, h, w, generator=gen, device=device)
    yidx, xidx, wts = corner_weights(grid, h, w, padding, True)
    g = torch.randn(n, c, h * w, generator=gen, device=device)
    return img, yidx, xidx, wts, g


def check_kernels(n, shape, device, channels=(1, 2, 5)):
    """Phase 2: each kernel against its twin.  Returns the largest errors."""
    import torch
    from advchain_tpu_torch.kernels import band_sample as bs
    h, w = shape
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, padding, grid in sample_grids(n, h, w, device):
        for c in channels:
            img, yidx, xidx, wts, g = kernel_inputs(n, c, h, w, grid,
                                                    padding, device)
            with torch.no_grad():
                out = bs.band_sample_fwd(img, yidx, xidx, wts)
                ref = bs.band_sample_fwd_plain(img, yidx, xidx, wts)
                d_img, d_w = bs.band_sample_bwd(g, img, yidx, xidx, wts)
                r_img, r_w = bs.band_sample_bwd_plain(g, img, yidx, xidx,
                                                      wts)
            sync(device)
            e_fwd = float((out - ref).abs().max())
            e_dw = float((d_w - r_w).abs().max())
            scale = float(r_img.abs().max())
            e_dimg = float((d_img - r_img).abs().max())
            print(f"[kernels] {name:13s} {padding:6s} C={c}: fwd {e_fwd:.3e} "
                  f"d_w {e_dw:.3e} d_img {e_dimg:.3e} (max|d_img| "
                  f"{scale:.3e})", flush=True)
            if not (e_fwd <= TOL_FWD and e_dw <= TOL_DW
                    and e_dimg <= TOL_DIMG_REL * scale):
                raise AssertionError(
                    f"kernel disagrees with its twin: {name} C={c} "
                    f"fwd {e_fwd} d_w {e_dw} d_img {e_dimg} "
                    f"(limit {TOL_DIMG_REL * scale})")
            worst["fwd"] = max(worst["fwd"], e_fwd)
            worst["bwd"] = max(worst["bwd"], e_dw, e_dimg)
    return worst


def check_episode_against_cpu(device, batch=2, shape=(64, 64)):
    """Phase 3: the same small episodes on ``device`` and on the CPU (plain
    twins), with identical weights and transform parameters.

    Full chain without PGD: dist within 1e-3 absolute (morph's 8
    self-compositions amplify rounding, tests/test_reference_e2e.py).
    Morph-free chain, one PGD step on the noise alone: with power iteration
    the new noise is the unit-normalised gradient of the divergence, which
    runs back through the affine warp's backward kernel and the UNet, so
    each sample's direction must agree to cosine 0.999, and dist to 1e-2
    relative.  (A PGD step's outcome is not compared tighter: ReLU and
    max-pool switches move gradients between two devices, and affine's
    sign-of-gradient update would amplify them.)"""
    import torch
    model_d = build_model(device)
    model_c = build_model("cpu")
    model_c.module.load_state_dict(model_d.module.state_dict())
    data = torch.as_tensor(make_image(batch, shape))
    results = {}
    for names, n_iter, flags in (
            (("noise", "bias", "affine", "morph"), 0, None),
            (("noise", "bias", "affine"), 1, [True, False, False])):
        solvers = [build_solver(batch, shape, names) for _ in range(2)]
        gen = torch.Generator().manual_seed(7)
        params = [t.init_params(gen) for t in solvers[0].chain_of_transforms]
        dists = []
        for solver, model, dev in ((solvers[0], model_d, device),
                                   (solvers[1], model_c, "cpu")):
            solver.set_transformation(params)
            d = solver.adversarial_training(
                data.to(dev), model, optimize_flags=flags, n_iter=n_iter,
                lazy_load=True, power_iteration="smart", step_sizes=1.0)
            dists.append(float(d))
        diff = abs(dists[0] - dists[1])
        noise = [s.chain_of_transforms[0].param.cpu().reshape(batch, -1)
                 for s in solvers]
        cos = float(torch.nn.functional.cosine_similarity(*noise).min())
        key = "+".join(names) + f" n_iter={n_iter}"
        print(f"[reference] {key}: dist {dists[0]:.6e} vs cpu "
              f"{dists[1]:.6e} (abs {diff:.2e}, rel "
              f"{diff / abs(dists[1]):.2e}), noise cosine {cos:.7f}",
              flush=True)
        ok = (diff < 1e-3 if n_iter == 0
              else diff < 1e-2 * abs(dists[1]) and cos > 0.999)
        if not ok:
            raise AssertionError(f"episode disagrees with the CPU run: {key}")
        results[key] = (diff, cos)
    return results


def episode_once(solver, model, data):
    dist = solver.adversarial_training(data=data, model=model, n_iter=1,
                                       power_iteration="smart",
                                       step_sizes=1.0)
    sync(data.device)
    return dist


def run_episode(device, batch, shape, warm=2, reps=5):
    """Phase 4: returns (launch counts of one episode, median seconds per
    episode, all rep times, final loss, peak device bytes allocated)."""
    import torch
    from advchain_tpu_torch.kernels import band_sample as bs
    solver = build_solver(batch, shape)
    model = build_model(device)
    data = torch.as_tensor(make_image(batch, shape), device=device)
    for _ in range(warm):
        episode_once(solver, model, data)
    times = []
    launches = None
    if data.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(reps):
        if i == 0:
            bs.reset_launch_counts()
        t0 = time.perf_counter()
        dist = episode_once(solver, model, data)
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = {"fwd": bs.FWD_LAUNCHES, "bwd": bs.BWD_LAUNCHES}
            loss = float(dist)
            adv = solver.adv_data
            warped = solver.warped_back_adv_output
            if not (math.isfinite(loss)
                    and tuple(adv.shape) == (batch, 1) + tuple(shape)
                    and bool(torch.isfinite(adv).all())
                    and tuple(warped.shape) == (batch, 4) + tuple(shape)
                    and bool(torch.isfinite(warped).all())):
                raise AssertionError(f"episode output is not finite or has "
                                     f"the wrong shape (loss {loss})")
    if not (launches["fwd"] > 0 and launches["bwd"] > 0):
        raise AssertionError(f"the episode did not launch both kernels: "
                             f"{launches}")
    peak = torch.cuda.max_memory_allocated() if data.is_cuda else 0
    return launches, statistics.median(times), times, loss, peak


def time_ms(fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_kernels(n, shape, device):
    """Phase 5 timings per case: kernel, twin, library, and the bound."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import band_sample as bs
    h, w = shape
    p = h * w
    rows = []
    for name, padding, grid in sample_grids(n, h, w, device):
        for c in (1, 2, 5):
            img, yidx, xidx, wts, g = kernel_inputs(n, c, h, w, grid,
                                                    padding, device)
            f4 = 4  # bytes of f32 and int32
            fwd_bytes = f4 * (n * c * h * w + 2 * n * p + 4 * n * p
                              + n * c * p)
            bwd_bytes = f4 * (n * c * p + n * c * h * w + 2 * n * p
                              + 4 * n * p + n * c * h * w + 4 * n * p)
            fwd_bound = bound_ms(fwd_bytes, 7 * n * c * p)
            bwd_bound = bound_ms(bwd_bytes, 16 * n * c * p)
            img_g = img.clone().requires_grad_(True)
            grid_g = grid.clone().requires_grad_(True)
            g_img = g.reshape(n, c, h, w)

            def lib_bwd():
                out = F.grid_sample(img_g, grid_g, mode="bilinear",
                                    padding_mode=padding, align_corners=True)
                torch.autograd.grad(out, (img_g, grid_g), g_img)

            with torch.no_grad():
                row = {
                    "case": name, "padding": padding, "C": c,
                    "fwd_ms": time_ms(lambda: bs.band_sample_fwd(
                        img, yidx, xidx, wts)),
                    "fwd_plain_ms": time_ms(lambda: bs.band_sample_fwd_plain(
                        img, yidx, xidx, wts)),
                    "fwd_library_ms": time_ms(lambda: F.grid_sample(
                        img, grid, mode="bilinear", padding_mode=padding,
                        align_corners=True)),
                    "fwd_bound_ms": fwd_bound[0],
                    "bwd_ms": time_ms(lambda: bs.band_sample_bwd(
                        g, img, yidx, xidx, wts)),
                    "bwd_plain_ms": time_ms(lambda: bs.band_sample_bwd_plain(
                        g, img, yidx, xidx, wts)),
                    "bwd_bound_ms": bwd_bound[0],
                }
            row["bwd_library_ms"] = time_ms(lib_bwd)
            row["bound_by"] = [fwd_bound[1], bwd_bound[1]]
            rows.append(row)
            print("[timing] " + json.dumps(row), flush=True)
    return rows


def profile_episode(device, batch, shape, path):
    """Device time of one episode by kernel (torch.profiler), written to
    ``path`` as JSON; prints the busy time and the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    solver = build_solver(batch, shape)
    model = build_model(device)
    data = torch.as_tensor(make_image(batch, shape), device=device)
    episode_once(solver, model, data)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        episode_once(solver, model, data)
    rows = [{"name": e.key, "count": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    sampler = sum(r["device_ms"] for r in rows if "band_sample" in r["name"])
    with open(path, "w") as f:
        json.dump({"device_busy_ms": busy, "band_sample_ms": sampler,
                   "kernels": rows[:60]}, f, indent=1)
    print(f"[profile] device busy {busy:.1f} ms, band_sample kernels "
          f"{sampler:.1f} ms; top: " + "; ".join(
              f"{r['name'][:50]} {r['device_ms']:.1f} ms x{r['count']}"
              for r in rows[:6]), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="also write a profile of one episode to PATH")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from advchain_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda"
    card = card_line()
    print(card, flush=True)  # name, power limit, as nvidia-smi gives them
    t0 = time.perf_counter()
    _build.build(["band_sample"])
    print(f"[build] band_sample.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)

    worst = check_kernels(BATCH, SHAPE, device)
    check_episode_against_cpu(device)
    launches, sec, times, loss, peak = run_episode(device, BATCH, SHAPE)
    print(f"[episode] batch {BATCH} {SHAPE[0]}x{SHAPE[1]}: loss {loss:.6e}, "
          f"launches fwd {launches['fwd']} bwd {launches['bwd']}, median "
          f"{sec * 1e3:.1f} ms ({BATCH / sec:.2f} img/s) over "
          f"{[round(t * 1e3, 1) for t in times]} ms, peak "
          f"{peak / 1e9:.2f} GB on {card}", flush=True)
    if args.profile:
        profile_episode(device, BATCH, SHAPE, args.profile)

    rows = time_kernels(BATCH, SHAPE, device)
    # the line's timed case: the scaling-and-squaring compositions (C=2,
    # near-identity, border), the most frequent sampler call of the episode
    head = next(r for r in rows if r["case"] == "near_identity"
                and r["C"] == 2)
    kernels = []
    for i, (kind, line) in enumerate((("fwd", 839), ("bwd", 923))):
        kernels.append({
            "name": f"band_sample_{kind}", "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": f"advchain_tpu/kernels/gather_matmul.py:{line}",
            "launches": launches[kind], "max_abs_err": worst[kind],
            "ms": head[f"{kind}_ms"], "plain_ms": head[f"{kind}_plain_ms"],
            "bound_ms": head[f"{kind}_bound_ms"],
            "bound_by": head["bound_by"][i],
            "library_ms": head[f"{kind}_library_ms"],
            "shape": f"N={BATCH} C=2 {SHAPE[0]}x{SHAPE[1]} near-identity "
                     f"border",
        })
    print(json.dumps({"kernels": kernels}))
    print(f"[episode] {BATCH / sec:.2f} img/s on {card}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
