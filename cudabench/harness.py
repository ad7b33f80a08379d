"""One run of one cell: set-up, the three checked steps, the measured
window, optionally the traced window, the plain reference, the result.

Everything a cell needs is found by name:
``BENCHMARK.json`` names the cell's configuration and traffic mix;
``configs/<config>.json`` (the manifest's ``file``) holds the model, the
chain, the solver and the optimiser; ``workloads/<traffic>.json`` the
step, the batch and the counts of steps; ``limits/<cell>.json`` the
limit of each number compared; ``metrics/<metric>.py`` reads one
per-layer metric; ``rooflines/*.json`` name the kernels that do the
warps and compositions."""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from cudabench import check, costs, inputs
from cudabench import trace as tracing
from cudabench.reference.step import ReferenceTrainer

FORBIDDEN = ("jax", "jaxlib", "flax", "advchain_tpu")
CHECK_STEPS = 3
GIB = 2.0 ** 30


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = load_json(self.root / "BENCHMARK.json")
        self.bench = self.root / self.data["paths"][0]

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return load_json(self.bench / "workloads" / f"{name}.json")

    def limits(self, cell):
        return load_json(self.bench / "limits" / f"{cell}.json")

    def end_to_end(self, cell):
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        """Per-layer metrics this cell reports: those listing it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def metric_reader(self, name):
        """The ``read(ctx)`` of ``metrics/<name>.py``."""
        path = self.bench / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"cudabench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def rooflines(self):
        """Every ``rooflines/*.json``: {pattern, work, counter}."""
        return [load_json(p) for p in
                sorted((self.bench / "rooflines").glob("*.json"))]


def power_limit():
    """The card's name and power limit as nvidia-smi reports them, or
    'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules():
    """Top-level module names of JAX or the JAX package that are loaded."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """A cell's set-up: the weights, the pool and the port's train step
    made from ``seed`` on ``device``, driven through the checked steps.
    ``fault``: a callable given the built ``sut.System`` (a test's way to
    break the timed path underneath)."""

    def __init__(self, manifest, cell_name, seed, device, fault=None):
        from cudabench import sut
        cell = manifest.cell(cell_name)
        self.config = manifest.config(cell["config"])
        self.traffic = manifest.traffic(cell["traffic"])
        self.kind = self.traffic["step"]
        self.batch = int(self.traffic["batch"])
        self.seeds = inputs.subseeds(seed)
        self.device = device
        weights = inputs.make_weights(self.config, self.seeds["weights"],
                                      device)
        self.theta0 = {k: v.clone() for k, v in weights.items()}
        self.images, self.labels = inputs.make_pool(
            self.config, self.batch, int(self.traffic["pool"]),
            self.seeds["data"], device)
        self.system = sut.System(self.config, self.kind, self.batch, weights,
                                 self.seeds["wrapper"], device)
        if fault is not None:
            fault(self.system)
        self.gen = torch.Generator(device=device).manual_seed(
            self.seeds["chain"])
        self.done = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=device)

    def step(self):
        """One step of the timed path on the pool's next batch."""
        i = self.done % self.images.shape[0]
        m = self.system.step(self.images[i], self.labels[i], self.gen)
        self.bad.add_((~torch.isfinite(m["total_loss"])).to(torch.int64))
        self.done += 1
        return m

    def checked_steps(self):
        """The first ``CHECK_STEPS`` steps, recorded for the comparison:
        {'losses', 'grad1', 'theta0', 'theta3'}."""
        prog = {"losses": [], "theta0": self.theta0}
        for s in range(CHECK_STEPS):
            m = self.step()
            prog["losses"].append(
                {k: float(v) for k, v in m.items() if k != "total_loss"}
                if self.kind == "adversarial"
                else {"supervised_loss": float(m["total_loss"])})
            if s == 0:
                prog["grad1"] = self.system.first_gradient()
        prog["theta3"] = {k: v.detach().clone()
                          for k, v in self.system.parameters().items()}
        return prog

    def release(self):
        """Free the port's state before the reference runs."""
        self.system = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw):
        return reference_records(self.config, self.kind, self.batch,
                                 self.theta0, self.images, self.labels,
                                 self.seeds, self.device, **kw)


def run_cell(manifest, cell_name, seed, seconds, trace, device,
             process_start, fault=None, log=None):
    """One run of a cell; returns the result's dict (``check`` last)."""
    from cudabench import sut
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    limits = manifest.limits(cell_name)
    on_card = torch.device(device).type == "cuda"
    phases = [("start", process_start), ("harness", time.time())]
    run = Run(manifest, cell_name, seed, device, fault)
    config, traffic, kind, batch = run.config, run.traffic, run.kind, \
        run.batch
    phases.append(("built", time.time()))
    prog = run.checked_steps()
    phases.append(("checked steps", time.time()))
    for _ in range(int(traffic.get("warm_steps", 0))):
        run.step()
    _sync(device)
    phases.append(("warm steps", time.time()))
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0

    # ---------------------------------------------------------- window
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    first = run.done
    t0 = time.perf_counter()
    setup_s = time.time() - process_start
    while True:
        run.step()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = run.done - first
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = int(run.bad)

    timeline = launches = None
    if trace:
        sut.reset_launch_counts()
        timeline = tracing.record(run.step, int(traffic["trace_steps"]),
                                  lambda: _sync(device))
        launches = sut.launch_counts()
        timeline.summary = tracing.summarize(timeline)
        spans = timeline.summary["step_spans"]
        log(f"traced steps' host spans (s), for the record: min "
            f"{spans[0]!r} median {spans[len(spans) // 2]!r} max "
            f"{spans[-1]!r}")

    # ------------------------------------------------ the plain reference
    run.release()
    t_ref = time.perf_counter()
    ref = run.reference()
    log(f"reference {time.perf_counter() - t_ref!r} s")
    values = check.numbers(prog, ref)
    ok, lines, checked = check.judge(values, limits)

    # ---------------------------------------------------------- result
    metrics = {}
    rate = steps * batch / window_s
    if not trace:
        measured = {traffic["rate_metric"]: rate, "peak_mem_gib": peak / GIB,
                    "setup_s": setup_s}
        for m in manifest.end_to_end(cell_name):
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    else:
        card = power_limit() if on_card else "cpu"
        # what a per-layer metric's reader may read
        ctx = types.SimpleNamespace(
            config=config, traffic=traffic, cell=cell_name, batch=batch,
            step=kind, rate=rate, steps=steps, window_s=window_s,
            trace=timeline.summary, trace_steps=timeline.steps,
            launches=launches, rooflines=manifest.rooflines(), costs=costs,
            card=card, log=log)
        for m in manifest.per_layer(cell_name):
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"card {card}")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1 if on_card else 0,
                   "memory_peak_bytes": max(peak, setup_peak)}
    result = {"correct": bool(ok and failed == 0 and steps > 0),
              "attempted": steps, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        s = timeline.summary
        device_info["busy_s"] = s["busy_s"]
        device_info["window_s"] = s["window_s"]
        result["breakdown"] = s["breakdown"]
    result["check"] = checked
    log("setup phases " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(phases, phases[1:])))
    log(f"run {cell_name} seed {seed}: {steps} steps of {batch} in "
        f"{window_s!r} s, setup {setup_s!r} s, peak {peak} B, "
        f"failed steps {failed}")
    log(f"losses program {prog['losses']} reference {ref['losses']}")
    for line in lines:
        log(line)
    return result


def reference_records(config, kind, batch, theta0, images, labels, seeds,
                      device, rows=None, tf32=False, scale=None,
                      dtype=torch.float32):
    """The plain reference's three steps from ``theta0`` on the pool's
    first three batches: {'losses', 'grad1', 'theta0', 'theta3',
    'episodes'}.  ``rows``: the half-batch fault; ``tf32``: TF32 on, the
    control; ``scale``: every image multiplied by it (a perturbation);
    ``dtype``: the reference's precision (float64: a second witness)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        trainer = ReferenceTrainer(config, kind, batch, theta0,
                                   seeds["chain"], seeds["wrapper"], device,
                                   rows=rows, dtype=dtype)
        out = {"losses": [], "theta0": theta0}
        for s in range(CHECK_STEPS):
            image = images[s] if scale is None else images[s] * scale
            losses, grads = trainer.step(image, labels[s])
            out["losses"].append(losses)
            if s == 0:
                out["grad1"] = {k: g.detach() for k, g in grads.items()}
        out["theta3"] = trainer.params()
        out["episodes"] = trainer.episodes_done
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags

