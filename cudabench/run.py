"""The benchmark of advchain_tpu_torch, the PyTorch and CUDA port, on one
or more NVIDIA GPUs.

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  The cell's traffic runs as a closed loop
of training steps for ``--seconds``; with ``--trace 0`` the last line of
standard output is a JSON object with the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  The run fails, printing no result,
when CUDA is absent or has fewer devices than the cell asks for, when the
port cannot be imported from this checkout, or when JAX or the JAX package
was loaded.  TF32 is off before anything runs: the configurations are
float32.

How a later change extends it, each by new files alone (the harness finds
them by the names in BENCHMARK.json; no existing file is edited):

- a configuration: ``configs/<config>.json`` (the model's name and
  arguments, the image, the chain, the solver, the optimiser, ``source``,
  ``reduced``, ``assumed``), and, for a model the reference lacks,
  ``reference/model_<ModelName>.py`` with ``param_spec``, ``conv_layers``
  and ``forward`` (see ``reference/model_UNet.py``); then an entry in
  BENCHMARK.json's ``configs``;
- a cell: ``workloads/<traffic>.json`` (``step``: adversarial or
  supervised, ``batch``, ``pool``, ``warm_steps``, ``trace_steps``,
  ``rate_metric``) and ``limits/<config>.<traffic>.json`` (the limit of
  each number compared, set from the readings of sound runs and of the
  control, ``control.py``); then an entry in ``workloads``;
- a per-layer metric: ``metrics/<name>.py`` with ``read(ctx)`` returning a
  number or None; ``ctx`` carries the configuration, the traffic, the
  measured window's rate, the traced window's summary (``trace.summarize``)
  and step count, the port's launch counters, the roofline files, ``costs``
  and a ``log`` (see ``harness.run_cell`` and ``layers.py``); then an entry
  in ``per_layer``;
- a kernel of the warps or compositions: ``rooflines/<kernel>.json``
  (``pattern``: the kernel's name as a whole identifier, ``work``: the part
  of the warps' and compositions' work it does, ``counter``: the port's
  launch counter that counts it, or null).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_ENTRY = time.time()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_start():
    """The wall-clock time this process started (Linux), else the entry
    time."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_ENTRY


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = process_start()

    # every cache of the program and of CUDA lives at a fixed path inside
    # the checkout
    cache = ROOT / "build" / "cudabench"
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cudabench import harness

    manifest = harness.Manifest(ROOT)
    cell = manifest.cell(args.workload)
    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"no run: {args.workload} needs {chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    import advchain_tpu_torch
    where = Path(advchain_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"no run: advchain_tpu_torch was imported from {where}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", file=sys.stderr, flush=True)
    result = harness.run_cell(manifest, args.workload, args.seed,
                              args.seconds, bool(args.trace), "cuda", start)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"no result: loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
