"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size.  The benchmark's own runs never run this.

    python3 cudabench/control.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control] [--half] [--out PATH]

For each seed, after the cell's set-up:

- ``--program``: the port's three checked steps against the reference
  (the lower readings of sound runs);
- ``--control``: the reference with TF32 on, the nearest precision below
  the configuration's float32, in the program's place;
- ``--half``: the reference on half of each batch, the mean over the rest,
  in the program's place (the half-batch fault);
- ``--perturb EPS``: the reference with every image scaled by ``1 + EPS``
  in the program's place, with each transform's largest gap after PGD
  and the count of entries that moved by more than 0.5 (an affine latent
  whose gradient's sign flipped): how far rounding alone carries;
- ``--float64``: the reference in float64 as a second witness, against
  the float32 reference and (with ``--program``) against the port.

Each reading is a line of JSON on standard output (and appended to
``--out``); the last line holds, per mode and number, the largest and the
smallest reading over the seeds."""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cudabench import check, harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    manifest = harness.Manifest(ROOT)
    readings = {}

    def emit(mode, seed, values):
        line = {"workload": args.workload, "mode": mode, "seed": seed,
                "numbers": values}
        for k, v in values.items():
            readings.setdefault(mode, {}).setdefault(k, []).append(v)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(manifest, args.workload, seed, "cuda")
        prog = run.checked_steps() if args.program else None
        run.release()
        ref = run.reference()
        if prog is not None:
            emit("program", seed, check.numbers(prog, ref))
        if args.control:
            emit("control_tf32", seed, check.numbers(run.reference(tf32=True),
                                                     ref))
        if args.half:
            emit("fault_half_batch", seed, check.numbers(
                run.reference(rows=run.batch // 2), ref))
        if args.perturb:
            other = run.reference(scale=1.0 + args.perturb)
            values = check.numbers(other, ref)
            for i, name in enumerate(e["name"] for e in run.config["chain"]):
                a = [ep[i] for ep in ref["episodes"]]
                b = [ep[i] for ep in other["episodes"]]
                values[f"{name}_max_gap"] = max(
                    float((x - y).abs().max()) for x, y in zip(a, b))
                values[f"{name}_over_half"] = sum(
                    int(((x - y).abs() > 0.5).sum()) for x, y in zip(a, b))
            emit(f"reference_perturbed_{args.perturb:g}", seed, values)
        if args.float64:
            ref64 = run.reference(dtype=torch.float64)
            emit("reference32_vs_float64", seed, check.numbers(ref, ref64))
            if prog is not None:
                emit("program_vs_float64", seed, check.numbers(prog, ref64))
            del ref64
        del run, prog, ref
    summary = {mode: {k: {"max": max(v), "min": min(v), "n": len(v)}
                      for k, v in nums.items()}
               for mode, nums in readings.items()}
    print(json.dumps({"summary": summary,
                      "device": torch.cuda.get_device_name(0),
                      "card": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
