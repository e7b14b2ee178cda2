"""The control of the comparison that decides ``correct``, and the
program's own readings beside it, over several seeds in one process.

    python3 -m slambench.control --workload <cell> --seeds 1,2,3 \
        [--seconds 8] [--variants tf32,f64,magma] [--out out/control.jsonl]

Each seed runs the cell as ``slambench.run`` does, with a window of
``--seconds``, and then runs the reference three times on every sampled
frame and BA event: in float32, against which the program's gaps are
read; with TF32 matmuls (the nearest precision below the configuration's
float32), whose gaps to the float32 reference are the control's; and in
float32 with MAGMA's factorizations and solves in place of cuSOLVER's, a
second sound reference whose gaps show what a sound change of the order
of operations reads. The window-BA solve also runs in float64, whose gaps
show what float32's rounding alone reads there. A line a seed: the
program's widest gaps, the control's, the two witnesses', and each
limit. The benchmark's own
runs never run this.
"""
import argparse
import json
import sys

from slambench import run as srun


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--variants", default="tf32,f64,magma",
                    help="the reference's variants besides float32 "
                         "(tf32 must be one)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("slambench.control: no CUDA card", file=sys.stderr)
        return 2
    man = srun.manifest()
    cell = srun.cell_of(man, args.workload)
    controls = tuple(v for v in args.variants.split(",")
                     if v != "magma" or torch.cuda.has_magma)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, rows, info, other = srun.run_cell(
            man, cell, seed, args.seconds, False, controls=controls)
        line = {"workload": cell["name"], "seed": seed,
                "correct": result["correct"],
                "program": {n: v for n, v, _ in rows},
                "control": other["tf32"], "magma": other.get("magma"),
                "f64": other.get("f64"),
                "limits": {n: l for n, _, l in rows},
                "frames": result["attempted"], "failed": result["failed"],
                **info}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
