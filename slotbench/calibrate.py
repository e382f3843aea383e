"""Readings for the limits of ``correct``: many seeds of a cell in one
process, each judged as a run judges it, with the bfloat16 control's numbers
beside the program's on the same frames.

    python -m slotbench.calibrate --workload <cell> --seconds <s> --seeds <n,n,...>

Prints one JSON line a seed (its numbers, the control's, its end-to-end
metrics) and, last, the largest program reading and the smallest control
reading of each number. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def main(argv=None) -> int:
    from slotbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 3
    bench = run.load_benchmark()
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(bench, args.workload, seed, args.seconds, False, also_control=True)
        prog, ctrl = res["numbers"], res.get("control_numbers", {})
        for k, v in prog.items():
            lower[k] = max(lower.get(k, -math.inf), v)
        for k, v in ctrl.items():
            upper[k] = min(upper.get(k, math.inf), v)
        print(json.dumps({"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "program": prog, "control": ctrl,
                          "metrics": {k: m["value"] for k, m in res["metrics"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "upper_over_lower": {k: upper[k] / lower[k] if lower.get(k) else None
                                           for k in upper}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
