"""The control of the benchmark's check: the plain reference computed in
the precision below the model's (every float32 uniform rounded to
bfloat16), which the check has to find not correct.

    python3 gpubench/control.py --workload <cell> --seconds <s> --seeds <n> <n> <n> ...

For each seed it makes a run of the cell as the benchmark does (its own
check included), then judges the same written reads against the bfloat16
reference: the comparison with the roles of the two exchanged, which counts
the same reads as the bfloat16 reference in the program's place when the
program equals the float32 reference (its own check reads 0).  It prints a
JSON line a seed.  The benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from gpubench.harness import bench  # noqa: E402


def control(cell: str, seed: int, seconds: float, *, device: str = "cuda", sizes=None,
            log=print) -> dict:
    result, record = bench.run(cell, seed, seconds, False, device=device, sizes=sizes, log=log)
    _, config, traffic = bench.cell_parts(cell)
    mode_mod = bench.mode_module(traffic)
    with tempfile.TemporaryDirectory(prefix="gpubench-control-") as d:
        inputs = mode_mod.make_inputs(config, seed, d, sizes)
        ctl = bench.check_jobs(mode_mod.reference(config, traffic, inputs, uniforms="bfloat16"),
                               record.jobs, record.counters, log=log)
    return {"cell": cell, "seed": seed, "program_correct": result["correct"],
            "program": result["checks"], "control_correct": ctl["correct"],
            "control": ctl["checks"], "checked": ctl["checked"],
            "reads_per_s": result["metrics"].get("reads_per_s", {}).get("value")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    for seed in args.seeds:
        r = control(args.workload, seed, args.seconds,
                    log=lambda m: print(f"[control] {m}", file=sys.stderr, flush=True))
        out.write(json.dumps(r) + "\n")
        out.flush()


if __name__ == "__main__":
    main()
