"""The benchmark of nanosim_tpu_torch on one NVIDIA H100.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, their metrics and bounds are in
BENCHMARK.json; PERF.md says why each exists.  The last line of standard
output is the run's result as one JSON object; everything else, the
program's own output included, goes to standard error.  Without a CUDA card
(or with fewer than the cell asks for) the run exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _cache_dirs():
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the port itself builds into
    nanosim_tpu_torch/_build/)."""
    build = os.path.join(HERE, "_build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program prints progress lines (some ending in '\r'): all of it goes
    # to standard error, and the result alone to standard output
    result_out = os.fdopen(os.dup(1), "w")
    sys.stdout.flush()
    os.dup2(2, 1)

    def log(msg):
        print(f"[gpubench] {msg}", file=sys.stderr, flush=True)

    sys.path.insert(0, ROOT)
    _cache_dirs()
    from gpubench.harness import bench

    cell, _, _ = bench.cell_parts(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} card(s)")
        return 2
    result, _ = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START, log=log)
    found = bench.banned_modules(sys.modules)
    if found:
        log(f"modules the benchmark must not load were loaded: {', '.join(found)}")
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"],
                        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                        **result["device"]}
    checks = result.pop("checks")
    result["checks"] = checks  # the numbers compared, last
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    sys.stderr.flush()
    result_out.write("\n" + json.dumps(result) + "\n")
    result_out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
