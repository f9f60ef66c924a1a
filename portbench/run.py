"""Run one cell of the benchmark on the card this process finds.

    python3 portbench/run.py --workload g500-wcc-healthy --seed 7 \\
        --seconds 51 --trace 0

Prints the result as one JSON line, last on standard output, and each
number the check compared beside its limit as the last lines on standard
error.  Exits non-zero, printing no result, without a CUDA card (or fewer
cards than the cell asks for), when the port is not beside it, or when the
process has loaded JAX or the JAX package.  ``--control 1`` runs the
configuration's reference control in the program's place, for the check to
find wrong; the benchmark's own runs never pass it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# one process with few threads, and every build or kernel cache at a fixed
# path inside the checkout (build/ is not committed)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
CACHE = ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: the reference's control runs in the program's "
                    "place (the check must find it wrong); never a "
                    "benchmark run")
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, loader
    torch.set_num_threads(1)
    try:
        cell = loader.cell(args.workload)
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); this "
                  f"machine has {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        out = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START, control=bool(args.control))
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 1
    for i, (d, job) in enumerate(zip(out.pop("job_seconds"),
                                     out.pop("job_totals"))):
        print(f"job {i}: {d:.4f} s " + json.dumps(job), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
