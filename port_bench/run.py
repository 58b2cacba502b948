"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload world90-f32.walk --seed 7 --seconds 40 --trace 0

Prints the result as the last line of standard output (one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``, each number of the
output check beside its limit), and those numbers as the last lines of
standard error.  Exits 2 without the CUDA devices the cell asks for, and 1
on any other failure, printing no result.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [BENCH_DIR, ROOT]

import argparse  # noqa: E402
import json  # noqa: E402
import traceback  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        from harness.cell import NoCard, run_cell
    except ImportError:
        traceback.print_exc()
        return 1
    try:
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                        t_process=T_PROCESS)
    except NoCard as e:
        print(f"no card: {e}", file=sys.stderr, flush=True)
        return 2
    except Exception:  # noqa: BLE001 - any failure: no result line, a non-zero exit
        traceback.print_exc()
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
