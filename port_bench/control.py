"""The output check's two readings for a cell, on the card.

    python3 port_bench/control.py --workload world90-f32.walk --seconds 8 --seeds 1 2 3

For each seed, one process serves the cell as a run does (a short window at
the cell's own load) and compares the sampled tiles with the reference
twice: the program against the float32 reference (the lower reading of each
number), and the control against it: the reference computed with every
convolution and matmul operand rounded to the precision below the
configuration's (TF32 for float32, float8 e4m3 for bf16), which gives the
upper reading.  The composition is also checked by itself, from the
program's own stage regions; it runs in float32 in both types, so its
control rounds to TF32.  Prints one JSON line a seed, with each sampled
tile's gaps beside the reference's own level and spread (``look``), which
show what a gap over the tile's RMS swings with.  Not run by the benchmark's
runs; the limits in ``workloads/<cell>.json`` were set from its output.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import argparse  # noqa: E402
import json  # noqa: E402

CONTROL = {"fp32": "tf32", "bf16": "fp8"}


def tile_look(got: dict, want: dict) -> dict:
    """One sampled tile: its gaps (the served climate's channel by channel,
    over their conditioning scales), and the reference's elevation (metres)
    and temperature (degrees) level and spread."""
    from harness import check
    from reference.world import COND_INPUT_STD

    e, t = want["elev"].double(), want["climate"][0].double()
    look = {"elev": check.gap(got["elev"], want["elev"]),
            "elev_sqrt": check.elev_sqrt_gap(got["elev"], want["elev"]),
            "climate": check.gap(got["climate"], want["climate"])}
    for c, name in enumerate(("temp", "t_season", "precip", "p_cv")):
        look["climate_scaled." + name] = check.scaled_gap(
            got["climate"][c], want["climate"][c], [COND_INPUT_STD[2 + c]])
    look.update(elev_rms_m=float(e.pow(2).mean().sqrt()), elev_mean_m=float(e.mean()),
                elev_std_m=float(e.std()), land=float((e > 0).double().mean()),
                temp_rms=float(t.pow(2).mean().sqrt()), temp_std=float(t.std()))
    return look


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only (default: all)")
    args = ap.parse_args(argv)
    from harness import check
    from harness.cell import reference, serve

    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for k, seed in enumerate(args.seeds):
        served = serve(args.workload, seed, args.seconds, False, t_process=time.perf_counter())
        want = reference(served)
        quant = CONTROL[served["config"]["dtype"]]
        got, boxes, world_cfg = served["got"], served["boxes"], served["config"]["world"]
        program = check.compare(got, want)
        program.update(check.compare_compose(got, check.composed_from_program(
            got, boxes, world_cfg, served["device"])))
        line = {"workload": args.workload, "seed": seed, "tiles": served["run"]["window"]["tiles"],
                "failed": served["failed"], "program": program,
                "look": [tile_look(g, w) for g, w in zip(got, want)]}
        if k < n_control:
            ctrl = check.compare(reference(served, quant), want)
            ctrl.update(check.compare_compose(got, check.composed_from_program(
                got, boxes, world_cfg, served["device"], "tf32")))
            line.update(control=quant, control_reading=ctrl)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
