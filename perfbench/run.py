"""Run one cell of the benchmark once and print the contract's result as the
last line of standard output.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout on a machine with the card(s) the cell
asks for; without them it exits 3 and prints no result. ``--target
control`` puts the control (the configuration's plain reference with the
guarantee its module's ``control`` breaks: k - 1 bits a key for the bit
filters) in the program's place, which has to come out as not correct.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--target", choices=("program", "control"), default="program")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    try:
        result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                                  trace=bool(args.trace), device=torch.device("cuda"), t0=T0,
                                  target=args.target)
    except harness.tracing.EmptyTrace as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 4
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the run may not load: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    run = result["run"]
    print(f"perfbench: {args.workload} seed {args.seed}: {run['batches']} batches, "
          f"{run['epochs']} epochs, set-up {run['setup_s']:.3f} s, reference {run['reference_s']:.3f} s, "
          f"memory peak {result['device']['memory_peak_bytes']} B, "
          f"power limit {result['device'].get('power_limit_w')} W; set-up marks (s) "
          f"{json.dumps({k: round(v, 3) for k, v in run['setup_marks_s'].items()})}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
