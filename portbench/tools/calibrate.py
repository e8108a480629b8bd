"""Readings for the limits of ``correct``: the numbers a cell compares,
over many seeds, for the program and for its control (the program's own
lower-precision path), in one process so set-up is paid once per seed and
not once per process.

    python3 portbench/tools/calibrate.py --workload <name> --seeds 12 --seconds 3 \
        [--control-seeds 3] [--first-seed N] [--fault NAME]

Prints one JSON line per run: the side, the seed and each compared number.
``--fault`` plants one of ``lib/faults.py``'s faults under the program's
runs (the reading of a fault at the cell's own size). The benchmark's own
runs never run the control or a fault.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench.lib.harness import Context, forbidden_modules, load_cell, load_spec, run_kind

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if args.fault:
        from portbench.lib.faults import FAULTS

        class _Patch:  # setattr that stays for the process
            @staticmethod
            def setattr(obj, name, value):
                setattr(obj, name, value)

        FAULTS[args.fault](_Patch())
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell, config, traffic, limits = load_cell(args.workload, load_spec())
    runs = [(False, args.first_seed + 7919 * i) for i in range(args.seeds)]
    runs += [(True, args.first_seed + 7919 * i) for i in range(args.control_seeds)]
    for control, seed in runs:
        ctx = Context(cell, config, traffic, limits, seed, args.seconds, False,
                      torch.device("cuda", 0), time.perf_counter(), control)
        try:
            out = run_kind(ctx)
            row = {c.name: c.value for c in out.checks}
            row.update(out.obs.get("diag", {}), failed=out.failed)
        except Exception as e:  # a control that crashes gives no number
            row = {"error": repr(e)}
        print(json.dumps({"workload": args.workload, "control": control, "seed": seed,
                          "fault": args.fault, **row}), flush=True)
        torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"loaded {forbidden_modules()}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
