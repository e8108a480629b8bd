"""Find the highest rate the engine sustains under an open-loop mix: one
engine, windows of ``--seconds`` at rates rising by ``--step`` from
``--start``, until one is not sustained.

    python3 portbench/tools/knee.py --workload <open-loop cell> --seed N \
        --start 40 --step 1.25 --seconds 10

A rate is sustained when at least 99% of its requests are answered by the
end of the window plus one second and the queue does not grow: the median
latency of the last quarter of the requests is within 1.5x (+50 ms) of the
first quarter's. Prints one JSON line per rate, with how late the sender ran.
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    import argparse
    import time

    import numpy as np
    import torch

    from portbench.kinds.open_loop import open_loop
    from portbench.lib import inputs
    from portbench.lib.harness import Context, load_cell, load_spec
    from portbench.lib.serving import Served, quantile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3_100_000_019)
    ap.add_argument("--start", type=float, default=40.0)
    ap.add_argument("--step", type=float, default=1.25)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--max-rates", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell, config, traffic, limits = load_cell(args.workload, load_spec())
    ctx = Context(cell, config, traffic, limits, args.seed, args.seconds, False,
                  torch.device("cuda", 0), time.perf_counter())
    served = Served(ctx)
    pool = inputs.ClipPool(args.seed, traffic["clips"], traffic["clip_s"])
    rate = args.start
    for k in range(args.max_rates):
        offsets = inputs.arrival_offsets(traffic, args.seed + k, rate, args.seconds)
        lengths = inputs.request_lengths(traffic, args.seed + k, len(offsets))
        f0 = served.engine.forwards
        reqs = open_loop(served, pool, offsets, lengths, len(served.requests))
        t_end = reqs[0].t_due + args.seconds + 1.0
        ontime = sum(q.result is not None and q.t_done <= t_end for q in reqs) / len(reqs)
        lat = [q.latency * 1e3 for q in reqs]
        quarter = max(len(lat) // 4, 1)
        head, tail = statistics.median(lat[:quarter]), statistics.median(lat[-quarter:])
        late = np.array([q.t_sent - q.t_due for q in reqs]) * 1e3
        ok = ontime >= 0.99 and tail <= 1.5 * head + 50.0
        fw = served.engine.forwards - f0
        print(json.dumps({"rate_rps": rate, "requests": len(reqs), "answered_in_window": ontime,
                          "p50_ms": statistics.median(lat), "p95_ms": quantile(lat, 0.95),
                          "first_quarter_p50_ms": head, "last_quarter_p50_ms": tail,
                          "batch_fill": len(reqs) / max(fw * traffic["batch_size"], 1),
                          "sender_late_max_ms": float(late.max()), "sustained": ok}),
              flush=True)
        if not ok:
            break
        rate *= args.step
    served.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
