"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``privacy_preserve_federated_asr_tpu_torch``) on a machine with a CUDA
card. The last line of standard output is the result's JSON; the numbers
``correct`` compares are the last lines of standard error. See README.md.
"""

import os
import sys
import time


def _process_start() -> float:
    """When this process started, on the ``time.perf_counter`` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
# keep libraries that can load JAX from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from portbench.lib.harness import main

    sys.exit(main(sys.argv[1:], T_PROCESS))
