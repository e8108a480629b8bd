"""Kernel B2 (``csrc/flash_bwd.cu``, its three launches per call) over the
traced training steps: the least time of its calls (each at its rows' valid
frames) over the time the profiler gives its launches."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or obs["b2_calls"] != obs["calls_expected"]:
        return None
    seconds, n = tr.kernel_seconds("flash_bwd")
    return 100.0 * obs["b2_least_s"] / seconds if n else None
