"""Kernel B1 (``csrc/flash_fwd.cu``) over the traced serving sub-window: the
least time of its calls (each at its requests' valid frames) over the time
the profiler gives its launches."""


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    seconds, n = tr.kernel_seconds("flash_fwd")
    return 100.0 * obs["b1_least_s"] / seconds if n else None
