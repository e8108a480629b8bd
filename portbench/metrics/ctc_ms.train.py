"""Host milliseconds per traced training step under the CTC loss's autograd
Function (``ops/ctc.py`` ``_CTCNLL``), its forward and its backward, from
the profiler's CPU events."""


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    seconds, n = tr.host_seconds({"_CTCNLL", "_CTCNLLBackward"})
    return 1e3 * seconds / obs["trace_steps"] if n else None
