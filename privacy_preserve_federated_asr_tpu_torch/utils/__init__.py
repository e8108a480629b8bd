"""Host utilities of the port: the native-library bootstrap
(``utils/native.py``), profiling (``utils/profiling.py``) and the
experiment harnesses (``utils/experiments.py``, imported from there: it
pulls in the Trainer)."""

from .profiling import StepProfiler, trace_profile

__all__ = ["StepProfiler", "trace_profile"]
