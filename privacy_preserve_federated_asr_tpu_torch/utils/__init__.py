"""Host utilities of the port: the native-library bootstrap
(``utils/native.py``), named spans for the profiler
(``utils/profiling.py``) and the experiment harnesses
(``utils/experiments.py``, imported from there: it pulls in the
Trainer)."""

from .profiling import span

__all__ = ["span"]
