"""Kernel launches per traced training step that start inside the CTC
loss's spans (``dacs.ctc.forward``, ``dacs.ctc.backward``): the
``cudaLaunchKernel*`` and ``cuLaunchKernel*`` calls among the profiler's
CPU events."""

from portbench.lib.spans import ctc_launches


def read(obs):
    return ctc_launches(obs)
