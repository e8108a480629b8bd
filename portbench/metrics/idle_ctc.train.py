"""Percent of the traced training steps' sub-window in which the card
idled while the host was inside the CTC loss (``dacs.ctc.forward``,
``dacs.ctc.backward``): its recursions loop over frames in Python."""

from portbench.lib.spans import idle_split


def read(obs):
    split = idle_split(obs)
    return None if split is None else split["ctc"]
