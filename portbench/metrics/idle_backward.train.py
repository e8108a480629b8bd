"""Percent of the traced training steps' sub-window in which the card
idled while the host was in autograd's backward (``dacs.train.backward``),
the CTC loss's backward left out."""

from portbench.lib.spans import idle_split


def read(obs):
    split = idle_split(obs)
    return None if split is None else split["backward"]
