"""Percent of the traced training steps' sub-window in which the card
idled while the host ran the optimizer (``dacs.train.optim``: gradient
norm, clipping, AdamW, the schedule)."""

from portbench.lib.spans import idle_split


def read(obs):
    split = idle_split(obs)
    return None if split is None else split["optim"]
