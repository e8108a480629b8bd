"""Percent of the traced training steps' sub-window in which the card
idled while the host ran the model's forward and its objectives
(``dacs.train.forward``, ``dacs.train.loss``), the CTC loss left out."""

from portbench.lib.spans import idle_split


def read(obs):
    split = idle_split(obs)
    return None if split is None else split["forward"]
