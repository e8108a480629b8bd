"""Percent of the traced training steps' sub-window in which the card
idled outside the step's forward, loss, backward and optimizer spans: the
cache gather, the host between steps and the sub-window's edges;
``idle.train`` less the four phase shares."""

from portbench.lib.spans import idle_split


def read(obs):
    split = idle_split(obs)
    return None if split is None else split["other"]
