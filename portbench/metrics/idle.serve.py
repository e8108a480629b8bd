"""Idle share of the card over the traced serving sub-window: 100 x (1 - busy
/ window), busy the union of the device intervals."""


def read(obs):
    tr = obs.get("trace")
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)
