"""Median latency over every request of the window, each timed from when
it was due to its answer."""

import statistics


def read(obs):
    return statistics.median(obs["latency_ms"])
