"""Model FLOP utilization of serving over the window: the benchmark's own
count of the stage-2 forwards' operations (frontend, encoder, heads, at
each request's valid samples and frames) over the window's wall time, as a
share of the card's bf16 peak."""

from portbench.lib.counting import PEAK_BF16


def read(obs):
    return 100.0 * obs["flops"] / obs["window_s"] / PEAK_BF16
