"""How full the dispatcher's batches were over the window: requests over
(batch forwards x batch size)."""


def read(obs):
    return 100.0 * obs["requests"] / (obs["forwards"] * obs["batch_size"])
