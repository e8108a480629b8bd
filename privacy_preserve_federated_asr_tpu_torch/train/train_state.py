"""Train state (the port's ``train/train_state.py``): the model with its
params, the optimizer with its moments and schedule, the step count and the
random streams, as one object.

JAX threads one PRNG key through the step; here the streams are three
generators: ``gumbel`` (on the model's device) draws the Gumbel noise,
``seeds`` (on the CPU) the per-layer attention-dropout seeds as host ints,
and the device's default generator the other dropout masks and SpecAugment
(``torch.nn.functional.dropout`` takes no generator). All three are seeded
from the train seed and saved in checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.dacs import DACSModel
from .optim import Optimizer


@dataclass
class DACSTrainState:
    model: DACSModel
    tx: Optimizer
    gumbel: torch.Generator
    seeds: torch.Generator
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def rng_state(self) -> dict:
        dev = self.device
        out = {"gumbel": self.gumbel.get_state(), "seeds": self.seeds.get_state(),
               "cpu": torch.random.get_rng_state()}
        if dev.type == "cuda":
            out["cuda"] = torch.cuda.get_rng_state(dev)
        return out

    def set_rng_state(self, st: dict) -> None:
        self.gumbel.set_state(st["gumbel"])
        self.seeds.set_state(st["seeds"])
        torch.random.set_rng_state(st["cpu"])
        if "cuda" in st:
            torch.cuda.set_rng_state(st["cuda"], self.device)


def create_train_state(model: DACSModel, tx: Optimizer, seed: int) -> DACSTrainState:
    dev = next(model.parameters()).device
    torch.manual_seed(seed)  # the default generators: dropout masks, SpecAugment
    return DACSTrainState(model=model, tx=tx,
                          gumbel=torch.Generator(dev).manual_seed(seed),
                          seeds=torch.Generator("cpu").manual_seed(seed + 1))
