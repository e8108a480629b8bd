"""Checkpoint / resume with ``torch.save`` (the port's ``train/checkpoint.py``).

The JAX package's directory layout: ``<dir>/checkpoint-<step>/`` full train
states with a retention limit (``save_total_limit``), plus ``<dir>/final/``
for the end-of-run export; metadata rides in a sidecar ``metadata.json``.
A full state (``state.pt``) holds the params, the AdamW moments and
schedule, the step and the random streams, so a resume continues exactly;
the export (``model.pt``, :func:`save_params`) holds the params as an fp32
state dict, as the federated engine's finals and round checkpoints do.

Reading the JAX package's orbax checkpoints waits for a later slice (it
needs orbax).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

import torch

STATE_FILE = "state.pt"
MODEL_FILE = "model.pt"


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: int = 2):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_total_limit = save_total_limit

    def save(self, tree: dict[str, Any], step: int, metadata: dict | None = None,
             name: str | None = None) -> Path:
        path = self.dir / (name if name is not None else f"checkpoint-{step}")
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(tree, path / STATE_FILE)
        if metadata is not None:
            (path / "metadata.json").write_text(json.dumps({"step": step, **metadata}))
        if name is None:
            self._prune()
        return path

    def save_final(self, state_dict: dict[str, torch.Tensor],
                   metadata: dict | None = None) -> Path:
        """The reference's ``trainer.save_model(path + "/final")``."""
        return save_params(self.dir / "final", state_dict,
                           None if metadata is None else {"step": -1, **metadata})

    def restore(self, name_or_step: str | int, map_location="cpu") -> dict:
        name = (f"checkpoint-{name_or_step}"
                if isinstance(name_or_step, int) else name_or_step)
        return torch.load(self.dir / name / STATE_FILE, map_location=map_location,
                          weights_only=True)

    def latest_step(self) -> int | None:
        steps = sorted(int(p.name.split("-")[1]) for p in self.dir.glob("checkpoint-*")
                       if p.name.split("-")[1].isdigit())
        return steps[-1] if steps else None

    def _prune(self) -> None:
        cks = sorted((p for p in self.dir.glob("checkpoint-*")
                      if p.name.split("-")[1].isdigit()),
                     key=lambda p: int(p.name.split("-")[1]))
        for p in cks[: max(0, len(cks) - self.save_total_limit)]:
            shutil.rmtree(p)


def save_params(path: str | Path, state_dict: dict[str, torch.Tensor],
                metadata: dict | None = None) -> Path:
    """One-shot params export (the federated engine's weight hand-off and
    round checkpoints): ``<path>/model.pt``, an fp32 CPU state dict, and the
    metadata in ``<path>/metadata.json``. Replaces what was at ``path``."""
    p = Path(path)
    if p.exists():
        shutil.rmtree(p)
    p.mkdir(parents=True)
    torch.save({k: v.detach().float().cpu() for k, v in state_dict.items()}, p / MODEL_FILE)
    if metadata is not None:
        (p / "metadata.json").write_text(json.dumps(metadata))
    return p


def load_params(path: str | Path) -> dict[str, torch.Tensor]:
    """The state dict :func:`save_params` (or a Trainer checkpoint) wrote."""
    sd = load_state_dict(path)
    if sd is None:
        raise FileNotFoundError(f"no port checkpoint or export at {path}")
    return sd


def load_state_dict(path: str | Path) -> dict[str, torch.Tensor] | None:
    """The port's params from a checkpoint directory or file: a final export
    (``model.pt``) or a full state (``state.pt``); None when ``path`` is
    neither."""
    p = Path(path)
    if p.is_dir():
        for f in (MODEL_FILE, STATE_FILE):
            if (p / f).exists():
                p = p / f
                break
        else:
            return None
    if p.name not in (MODEL_FILE, STATE_FILE):
        return None
    tree = torch.load(p, map_location="cpu", weights_only=True)
    return tree["model"] if p.name == STATE_FILE else tree
