"""Transcript-based AD classifiers in PyTorch (the port's
``text/classifier.py``; the reference's Lightning ``SingleForwardModel``
family, centralized/Dementia_challenge_models.py:208-577, and the 0207_DM_*
experiment scripts).

  * :class:`TextClassifier`: 1-3 pre-computed input embeddings fused by
    concatenation, a softmax-scored mix (``attention``) or the attentionFuse
    cross-attention (``cross_attention``, with the JAX package's
    single-query attention whose q and k are computed and unused), then a
    dense+tanh pooler and a 2-layer MLP head; parameter names are the flax
    module names (``pooler``, ``clf1``, ``clf2``, ``align_1``,
    ``mha_a_t_v``, ...).
  * :class:`TextTrainer`: cross-entropy (or MSE for the MMSE twin) under
    optax ``adamw`` semantics (``torch.optim.AdamW``, every parameter
    decayed, a zero gradient where a parameter is unused) with the
    ``exp`` / ``lin`` / ``cos`` schedules of the JAX trainer, numpy batch
    order, dropout from a ``torch.Generator`` seeded by ``seed``, and early
    stopping on validation accuracy.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bert import dropout, seeded_init_


@dataclass(frozen=True)
class TextClassifierConfig:
    embed_dim: int = 768
    hidden_dim: int = 768
    num_classes: int = 2          # 1 + regression=True -> MMSE twin
    regression: bool = False
    num_inputs: int = 1
    fusion: str = "concat"        # concat | attention | cross_attention
    dropout: float = 0.1
    # per-input embedding widths for heterogeneous inputs (e.g. mbert 768 +
    # audio 512); inputs arrive flat-concatenated as [B, sum(input_dims)].
    # None -> homogeneous [B, num_inputs, embed_dim] (or [B, embed_dim]).
    input_dims: tuple[int, ...] | None = None
    align_dim: int = 128          # cross_attention projection width

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def part_dims(cfg: TextClassifierConfig, x: np.ndarray | torch.Tensor) -> tuple[int, ...]:
    """The widths of the inputs a batch ``x`` holds (what flax infers at
    init): ``cfg.input_dims``, else one input of ``x``'s width ([B, E]) or
    ``num_inputs`` of E ([B, n, E])."""
    if cfg.input_dims is not None:
        return tuple(cfg.input_dims)
    return (x.shape[1],) if x.ndim == 2 else (x.shape[2],) * x.shape[1]


class TextClassifier(nn.Module):
    def __init__(self, cfg: TextClassifierConfig, dims: Sequence[int]):
        super().__init__()
        c, self.cfg, self.dims = cfg, cfg, tuple(dims)
        if len(dims) == 1 or c.fusion == "concat":
            width = sum(dims)
        elif c.fusion == "cross_attention":
            assert len(dims) == 2, "cross_attention fuses exactly 2 inputs"
            a = c.align_dim
            self.align_1, self.align_2 = nn.Linear(dims[0], a), nn.Linear(dims[1], a)
            for name in ("mha_a_t", "mha_t_a"):
                for part in ("q", "k", "v", "out"):
                    setattr(self, f"{name}_{part}", nn.Linear(a, a))
            width = 2 * a
        else:   # attention-fuse
            self.fuse_score = nn.Linear(dims[0], 1)
            width = dims[0]
        self.pooler = nn.Linear(width, c.hidden_dim)
        self.clf1 = nn.Linear(c.hidden_dim, c.hidden_dim)
        self.clf2 = nn.Linear(c.hidden_dim, 1 if c.regression else c.num_classes)

    def _single_query_attention(self, q_vec, kv_vec, name: str) -> torch.Tensor:
        """The JAX package's single-query attention over one pooled key:
        softmax over one key is 1, so the output is ``out(v(kv))``; q and k
        are computed (their parameters exist and get zero gradients)."""
        getattr(self, f"{name}_q")(q_vec)
        getattr(self, f"{name}_k")(kv_vec)
        return getattr(self, f"{name}_out")(getattr(self, f"{name}_v")(kv_vec))

    def forward(self, embeddings: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """embeddings: [B, num_inputs, E], [B, E] for 1 input, or (with
        cfg.input_dims) a flat [B, sum(input_dims)] heterogeneous pack;
        dropout only with a ``generator``."""
        c = self.cfg
        if c.input_dims is not None:
            parts = list(torch.split(embeddings, list(c.input_dims), dim=1))
        else:
            if embeddings.ndim == 2:
                embeddings = embeddings[:, None, :]
            parts = list(embeddings.unbind(1))
        if len(parts) == 1:
            x = parts[0]
        elif c.fusion == "concat":
            x = torch.cat(parts, dim=-1)
        elif c.fusion == "cross_attention":
            a, b = self.align_1(parts[0]), self.align_2(parts[1])
            x = torch.cat([self._single_query_attention(a, b, "mha_a_t"),
                           self._single_query_attention(b, a, "mha_t_a")], dim=-1)
        else:
            stack = torch.stack(parts, dim=1)
            w = torch.softmax(self.fuse_score(stack), dim=1)
            x = (w * stack).sum(dim=1)
        x = dropout(torch.tanh(self.pooler(x)), c.dropout, generator)
        x = dropout(F.relu(self.clf1(x)), c.dropout, generator)
        return self.clf2(x)


@dataclass
class TextTrainerConfig:
    learning_rate: float = 2e-5
    lr_schedule: str = "lin"      # exp | lin | cos (reference AdamW options)
    weight_decay: float = 0.01
    num_epochs: int = 20
    batch_size: int = 16
    early_stopping_patience: int = 5
    seed: int = 0


def make_schedule(kind: str, lr: float, steps_per_epoch: int, total: int,
                  exp_rate: float = 0.9, staircase: bool = False) -> Callable[[int], float]:
    """optax's ``exponential_decay(lr, steps_per_epoch, exp_rate,
    staircase)``, ``cosine_decay_schedule(lr, total)`` or
    ``linear_schedule(lr, 0, total)`` as a function of the update count."""
    if kind == "exp":
        def sched(n):
            p = n / steps_per_epoch
            return lr * exp_rate ** (math.floor(p) if staircase else p)
    elif kind == "cos":
        def sched(n):
            return lr * 0.5 * (1.0 + math.cos(math.pi * min(n, total) / total))
    else:
        def sched(n):
            return lr * (1.0 - min(n, total) / total)
    return sched


class AdamW:
    """optax ``adamw(schedule, weight_decay=wd)`` over a module's
    parameters on ``torch.optim.AdamW``: the schedule's value at the count
    of updates done, and a zero gradient for a parameter the loss did not
    reach (optax still decays it)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], schedule: Callable[[int], float],
                 weight_decay: float):
        self.params, self.schedule, self.count = list(params), schedule, 0
        self.opt = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for g in self.opt.param_groups:
            g["lr"] = self.schedule(self.count)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1


def classification_loss(logits: torch.Tensor, y: torch.Tensor, regression: bool) -> torch.Tensor:
    if regression:
        return torch.mean((logits[:, 0] - y) ** 2)
    return F.cross_entropy(logits.float(), y.long())


def snapshot(model: nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class TextTrainer:
    """Fit/eval loop with early stopping on validation accuracy
    (EarlyStopping/ModelCheckpoint on val_acc in the reference), on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: TextClassifierConfig, tcfg: TextTrainerConfig = None,
                 device: str | torch.device = "cuda"):
        from ..serving.engine import resolve_device

        self.cfg = cfg
        self.tcfg = tcfg or TextTrainerConfig()
        self.device = resolve_device(device)
        self.model: TextClassifier | None = None
        self.best_params = None

    def init_params(self, x_sample: np.ndarray) -> dict[str, torch.Tensor]:
        """The classifier's initial state dict for inputs shaped like
        ``x_sample``, drawn from a generator seeded with ``tcfg.seed``."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        with torch.device(self.device):
            model = TextClassifier(self.cfg, part_dims(self.cfg, x_sample))
        return seeded_init_(model, gen).state_dict()

    def fit(self, x_train: np.ndarray, y_train: np.ndarray,
            x_val: np.ndarray | None = None, y_val: np.ndarray | None = None) -> dict:
        t, dev = self.tcfg, self.device
        x = torch.as_tensor(np.asarray(x_train, np.float32), device=dev)
        y = torch.as_tensor(np.asarray(y_train), device=dev)
        with torch.device(dev):
            self.model = TextClassifier(self.cfg, part_dims(self.cfg, x))
        self.model.load_state_dict(self.init_params(np.asarray(x_train[:1], np.float32)))
        steps_per_epoch = max(len(x) // t.batch_size, 1)
        opt = AdamW(self.model.parameters(),
                    make_schedule(t.lr_schedule, t.learning_rate, steps_per_epoch,
                                  max(steps_per_epoch * t.num_epochs, 1)),
                    t.weight_decay)
        gen = torch.Generator(dev).manual_seed(t.seed)
        best_metric, patience, history = -np.inf, 0, []
        nprng = np.random.default_rng(t.seed)
        for epoch in range(t.num_epochs):
            order = nprng.permutation(len(x))
            losses = []
            for i in range(0, len(order) - t.batch_size + 1, t.batch_size):
                idx = torch.as_tensor(order[i: i + t.batch_size], device=dev)
                loss = classification_loss(self.model(x[idx], gen), y[idx],
                                           self.cfg.regression)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
            row = {"epoch": epoch, "train_loss": float(np.mean(losses)) if losses else 0.0}
            if x_val is not None:
                val = self.evaluate(x_val, y_val)
                row.update({f"val_{k}": v for k, v in val.items()})
                metric = -val["mse"] if self.cfg.regression else val["acc"]
                if metric > best_metric:
                    best_metric, patience = metric, 0
                    self.best_params = snapshot(self.model)
                else:
                    patience += 1
                    if patience >= t.early_stopping_patience:
                        history.append(row)
                        break
            history.append(row)
        if self.best_params is not None:
            self.model.load_state_dict(self.best_params)
        return {"history": history, "best_val_metric": float(best_metric)}

    @torch.no_grad()
    def predict(self, x: np.ndarray) -> np.ndarray:
        logits = self.model(torch.as_tensor(np.asarray(x, np.float32), device=self.device))
        if self.cfg.regression:
            return logits[:, 0].cpu().numpy()
        return logits.argmax(dim=-1).cpu().numpy()

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> dict:
        pred = self.predict(x)
        if self.cfg.regression:
            return {"mse": float(np.mean((pred - np.asarray(y)) ** 2))}
        return {"acc": float(np.mean(pred == np.asarray(y)))}


def dense_state_dict_from_flax(params: Mapping, names: Sequence[str]) -> dict[str, torch.Tensor]:
    """flax ``Dense`` params (``kernel`` [in, out], ``bias``) of the given
    top-level modules -> ``name.weight`` [out, in] / ``name.bias`` (for the
    tests and the trainers' grafting)."""
    sd = {}
    for n in names:
        sd[f"{n}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(params[n]["kernel"], np.float32).T))
        sd[f"{n}.bias"] = torch.from_numpy(np.asarray(params[n]["bias"], np.float32).copy())
    return sd


def embed_sessions(encoder_apply: Callable[[np.ndarray, np.ndarray], np.ndarray],
                   tokenizer, texts: Sequence[str], max_length: int = 512,
                   batch_size: int = 16) -> np.ndarray:
    """Embed session documents with a BertEncoder pooled output (the
    reference's ``_get_embedding``), batched with padding."""
    out = []
    for i in range(0, len(texts), batch_size):
        chunk = texts[i: i + batch_size]
        enc = [tokenizer.encode(t, max_length=max_length) for t in chunk]
        width = max(len(ids) for ids, _ in enc)
        ids = np.full((len(chunk), width), tokenizer.pad_id, dtype=np.int32)
        mask = np.zeros((len(chunk), width), dtype=np.int32)
        for j, (seq, m) in enumerate(enc):
            ids[j, : len(seq)] = seq
            mask[j, : len(m)] = m
        out.append(np.asarray(encoder_apply(ids, mask)))
    return np.concatenate(out, axis=0)
