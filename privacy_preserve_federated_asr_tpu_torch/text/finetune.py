"""End-to-end text-branch fine-tuning in PyTorch (the port's
``text/finetune.py``): the encoder inside the training graph, AdamW over
ALL parameters.

This is the reference's ``SingleForwardModel`` training setup
(centralized/Dementia_challenge_models.py:304-313: ``forward`` runs
``inp_model(inp)`` and ``configure_optimizers`` builds
``AdamW(self.parameters())`` with exp/lin/cos schedulers under Lightning).
Head parity: ``logits = clf2(clf1(pooled))``, two linear layers fused ->
fused//2 -> num_labels with no nonlinearity between them
(Dementia_challenge_models.py:243-244,307).

Tokenization pads every example to one ``max_length``. Multi-input
experiments: one trainable encoder per TEXT input (``encoder_{i}``, or one
shared ``encoder``), pooled outputs fused by concat or the attentionFuse
cross-attention; AUDIO inputs enter as precomputed features at the head
(``extra``). Data parallelism (``dp > 1``, a JAX mesh in the JAX package)
is refused by name until the parallel slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .bert import BertConfigT, BertEncoder, seeded_init_, state_dict_from_flax_bert
from .classifier import (AdamW, classification_loss, dense_state_dict_from_flax,
                         make_schedule, snapshot)


@dataclass(frozen=True)
class FinetuneConfig:
    bert: BertConfigT
    num_text_inputs: int = 1
    extra_dim: int = 0            # frozen (audio/semb) features fed to the head
    num_classes: int = 2
    regression: bool = False      # MMSE twin (SingleForwardModelRegression)
    fusion: str = "concat"        # concat | cross_attention
    align_dim: int = 128          # attentionFuse alignhiddensize
    share_encoder: bool = False   # one encoder serving every text input

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def fused_dim(self) -> int:
        if self.fusion == "cross_attention":
            return 2 * self.align_dim + self.extra_dim
        return self.num_text_inputs * self.bert.hidden_size + self.extra_dim

    @property
    def encoder_names(self) -> list[str]:
        return (["encoder"] if self.share_encoder
                else [f"encoder_{i}" for i in range(self.num_text_inputs)])


class FinetuneTextModel(nn.Module):
    """Trainable BERT encoder(s) + the reference's linear clf1/clf2 head
    (the flax module names)."""

    def __init__(self, cfg: FinetuneConfig):
        super().__init__()
        c = self.cfg = cfg
        for name in cfg.encoder_names:
            self.add_module(name, BertEncoder(cfg.bert))
        if c.fusion == "cross_attention":
            h, a = c.bert.hidden_size, c.align_dim
            self.align_1, self.align_2 = nn.Linear(h, a), nn.Linear(h, a)
            for name in ("mha_a_t_out", "mha_a_t_v", "mha_t_a_out", "mha_t_a_v"):
                self.add_module(name, nn.Linear(a, a))
        self.clf1 = nn.Linear(c.fused_dim, c.fused_dim // 2)
        self.clf2 = nn.Linear(c.fused_dim // 2, 1 if c.regression else c.num_classes)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                extra: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """input_ids/attention_mask: [B, L] for one text input or
        [B, num_text_inputs, L]; extra: [B, extra_dim] frozen features;
        dropout only with a ``generator``."""
        c = self.cfg
        if input_ids.ndim == 2:
            input_ids, attention_mask = input_ids[:, None, :], attention_mask[:, None, :]
        assert input_ids.shape[1] == c.num_text_inputs, (
            f"got {input_ids.shape[1]} text inputs, config says {c.num_text_inputs}")
        pooled = []
        for i in range(c.num_text_inputs):
            enc = getattr(self, "encoder" if c.share_encoder else f"encoder_{i}")
            pooled.append(enc(input_ids[:, i], attention_mask[:, i], generator=generator)[1])
        if c.fusion == "cross_attention":
            assert len(pooled) == 2, "cross_attention fuses exactly 2 text inputs"
            a, b = self.align_1(pooled[0]), self.align_2(pooled[1])
            parts = [self.mha_a_t_out(self.mha_a_t_v(b)), self.mha_t_a_out(self.mha_t_a_v(a))]
        else:
            parts = pooled
        if extra is not None:
            assert c.extra_dim and extra.shape[-1] == c.extra_dim, (
                f"extra width {extra.shape[-1]} != extra_dim {c.extra_dim}")
            parts = parts + [extra.float()]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return self.clf2(self.clf1(x))   # reference head: purely linear


def finetune_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's ``FinetuneTextModel`` params -> the port's state
    dict (for the tests)."""
    sd = {}
    for name, sub in params.items():
        if name.startswith("encoder"):
            sd.update({f"{name}.{k}": v for k, v in state_dict_from_flax_bert(sub).items()})
        else:
            sd.update(dense_state_dict_from_flax(params, [name]))
    return sd


@dataclass
class FinetuneTrainerConfig:
    learning_rate: float = 2e-5
    lr_schedule: str = "lin"      # exp | lin | cos (configure_optimizers)
    weight_decay: float = 0.01
    num_epochs: int = 4
    batch_size: int = 8
    early_stopping_patience: int = 3
    max_length: int = 64          # static token length
    dp: int = 1                   # data parallelism: refused until the parallel slice
    seed: int = 0


class FinetuneTextTrainer:
    """Fit/eval with AdamW over ALL params (encoders + head) and early
    stopping on validation accuracy, on ``device`` (``cuda`` unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: FinetuneConfig, tokenizer,
                 tcfg: FinetuneTrainerConfig | None = None,
                 device: str | torch.device = "cuda"):
        from ..serving.engine import resolve_device

        self.cfg = cfg
        self.tok = tokenizer
        self.tcfg = tcfg or FinetuneTrainerConfig()
        if self.tcfg.dp > 1:
            raise NotImplementedError(
                f"text --finetune --dp {self.tcfg.dp} (data-parallel fine-tuning over a "
                f"mesh) is not ported yet: it comes with the parallel slice")
        assert self.tcfg.max_length <= cfg.bert.max_position_embeddings, (
            f"max_length={self.tcfg.max_length} exceeds the encoder's "
            f"max_position_embeddings={cfg.bert.max_position_embeddings}")
        self.device = resolve_device(device)
        self.model: FinetuneTextModel | None = None
        self.best_params = None

    # -- data plumbing ----------------------------------------------------
    def tokenize(self, texts_per_input: Sequence[Sequence[str]]
                 ) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids, mask), each [N, num_text_inputs, max_length] int32."""
        L = self.tcfg.max_length
        n, k = len(texts_per_input[0]), len(texts_per_input)
        assert k == self.cfg.num_text_inputs, (
            f"{k} text input columns, config says {self.cfg.num_text_inputs}")
        ids = np.full((n, k, L), self.tok.pad_id, dtype=np.int32)
        mask = np.zeros((n, k, L), dtype=np.int32)
        for j, texts in enumerate(texts_per_input):
            assert len(texts) == n, "text input columns must align"
            for i, t in enumerate(texts):
                seq, m = self.tok.encode(str(t), max_length=L, pad_to=L)
                ids[i, j], mask[i, j] = seq, m
        return ids, mask

    def init_params(self, encoder_params: Mapping | None = None) -> FinetuneTextModel:
        """Build the model with weights drawn from a generator seeded with
        ``tcfg.seed``; ``encoder_params`` (a ``BertEncoder`` state dict, as
        ``port_hf_bert`` gives it) is grafted into every encoder tower."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        with torch.device(self.device):
            self.model = seeded_init_(FinetuneTextModel(self.cfg), gen)
        if encoder_params is not None:
            for name in self.cfg.encoder_names:
                getattr(self.model, name).load_state_dict(encoder_params, strict=True)
        return self.model

    def _schedule(self, steps_per_epoch: int):
        t = self.tcfg
        # ExponentialLR(gamma=0.5) steps once per epoch
        return make_schedule(t.lr_schedule, t.learning_rate, steps_per_epoch,
                             max(steps_per_epoch * t.num_epochs, 1), exp_rate=0.5,
                             staircase=True)

    def _tensors(self, ids, mask, y=None, extra=None):
        dev = self.device
        out = [torch.as_tensor(ids, device=dev).long(), torch.as_tensor(mask, device=dev),
               None if extra is None else torch.as_tensor(np.asarray(extra, np.float32),
                                                          device=dev)]
        if y is not None:
            out.append(torch.as_tensor(y, device=dev))
        return out

    def _loss(self, ids, mask, extra, y, generator) -> torch.Tensor:
        """The training objective (shared by fit() and loss_and_grads)."""
        return classification_loss(self.model(ids, mask, extra, generator), y,
                                    self.cfg.regression)

    # -- fit/eval ---------------------------------------------------------
    def fit(self, texts_per_input: Sequence[Sequence[str]], labels: np.ndarray,
            extra: np.ndarray | None = None,
            val_texts_per_input: Sequence[Sequence[str]] | None = None,
            val_labels: np.ndarray | None = None,
            val_extra: np.ndarray | None = None,
            encoder_params: Mapping | None = None) -> dict:
        t, c = self.tcfg, self.cfg
        if self.model is None:
            self.init_params(encoder_params)
        elif encoder_params is not None:
            raise ValueError("params are already initialized; grafting encoder_params now "
                             "would be ignored: pass them to init_params() or use a fresh "
                             "trainer")
        ids, mask = self.tokenize(texts_per_input)
        val_tok = self.tokenize(val_texts_per_input) if val_labels is not None else None
        labels = np.asarray(labels)
        steps_per_epoch = max(len(labels) // t.batch_size, 1)
        opt = AdamW(self.model.parameters(), self._schedule(steps_per_epoch), t.weight_decay)
        gen = torch.Generator(self.device).manual_seed(t.seed)
        y = labels.astype(np.float32 if c.regression else np.int32)
        ids_t, mask_t, extra_t, y_t = self._tensors(ids, mask, y, extra)
        best_metric, patience, history = -np.inf, 0, []
        nprng = np.random.default_rng(t.seed)
        for epoch in range(t.num_epochs):
            order = nprng.permutation(len(y))
            losses = []
            for i in range(0, len(order) - t.batch_size + 1, t.batch_size):
                idx = torch.as_tensor(order[i: i + t.batch_size], device=self.device)
                loss = self._loss(ids_t[idx], mask_t[idx],
                                  None if extra_t is None else extra_t[idx], y_t[idx], gen)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
            row = {"epoch": epoch, "train_loss": float(np.mean(losses)) if losses else 0.0}
            if val_labels is not None:
                val = self._evaluate_tokenized(val_tok, val_labels, val_extra)
                row.update({f"val_{k}": v for k, v in val.items()})
                metric = -val["mse"] if c.regression else val["acc"]
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

    def predict(self, texts_per_input, extra: np.ndarray | None = None) -> np.ndarray:
        return self._predict_tokenized(self.tokenize(texts_per_input), extra)

    @torch.no_grad()
    def _predict_tokenized(self, tok_pair, extra: np.ndarray | None) -> np.ndarray:
        ids, mask = tok_pair
        b = self.tcfg.batch_size
        out = []
        for i in range(0, len(ids), b):
            bids, bmask, bextra = self._tensors(
                ids[i: i + b], mask[i: i + b], extra=None if extra is None else extra[i: i + b])
            out.append(self.model(bids, bmask, bextra).float().cpu().numpy())
        logits = np.concatenate(out, axis=0)
        return logits[:, 0] if self.cfg.regression else np.argmax(logits, axis=-1)

    def evaluate(self, texts_per_input, labels, extra: np.ndarray | None = None) -> dict:
        return self._evaluate_tokenized(self.tokenize(texts_per_input), labels, extra)

    def _evaluate_tokenized(self, tok_pair, labels, extra: np.ndarray | None = None) -> dict:
        pred = self._predict_tokenized(tok_pair, extra)
        y = np.asarray(labels)
        if self.cfg.regression:
            return {"mse": float(np.mean((pred - y) ** 2))}
        return {"acc": float(np.mean(pred == y))}

    def loss_and_grads(self, texts_per_input, labels, extra: np.ndarray | None = None,
                       dropout_seed: int = 0):
        """One forward-backward on the given batch (dropout drawn from a
        generator seeded with ``dropout_seed``) -> (loss, {name: gradient as
        numpy})."""
        c = self.cfg
        if self.model is None:
            self.init_params()
        ids, mask = self.tokenize(texts_per_input)
        y = np.asarray(labels).astype(np.float32 if c.regression else np.int32)
        gen = torch.Generator(self.device).manual_seed(dropout_seed)
        self.model.zero_grad(set_to_none=True)
        loss = self._loss(*self._tensors(ids, mask, y, extra), gen)
        loss.backward()
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu().numpy()
                 for k, p in self.model.named_parameters()}
        self.model.zero_grad(set_to_none=True)
        return loss.item(), grads

    def encoder_param_norm_delta(self, params_before: Mapping[str, torch.Tensor]) -> float:
        """L2 distance between the current and the given encoder parameters
        (a state dict of the model): the proof that fine-tuning moves the
        encoder."""
        tot = 0.0
        for k, v in self.model.state_dict().items():
            if k.startswith("encoder"):
                tot += float(torch.sum((v.float() - params_before[k].to(v.device).float()) ** 2))
        return float(np.sqrt(tot))
