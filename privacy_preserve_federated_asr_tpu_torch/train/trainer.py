"""Single-device trainer (the port's ``train/trainer.py``): one train step
serves every DACS recipe and stage.

The JAX ``Trainer`` on one device: stage routing is config (the recipe's
loss, trainable parameters and modes), batches come from the length-bucketed
batcher, and two caches of frozen, deterministic forwards stand in for the
full forward:

  * ``cache_encoder`` (auto: on where the recipe freezes the backbone, the
    DACS stages 1/2): the encoder output of every train utterance is
    computed once and the steps train the heads on it
    (``make_hidden_train_step``); evaluation runs the heads on a cache of
    the eval set's encoder outputs;
  * ``cache_frontend`` (auto for stage 0, off under ``cache_encoder``): the
    conv frontend's output, cropped per batch to the batch's own bucket
    length so the encoder sees the full-forward shapes.

Either falls back to the full forward from waveforms past
``cache_budget_bytes``. Logging, evaluation, checkpoints and the final
export follow the JAX cadences.

``grad_accum = k`` sums k micro-gradients per optimizer update (optax
``MultiSteps``; the schedule counts updates, ``state.step`` micro-steps, and
checkpoints carry the partial sum); ``remat`` recomputes each encoder layer
in the backward pass; ``prefetch`` device batches are staged ahead by a
thread (``train/prefetch.py``); ``scan_layers`` is accepted and changes
nothing here: in JAX it changes the compile and the parameter layout, not
the math, and the weight bridge reads and writes that layout
(``models/port.py``). ``cfg.backbone.dense_impl="int8_train"`` (``cli train
--int8``) trains with W8A8 matmuls and SwitchBack gradients
(``ops/quant.py``); the inference-only ``"int8"`` is refused. Data, tensor, pipeline and sequence parallelism
(``dp``, ``tp``, ``pp``, ``sp``) and ``zero1`` raise ``NotImplementedError``
until the parallel slice.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

from ..data.collate import LengthBucketBatcher, _round_up
from ..data.dataset import AsrExample
from ..data.tokenizer import CTCCharTokenizer
from ..models.backbone import feat_extract_output_lengths
from ..models.config import DACSConfig
from ..models.recipes import get_recipe, validate_stage
from ..serving.engine import resolve_device
from .checkpoint import STATE_FILE, CheckpointManager, load_state_dict
from .logging import JsonlLogger, StepTimer, record_result
from .metrics import wer
from .optim import make_optimizer
from .prefetch import prefetch_device_batches
from .steps import (
    DeviceBatch,
    HiddenBatch,
    backbone_forward_fn,
    frontend_forward_fn,
    gather_features,
    gather_hidden,
    make_eval_step,
    make_feature_train_step,
    make_hidden_eval_step,
    make_hidden_train_step,
    make_train_step,
)
from .train_state import create_train_state

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainerConfig:
    num_epochs: int = 1
    batch_size: int = 8
    eval_batch_size: int = 8
    learning_rate: float | None = None      # None -> stage default (1e-5/1e-4/1e-3)
    warmup_steps: int = 1000
    weight_decay: float = 0.005
    max_grad_norm: float = 1.0
    eval_steps: int = 500
    logging_steps: int = 50
    save_steps: int = 500
    save_total_limit: int = 2
    seed: int = 0
    compute_dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = False
    dp: int = 1
    zero1: bool = False
    grad_accum: int = 1
    tp: int = 1
    pp: int = 1
    pp_microbatches: int | None = None
    sp: int = 1
    time_multiple: int = 16000
    label_multiple: int = 32
    max_samples: int | None = None           # drop utterances longer than this
    shuffle_window: int | None = None        # per-epoch membership reshuffle
    prefetch: int = 2                        # device batches staged ahead (0 = off)
    # stages 1/2: train the heads on the cached encoder output.
    # None = auto (on where the recipe freezes the backbone)
    cache_encoder: bool | None = None
    # stage 0: train on the cached output of the frozen conv frontend.
    # None = auto (on for stage 0 with a padding-invariant frontend)
    cache_frontend: bool | None = None
    cache_budget_bytes: int = 8 << 30        # fall back to full forward if over
    log_file: str | None = None
    log_dir: str = "./saves/log"
    save_dir: str | None = None
    resume_from: str | None = None  # checkpoint dir (or "auto" = latest in save_dir)


def _check_ported(t: TrainerConfig) -> None:
    later = {"dp": t.dp != 1, "tp": t.tp != 1, "pp": t.pp != 1, "sp": t.sp != 1,
             "zero1": t.zero1}
    missing = [k for k, on in later.items() if on]
    if missing:
        raise NotImplementedError(f"Trainer options not ported yet: {', '.join(missing)}")
    if t.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {t.grad_accum}")


class Trainer:
    """``state_dict``: the port's DACSModel weights (models/port.py), loaded
    into fp32 params; ``tcfg.compute_dtype`` picks the compute dtype."""

    def __init__(self, cfg: DACSConfig, state_dict: Mapping[str, torch.Tensor],
                 train_examples: Sequence[AsrExample],
                 eval_examples: Sequence[AsrExample] | None,
                 tokenizer: CTCCharTokenizer, tcfg: TrainerConfig = TrainerConfig(),
                 device: str | torch.device = "cuda"):
        _check_ported(tcfg)
        validate_stage(cfg)
        if cfg.backbone.dense_impl not in ("fp", "int8_train") \
                or tcfg.compute_dtype not in _DTYPES:
            # the inference-only "int8" impl has no gradient rule; training
            # quantization goes through "int8_train" (SwitchBack gradients,
            # ops/quant.py)
            raise ValueError(
                f"dense_impl={cfg.backbone.dense_impl!r} / compute_dtype="
                f"{tcfg.compute_dtype!r}: training requires dense_impl "
                "'fp' or 'int8_train' with compute_dtype 'float32'/'bfloat16'")
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.tokenizer = cfg, tcfg, tokenizer
        self.recipe = get_recipe(cfg.method)
        with torch.device("meta"):
            model = self.recipe.make_model(cfg, _DTYPES[tcfg.compute_dtype], torch.float32,
                                           tcfg.remat)
        model = model.to_empty(device=self.device)
        model.load_state_dict(state_dict, strict=True)
        self.logger = JsonlLogger(tcfg.log_dir, tcfg.log_file)
        self.ckpt = (CheckpointManager(tcfg.save_dir, tcfg.save_total_limit)
                     if tcfg.save_dir else None)
        self.train_batcher = LengthBucketBatcher(
            train_examples, tcfg.batch_size, time_multiple=tcfg.time_multiple,
            label_multiple=tcfg.label_multiple, seed=tcfg.seed,
            max_samples=tcfg.max_samples, shuffle_window=tcfg.shuffle_window)
        self.eval_batcher = (
            LengthBucketBatcher(eval_examples, tcfg.eval_batch_size,
                                time_multiple=tcfg.time_multiple,
                                label_multiple=tcfg.label_multiple, seed=tcfg.seed)
            if eval_examples else None)
        # the lr schedule counts OPTIMIZER updates: with grad_accum > 1 the
        # update runs once per k micro-batches
        total_steps = max(len(self.train_batcher) * tcfg.num_epochs // tcfg.grad_accum, 1)
        tx = make_optimizer(model, cfg.stage, tcfg.learning_rate, tcfg.weight_decay,
                            tcfg.max_grad_norm, tcfg.warmup_steps, total_steps,
                            trainable_pred=self.recipe.trainable(cfg.stage),
                            grad_accum=tcfg.grad_accum)
        if tcfg.grad_accum > 1:
            # micro-gradients are SUMMED: the CTC objective is a sum over
            # rows, so k micro-batches of B rows equal one batch of k x B.
            # state.step counts micro-steps: logging, eval and save cadences
            # fire per micro-batch, and a checkpoint may land mid-accumulation
            micro_total = len(self.train_batcher) * tcfg.num_epochs
            if micro_total % tcfg.grad_accum != 0:
                warnings.warn(
                    f"train length ({micro_total} micro-steps) is not a "
                    f"multiple of grad_accum={tcfg.grad_accum}: the final "
                    f"{micro_total % tcfg.grad_accum} accumulated "
                    "micro-gradients never fire an optimizer update and are "
                    "dropped at the end of train()", stacklevel=2)
        self.state = create_train_state(model, tx, tcfg.seed)
        if tcfg.resume_from:
            self._resume(tcfg.resume_from)
        self._train_step = make_train_step(cfg)
        self._eval_step = make_eval_step(cfg)
        self._eval_cache = None  # eval batches on the device (the eval set is static)

        if tcfg.cache_encoder and self.recipe.backbone_trains(cfg.stage):
            raise ValueError("cache_encoder requires a frozen backbone; "
                             f"method={cfg.method!r} stage {cfg.stage} trains the encoder")
        if (tcfg.cache_encoder or tcfg.cache_frontend) and not self.recipe.supports_cache:
            raise ValueError("frozen-forward caching is wired for the DACS model only "
                             f"(method={cfg.method!r})")
        self._cache_encoder = (
            not self.recipe.backbone_trains(cfg.stage) and self.recipe.supports_cache
            if tcfg.cache_encoder is None else tcfg.cache_encoder)
        self._hidden = None       # train-set encoder-output cache
        self._hidden_eval = None  # [(host Batch, HiddenBatch)] for evaluate()
        if self._cache_encoder:
            hstep = make_hidden_train_step(cfg)
            self._hidden_step = lambda state, h, fl, lab, ll, dem, idx: hstep(
                state, gather_hidden(h, fl, lab, ll, dem, idx))
            self._hidden_eval_step = make_hidden_eval_step(cfg)
            self._encoder_fwd = backbone_forward_fn(self.state.model)
        # the frontend cache's "same value at any batch padding" invariant
        # needs a per-frame frontend: true for "layer" feat_extract_norm,
        # false for "group" (GroupNorm over the whole padded time axis)
        frontend_cacheable = cfg.backbone.feat_extract_norm == "layer"
        if tcfg.cache_frontend and not frontend_cacheable:
            raise ValueError(
                "cache_frontend requires a padding-invariant conv frontend "
                f"(feat_extract_norm='layer'); {cfg.backbone.model_type!r} uses "
                "GroupNorm over the time axis, whose output depends on batch padding")
        self._cache_frontend = (
            cfg.stage == 0 and self.recipe.supports_cache and frontend_cacheable
            if tcfg.cache_frontend is None else tcfg.cache_frontend)
        if self._cache_encoder:
            self._cache_frontend = False  # the deeper cache subsumes it
        self._features = None  # train-set conv-frontend cache
        if self._cache_frontend:
            fstep = make_feature_train_step(cfg)

            def feature_step(state, f, fl, lab, ll, dem, idx, t_b: int):
                fb = gather_features(f, fl, lab, ll, dem, idx)
                # crop the rows to the batch's bucket length: the encoder
                # runs at the full-forward shapes
                fb.features = fb.features[:, :t_b]
                return fstep(state, fb)

            self._feature_step = feature_step

    # ---- caches of frozen forwards ----

    def _build_cache(self, fwd, width: int, tag: str, uniform_audio_pad: bool = False):
        """Per-utterance ``[n+1, T', width]`` cache of a frozen, deterministic
        forward of every train utterance, computed once (row n is scratch
        for the batch-padding rows); None when over ``cache_budget_bytes``.
        ``uniform_audio_pad`` pads every build batch's audio to the global
        max (the conv frontend: with a per-frame frontend a row then holds
        at every frame index what a full forward at any padding covering
        that frame computes); otherwise each build batch runs at its own
        bucket length."""
        bat, bcfg = self.train_batcher, self.cfg.backbone
        exs = bat.examples
        n = len(exs)
        if n == 0:
            return None
        t_pad = _round_up(max(len(e.input_values) for e in exs), bat.time_multiple)
        t_frames = feat_extract_output_lengths(bcfg, t_pad)
        dt, dev = self.state.model.dtype, self.device
        if (n + 1) * t_frames * width * dt.itemsize > self.tcfg.cache_budget_bytes:
            print(f"[{tag}] train cache ({n}x{t_frames}x{width} {dt}) over budget; "
                  "falling back to full forward per step")
            return None
        t0 = time.perf_counter()
        cache = torch.zeros((n + 1, t_frames, width), dtype=dt, device=dev)
        fl = np.zeros((n + 1,), np.int64)
        l_max = _round_up(max(len(e.labels) for e in exs), bat.label_multiple)
        labels = np.full((n + 1, l_max), -100, np.int64)
        ll = np.zeros((n + 1,), np.int64)
        dem = np.zeros((n + 1,), np.int64)
        for i, e in enumerate(exs):
            labels[i, : len(e.labels)] = e.labels
            ll[i] = len(e.labels)
            dem[i] = e.dementia_label
        for g, b in zip(bat.epoch_indices(0), bat.epoch(0)):
            iv = b.input_values
            if uniform_audio_pad:
                iv = np.pad(iv, ((0, 0), (0, t_pad - iv.shape[1])))
            h, _ = fwd(torch.from_numpy(iv).to(dev), torch.from_numpy(b.input_lengths).to(dev))
            idx = np.asarray(g)
            cache[torch.from_numpy(np.where(idx >= 0, idx, n)).to(dev), : h.shape[1]] = h
            real = idx >= 0
            fl[idx[real]] = feat_extract_output_lengths(bcfg, b.input_lengths)[real]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.logger.log({"cache": tag, "cache_s": time.perf_counter() - t0, "cache_rows": n})
        return (cache,) + tuple(torch.from_numpy(x).to(dev) for x in (fl, labels, ll, dem))

    def _build_frontend_cache(self):
        """Conv-frontend outputs of every train utterance (the stage-0 fast
        path): the frontend is frozen in every recipe and has no dropout."""
        return self._build_cache(frontend_forward_fn(self.state.model),
                                 self.cfg.backbone.conv_dim[-1], "cache_frontend",
                                 uniform_audio_pad=True)

    def _build_train_cache(self):
        """Encoder outputs of every train utterance: in stages 1/2 the
        backbone is frozen and deterministic, so this is a constant for the
        whole ``train()`` call."""
        return self._build_cache(self._encoder_fwd, self.cfg.hidden_size, "cache_encoder")

    def _build_eval_cache_hidden(self) -> list:
        """(host Batch, HiddenBatch) pairs of the static eval set: evaluation
        runs the heads only once the encoder outputs are cached."""
        out = []
        for b in self.eval_batcher.epoch(epoch_seed=0):
            db = DeviceBatch.from_host(b, self.device)
            h, fl = self._encoder_fwd(db.input_values, db.input_lengths)
            out.append((b, HiddenBatch(h, fl, db.labels, db.label_lengths,
                                       db.dementia_labels, db.sample_mask)))
        return out

    # ---- checkpoints ----

    def _state_tree(self) -> dict:
        st = self.state
        return {"step": st.step, "model": st.model.state_dict(),
                "optimizer": st.tx.state_dict(), "rng": st.rng_state()}

    def _resume(self, where: str) -> None:
        """Resume the full train state (params, AdamW moments and schedule,
        the partial gradient sum under ``grad_accum``, step, random streams)
        from a port checkpoint, or the params alone from a final export."""
        if where == "auto":
            assert self.ckpt is not None, "resume_from='auto' needs save_dir"
            step = self.ckpt.latest_step()
            if step is None:
                return
            tree = self.ckpt.restore(step)
        elif (Path(where) / STATE_FILE).exists():
            tree = torch.load(Path(where) / STATE_FILE, map_location="cpu",
                              weights_only=True)
        else:
            sd = load_state_dict(where)
            if sd is None:
                raise FileNotFoundError(f"no port checkpoint or export at {where}")
            print(f"[resume] params-only export at {where}: optimizer state, step "
                  "count and random streams start fresh")
            tree = {"model": sd}
        st = self.state
        st.model.load_state_dict(tree["model"])
        if "optimizer" in tree:
            st.tx.load_state_dict(tree["optimizer"])
            st.step = int(tree["step"])
            st.set_rng_state(tree["rng"])
        print(f"[resume] restored train state from {where} (step {st.step})")

    # ---- host loops ----

    def evaluate(self) -> dict:
        assert self.eval_batcher is not None
        if self._cache_encoder:
            if self._hidden_eval is None:
                self._hidden_eval = self._build_eval_cache_hidden()
            batches, step = self._hidden_eval, self._hidden_eval_step
        else:
            if self._eval_cache is None:  # the eval set and its batching are static
                self._eval_cache = list(prefetch_device_batches(
                    self.eval_batcher.epoch(epoch_seed=0), self.tcfg.prefetch, self.device))
            batches, step = self._eval_cache, self._eval_step
        refs, hyps, losses = [], [], []
        ad_correct = ad_total = 0
        for b, db in batches:
            loss, pred_ids, ad_pred = step(self.state.model, db)
            pred_ids, ad_pred = pred_ids.cpu().numpy(), ad_pred.cpu().numpy()
            losses.append(float(loss))
            for i in range(len(b.paths)):  # only real rows have paths
                label_ids = b.labels[i][b.labels[i] >= 0]
                refs.append(self.tokenizer.decode(label_ids, group_tokens=False))
                hyps.append(self.tokenizer.decode(pred_ids[i]))
                ad_correct += int(ad_pred[i] == b.dementia_labels[i])
                ad_total += 1
        return {"eval_loss": float(np.mean(losses)), "eval_wer": wer(refs, hyps),
                "eval_ad_acc": ad_correct / max(ad_total, 1)}

    def train_batches(self, epoch: int):
        """Yield ``(n_real_utts, (step_fn, step_args))`` per batch of the
        epoch: cached-encoder gathers in stages 1/2, cached-feature gathers
        at stage 0, device batches otherwise."""
        t = self.tcfg
        if self._cache_encoder:
            if self._hidden is None:
                self._hidden = self._build_train_cache() or False  # False: over budget
            if self._hidden:
                for g in self.train_batcher.epoch_indices(t.seed + epoch):
                    idx = np.asarray(g, np.int64)
                    yield int((idx >= 0).sum()), (
                        self._hidden_step,
                        (*self._hidden, torch.from_numpy(idx).to(self.device)))
                return
        if self._cache_frontend:
            if self._features is None:
                self._features = self._build_frontend_cache() or False
            if self._features:
                exs = self.train_batcher.examples
                for g in self.train_batcher.epoch_indices(t.seed + epoch):
                    idx = np.asarray(g, np.int64)
                    # the pos-conv stack is not padding-invariant: run each
                    # batch at its own bucket length, as the full forward does
                    t_b = feat_extract_output_lengths(
                        self.cfg.backbone,
                        _round_up(max(len(exs[i].input_values) for i in idx if i >= 0),
                                  self.train_batcher.time_multiple))
                    yield int((idx >= 0).sum()), (
                        self._feature_step,
                        (*self._features, torch.from_numpy(idx).to(self.device),
                         int(t_b)))
                return
        for b, db in prefetch_device_batches(
                self.train_batcher.epoch(epoch_seed=t.seed + epoch), t.prefetch, self.device):
            yield int(b.sample_mask.sum()), (self._train_step, (db,))

    def train(self):
        t = self.tcfg
        timer = StepTimer()
        step = self.state.step
        for epoch in range(t.num_epochs):
            for n_real, (step_fn, fn_args) in self.train_batches(epoch):
                metrics = step_fn(self.state, *fn_args)
                step += 1
                timer.update(n_real)
                if step % t.logging_steps == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    host.update({"step": step, "epoch": epoch + 1})
                    self.logger.log(host)
                if self.eval_batcher is not None and step % t.eval_steps == 0:
                    ev = self.evaluate()
                    ev["step"] = step
                    ev["epoch"] = epoch + 1
                    self.logger.log(ev)
                if self.ckpt is not None and step % t.save_steps == 0:
                    self.ckpt.save(self._state_tree(), step,
                                   metadata={"stage": self.cfg.stage})
        summary = timer.summary()
        summary["step"] = step
        self.logger.log(summary)
        if self.ckpt is not None:
            self.ckpt.save_final(self.state.model.state_dict(),
                                 metadata={"stage": self.cfg.stage})
        if t.save_dir is not None:
            record_result(self.logger.history, t.save_dir)
        return self.state
