"""Semi-/unsupervised federated pieces (the port's ``federated/multitask.py``):
the N-best multitask heads and pseudo labels (reference:
federated/src/Data2VecAudioForCTCMultitask_model.py and
ASRLocalUpdate_Multitask.py).

The reference's unsupervised clients run the stochastic (Gumbel-masked)
model N times per utterance, greedy-decode each pass into a pseudo
transcript with a confidence score, then train ``num_lms`` lm heads, head i
on transcript set i, averaging the CTC losses; ``lm_heads[0]`` is copied
back into ``lm_head`` afterwards (1-best).

Parameters are the port's state dicts (``lm_heads.{i}.*`` for the flax
``lm_heads_{i}``). The Gumbel noise of a decode pass comes from a
``torch.Generator`` seeded as the JAX package seeds its key, so the passes
differ as they do there, but not in the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.collate import LengthBucketBatcher
from ..data.dataset import AsrExample
from ..data.tokenizer import CTCCharTokenizer
from ..models.config import DACSConfig
from ..models.dacs import DACSModel, DACSOutputs
from ..models.objectives import _ad_weight, masked_time_mean
from ..ops.ctc import ctc_loss
from ..ops.decode import greedy_ids
from ..ops.grl import gradient_reversal
from ..ops.losses import am_softmax_loss, recall_family_loss
from ..train.steps import DeviceBatch

StateDict = Mapping[str, torch.Tensor]
PseudoLabels = dict[str, list[tuple[str, list[int], float]]]


def init_lm_heads_from_lm_head(params: StateDict, num_lms: int) -> dict[str, torch.Tensor]:
    """The reference's ``lm_heads_init``: every N-best head starts from the
    lm_head's weights (Multitask_model.py:272-275)."""
    out = dict(params)
    for i in range(num_lms):
        for leaf in ("weight", "bias"):
            out[f"lm_heads.{i}.{leaf}"] = params[f"lm_head.{leaf}"].clone()
    return out


def copy_first_head_to_lm_head(params: StateDict) -> dict[str, torch.Tensor]:
    """After unsupervised training lm_heads[0] (1-best) becomes lm_head
    (reference: ASRLocalUpdate_Multitask.py update_weights_adapted)."""
    out = dict(params)
    for leaf in ("weight", "bias"):
        out[f"lm_head.{leaf}"] = params[f"lm_heads.0.{leaf}"].clone()
    return out


def drop_lm_heads(params: StateDict) -> dict[str, torch.Tensor]:
    """The single-head state dict: the N-best heads are per-client scratch."""
    return {k: v for k, v in params.items() if not k.startswith("lm_heads.")}


def multitask_loss(outputs: DACSOutputs, labels_stack: torch.Tensor,
                   label_lengths_stack: torch.Tensor, dementia_labels: torch.Tensor,
                   cfg: DACSConfig, similar_fc_weight: torch.Tensor,
                   sample_mask: torch.Tensor | None = None, aux_metrics: bool = True
                   ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Stage-routed multitask objective (Multitask_model.py:439-497): CTC
    losses averaged over the N heads, head i on its own transcript set
    (``labels_stack [N, B, L]``, ``label_lengths_stack [N, B]``), AD and
    diversity terms as in the base DACS loss. ``similar_fc_weight`` is the
    AM-softmax projection ``[C, D]`` (torch layout). ``aux_metrics=False``
    computes only the terms the stage's loss consumes (the others are 0 in
    the metrics), as ``dacs_loss`` does: XLA drops them in JAX, eager
    PyTorch would run them."""
    bcfg = cfg.backbone
    n = len(outputs.extra_logits)
    assert n == labels_stack.shape[0], (n, labels_stack.shape)
    stage = cfg.stage
    if stage not in (0, 1, 2):
        raise ValueError(stage)
    zero = torch.zeros((), device=outputs.hidden_states.device)
    need_unmask = aux_metrics or stage == 0
    need_masked = aux_metrics or stage == 2

    def _ctc(logits, labels, lengths, reverse):
        lp = F.log_softmax(logits.float(), dim=-1)
        if reverse:
            lp = gradient_reversal(lp, cfg.lambda_grl)
        return ctc_loss(lp, labels, outputs.frame_lengths, lengths,
                        blank_id=bcfg.pad_token_id, reduction=bcfg.ctc_loss_reduction,
                        zero_infinity=bcfg.ctc_zero_infinity)

    total_unmask = total = total_r = zero
    for i, (lg_unmask, lg, lg_r) in enumerate(outputs.extra_logits):
        lab, ll = labels_stack[i], label_lengths_stack[i]
        if need_unmask:
            total_unmask = total_unmask + _ctc(lg_unmask, lab, ll, False)
        if need_masked:
            total = total + _ctc(lg, lab, ll, False)
            total_r = total_r + _ctc(lg_r, lab, ll, True)
    total_unmask, total, total_r = total_unmask / n, total / n, total_r / n

    pool = cfg.pool_valid_frames_only
    fm = outputs.frame_mask
    w = _ad_weight(cfg)

    def _ad(logits, reverse=False):
        mean = masked_time_mean(logits.float(), fm, pool)
        if reverse:
            mean = gradient_reversal(mean, cfg.lambda_grl)
        return recall_family_loss(mean, dementia_labels, cfg.ad_loss, w, sample_mask)

    ad_unmask = _ad(outputs.dementia_logits_unmask) if aux_metrics or stage == 1 else zero
    ad_rev = _ad(outputs.dementia_logits_lm, reverse=True) if need_masked else zero
    ad = _ad(outputs.dementia_logits_ad) if need_masked else zero

    div = zero
    if need_masked:
        h = outputs.hidden_states.float()
        lm_rows = (outputs.lm_mask.float() * h).reshape(-1, h.shape[-1])
        ad_rows = (outputs.ad_mask.float() * h).reshape(-1, h.shape[-1])
        rows = torch.cat([lm_rows, ad_rows])
        am_labels = torch.cat([
            torch.zeros(lm_rows.shape[0], dtype=torch.long, device=h.device),
            torch.ones(ad_rows.shape[0], dtype=torch.long, device=h.device)])
        row_w = None
        if pool:
            fw = fm.float().reshape(-1)
            row_w = torch.cat([fw, fw])
        div, _ = am_softmax_loss(rows, am_labels, similar_fc_weight,
                                 loss_type=cfg.am_loss_type, sample_weight=row_w)

    if stage == 0:
        final = total_unmask
    elif stage == 1:
        final = ad_unmask
    else:
        final = total + total_r + ad_rev + ad + div
    return final, {"loss": final, "ctc_unmask": total_unmask, "ctc_masked": total,
                   "ctc_reversed": total_r, "ad_unmask": ad_unmask,
                   "ad_reversed": ad_rev, "ad_masked": ad, "am_softmax": div}


def make_pseudo_forward(cfg: DACSConfig) -> Callable:
    """One stochastic decode pass: ``forward(model, batch, generator) ->
    (pred_ids [B, T], conf [B])`` with the backbone and heads deterministic
    and the Gumbel masks drawn from ``generator``; ids are the greedy argmax
    of the masked stream's logits, conf the largest softmax probability
    over the utterance's valid frames."""
    blank = cfg.backbone.pad_token_id

    @torch.no_grad()
    def forward(model: DACSModel, batch: DeviceBatch, generator: torch.Generator):
        was_training = model.training
        model.eval()
        try:
            out = model(batch.input_values, batch.input_lengths, generator=generator)
        finally:
            model.train(was_training)
        pred = greedy_ids(out.logits, out.frame_mask, blank)
        probs = F.softmax(out.logits.float(), dim=-1)
        conf = (probs * out.frame_mask[:, :, None]).amax(dim=(1, 2))
        return pred, conf

    return forward


def generate_pseudo_labels(cfg: DACSConfig, params: torch.nn.Module | StateDict,
                           examples: Sequence[AsrExample], tokenizer: CTCCharTokenizer,
                           num_lms: int, batch_size: int = 16, time_multiple: int = 16000,
                           seed: int = 0, forward_fn: Callable | None = None,
                           device: str | torch.device = "cpu") -> PseudoLabels:
    """N stochastic decode passes per utterance -> N (transcript, label ids,
    confidence) per path (reference gen_Ntranscripts / get_Embs,
    ASRLocalUpdate_Multitask.py:131-225). ``params``: a model (a
    ``DACSModel``, or what ``forward_fn`` takes), or a state dict loaded
    into a ``DACSModel`` on ``device``. Pass ``j`` of every batch draws its
    noise from a generator seeded ``seed * 1000 + j``, as the JAX package
    keys it; ``forward_fn(model, batch, generator)`` replaces the decode
    pass (:func:`make_pseudo_forward`)."""
    forward = forward_fn if forward_fn is not None else make_pseudo_forward(cfg)
    if isinstance(params, torch.nn.Module):
        model = params
        device = next(model.parameters()).device
    else:
        device = torch.device(device)
        with torch.device("meta"):
            model = DACSModel(cfg)
        model = model.to_empty(device=device)
        model.load_state_dict(params)
    batcher = LengthBucketBatcher(examples, batch_size, time_multiple=time_multiple)
    result: PseudoLabels = {e.path: [] for e in examples}
    for b in batcher.epoch(epoch_seed=0):
        db = DeviceBatch.from_host(b, device)
        for j in range(num_lms):
            gen = torch.Generator(device).manual_seed(seed * 1000 + j)
            pred, conf = forward(model, db, gen)
            pred, conf = pred.cpu().numpy(), conf.float().cpu().numpy()
            for i, path in enumerate(b.paths):
                text = tokenizer.decode(pred[i])
                result[path].append((text, tokenizer.encode(text), float(conf[i])))
    return result


def attach_pseudo_labels(examples: Sequence[AsrExample],
                         pseudo: PseudoLabels) -> list[AsrExample]:
    """Each unlabeled example with its 1-best pseudo transcript (copies);
    examples without one are left out. The N-best sets ride alongside."""
    out = []
    for e in examples:
        if e.path in pseudo and pseudo[e.path]:
            text, ids, _ = pseudo[e.path][0]
            out.append(dataclasses.replace(e, text=text,
                                           labels=np.asarray(ids, dtype=np.int32)))
    return out


def nbest_stack(paths: Sequence[str], pseudo: PseudoLabels, num_lms: int,
                batch_size: int, l_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """``(labels [N, B, l_pad] (-100 padded), lengths [N, B])`` of a batch's
    N-best pseudo transcripts; rows past ``len(paths)`` are padding."""
    stack = np.full((num_lms, batch_size, l_pad), -100, dtype=np.int32)
    lls = np.zeros((num_lms, batch_size), dtype=np.int32)
    for j, path in enumerate(paths):
        for i, (_, ids, _) in enumerate(pseudo[path][:num_lms]):
            ids = ids[:l_pad]
            stack[i, j, : len(ids)] = ids
            lls[i, j] = len(ids)
    return stack, lls


def multitask_local_update(cfg: DACSConfig, params: StateDict,
                           unsup_examples: Sequence[AsrExample],
                           tokenizer: CTCCharTokenizer, num_epochs: int = 1,
                           batch_size: int = 4, time_multiple: int = 16000,
                           label_multiple: int = 32, learning_rate: float | None = None,
                           warmup_steps: int = 100, seed: int = 0,
                           rng_seed: int | None = None,
                           device: str | torch.device = "cpu"
                           ) -> tuple[dict[str, torch.Tensor], list[float]]:
    """The reference's unsupervised N-best client update
    (ASRLocalUpdate_Multitask.update_weights_adapted :479-621), end to end:
    N pseudo transcripts per utterance, the N heads initialised from
    lm_head, multitask training (head i on transcript set i), lm_heads[0]
    copied back into lm_head. ``rng_seed`` seeds the step's random streams
    (default ``seed``; the JAX ``rng``). Returns (updated params, per-step
    losses)."""
    from ..train.optim import make_optimizer
    from ..train.steps import make_multitask_train_step
    from ..train.train_state import create_train_state

    n = cfg.num_lms
    assert n > 1, "multitask update needs num_lms > 1"
    device = torch.device(device)
    pseudo = generate_pseudo_labels(cfg.replace(num_lms=1), drop_lm_heads(params),
                                    unsup_examples, tokenizer, n, batch_size=batch_size,
                                    time_multiple=time_multiple, seed=seed, device=device)
    params = init_lm_heads_from_lm_head(params, n)
    examples = attach_pseudo_labels(list(unsup_examples), pseudo)
    if not examples:  # every 1-best transcript empty (e.g. an untrained model)
        print("[multitask] no usable pseudo transcripts; skipping update")
        return copy_first_head_to_lm_head(params), []
    with torch.device("meta"):
        model = DACSModel(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(params)
    tx = make_optimizer(model, cfg.stage, learning_rate, warmup_steps=warmup_steps,
                        total_steps=max(len(unsup_examples) // batch_size, 1) * num_epochs)
    state = create_train_state(model, tx, seed if rng_seed is None else rng_seed)
    step = make_multitask_train_step(cfg)
    batcher = LengthBucketBatcher(examples, batch_size, time_multiple=time_multiple,
                                  label_multiple=label_multiple, seed=seed)
    losses = []
    for ep in range(num_epochs):
        for b in batcher.epoch(epoch_seed=seed + ep):
            stack, lls = nbest_stack(b.paths, pseudo, n, b.labels.shape[0],
                                     b.labels.shape[1])
            metrics = step(state, DeviceBatch.from_host(b, device),
                           torch.from_numpy(stack).to(device), torch.from_numpy(lls).to(device))
            losses.append(float(metrics["loss"]))
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return copy_first_head_to_lm_head(out), losses
