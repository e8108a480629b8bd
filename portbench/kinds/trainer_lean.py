"""Traffic kind ``trainer_lean``: the ``trainer`` kind for a model whose
fp32 training state fills most of the card (XLS-R 2B: 2.16B trained
parameters, 8.6 GB for each of the weights, the gradient and AdamW's two
moments).

The program's side is the ``trainer`` kind's, unchanged: set-up, the
checked steps, the window, the traced sub-window and the numbers compared.
So are the reference's arithmetic and the batches and dropout it replays
(``reference/ssl_dacs.py``). Only the reference's memory differs, which in
the ``trainer`` kind holds each of those 8.6 GB several times over (the
start weights, two gradient dictionaries, the clipped gradients and a
straight-through copy of every weight per block) and runs out of the card:

* the weights as the compute dtype uses them are leaves of their own, made
  once per step (``rounded_leaves``): ``ssl_dacs.as_computed``'s values,
  and a leaf's gradient is the gradient at it, which is what the
  straight-through copy hands its fp32 weight;
* the gradients accumulate in the leaves' ``.grad``, block after block, in
  the order ``ssl_dacs.train_step_grads`` adds them;
* each clipped gradient is read (its norm, its cosine with the program's)
  as AdamW forms it, and the start weights wait on the host.
"""

from __future__ import annotations

import math
from unittest import mock

import numpy as np
import torch

from portbench.kinds import trainer
from portbench.lib import inputs
from portbench.lib.harness import Context, Outcome


def run(ctx: Context) -> Outcome:
    with mock.patch.object(trainer, "reference_steps", reference_steps):
        return trainer.run(ctx)


def rounded_leaves(w: dict, trainable: set, dtype: torch.dtype) -> dict:
    """``ssl_dacs.as_computed``'s values as new tensors (matmul and conv
    weights and biases rounded to ``dtype``, LayerNorm parameters float32);
    those named in ``trainable`` require gradients."""
    out = {}
    with torch.no_grad():
        for k, v in w.items():
            x = v.clone() if "layer_norm" in k or dtype == torch.float32 else v.to(dtype).float()
            out[k] = x.requires_grad_() if k in trainable else x
    return out


def step_grads(cfg: dict, leaves: dict, audio: np.ndarray, sample_lengths: np.ndarray,
               labels: np.ndarray, label_lengths: np.ndarray, plan, device,
               block: int) -> float:
    """``ssl_dacs.train_step_grads`` on ``rounded_leaves``: the summed loss,
    the gradients left in the trainable leaves' ``.grad``."""
    from portbench.reference import ssl_dacs as ref

    total = 0.0
    for r0 in range(0, audio.shape[0], block):
        rows = slice(r0, min(r0 + block, audio.shape[0]))
        wav = torch.from_numpy(audio[rows]).to(device)
        fl = torch.tensor([ref.conv_out_frames(cfg, n) for n in sample_lengths[rows]],
                          device=device)
        with torch.no_grad():
            feats = ref.frontend(cfg, leaves, wav)
        h = ref.encoder(cfg, leaves, feats, fl, plan, rows)
        logits = ref._linear(leaves, "lm_head", h)
        lab = torch.from_numpy(labels[rows]).long().clamp_min(0).to(device)
        ll = torch.from_numpy(label_lengths[rows]).long().to(device)
        loss = ref.ctc_sum(logits, fl, lab, ll)
        loss.backward()
        total += float(loss.detach())
    return total


def adamw_step(opt, grads: dict, seen) -> None:
    """``opt.step(grads)`` (``ssl_dacs.AdamW``) one leaf at a time, so that
    no clipped gradient outlives its leaf's update: the global-norm scale is
    taken once, as ``AdamW.step`` takes it, and each leaf then runs
    ``AdamW.step`` itself, unclipped (``max_norm`` infinite, a scale of
    exactly 1), on its scaled gradient, which ``seen(name, g)`` reads."""
    from portbench.reference import ssl_dacs as ref

    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    scale = 1.0 if norm < opt.max_norm else opt.max_norm / norm
    lr = opt.lr(opt.t)
    one = ref.AdamW.__new__(ref.AdamW)  # shares opt's tensors, allocates none
    one.lr, one.wd, one.max_norm = (lambda _: lr), opt.wd, math.inf
    for k in opt.params:
        one.params, one.m, one.v, one.t = {k: opt.params[k]}, {k: opt.m[k]}, {k: opt.v[k]}, opt.t
        seen(k, one.step({k: grads[k] * scale})[k])
    opt.t += 1


def reference_steps(ctx: Context, corpus: dict, prog_first: dict) -> tuple[list, dict,
                                                                          dict, dict]:
    """``trainer.reference_steps``, the same four results from the same
    weights, batches and dropout, in the memory laid out above."""
    from portbench.reference import ssl_dacs as ref

    cfgj, tr, dev = ctx.config, ctx.traffic, ctx.device
    ref.fp32_only()
    w = inputs.draw_weights(cfgj, ctx.seed, dev)  # the fp32 weights AdamW updates
    names = [k for k in w if ref.stage0_trainable(k)]
    start = {k: w[k].to("cpu", copy=True) for k in names}
    opt = ref.AdamW({k: w[k] for k in names},
                    lambda c: ref.lr_at(c, tr["peak_lr"], tr["warmup_updates"], tr["batches"]),
                    tr["weight_decay"], tr["max_grad_norm"])
    # the batch order, worked out again: length-sorted groups, shuffled per epoch
    waves = corpus["waves"]
    order = np.argsort([len(x) for x in waves], kind="stable")
    bs = tr["batch_size"]
    groups = [order[i:i + bs] for i in range(0, len(order), bs)]
    perm = np.random.default_rng(ctx.seed).permutation(len(groups))
    seeds = torch.Generator("cpu").manual_seed(ctx.seed + 1)
    if dev.type == "cuda":
        torch.cuda.manual_seed(ctx.seed)
    else:
        torch.manual_seed(ctx.seed)
    dtype = getattr(torch, cfgj["compute_dtype"])
    losses, first, cos = [], {}, {}
    for s in range(trainer.CHECKED_STEPS):
        idx = groups[perm[s]]
        lens = np.array([len(waves[j]) for j in idx])
        bucket = -(-int(lens.max()) // tr["time_multiple"]) * tr["time_multiple"]
        audio = ref.pad_rows([ref.normalize(waves[j]) for j in idx], bucket)
        labels = corpus["labels"][idx]
        t = ref.conv_out_frames(cfgj, bucket)
        plan = ref.DropoutPlan(cfgj, len(idx), t, seeds, dev, dtype)
        leaves = rounded_leaves(w, set(names), dtype)
        losses.append(step_grads(cfgj, leaves, audio, lens, labels,
                                 np.full(len(idx), labels.shape[1]), plan, dev,
                                 tr["reference_block"]))
        del plan
        grads = {k: leaves[k].grad if leaves[k].grad is not None
                 else torch.zeros_like(leaves[k]) for k in names}
        del leaves

        def seen(k, g, step=s):
            if step == 0:
                first[k] = float(g.norm())
                cos[k] = trainer._cosine(prog_first.get(k), g)

        adamw_step(opt, grads, seen)
        del grads
    change = {k: float((w[k] - start[k].to(dev)).norm()) for k in names}
    return losses, first, change, cos
