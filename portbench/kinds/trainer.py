"""Traffic kind ``trainer``: stage-0 training through the port's
``Trainer.train_batches`` and its cached-frontend feature step.

Set-up builds one ``Trainer`` (model, AdamW state, the frontend cache of
a seeded corpus) and drives its first steps; the window then runs the same
object on, batch after batch, epoch after epoch. The first three steps are
what ``correct`` judges: each step's loss, the first gradient as AdamW
received it (its first moment after one step, over 1 - beta1: each leaf's
norm and direction) and the parameters' change after three steps, against
the plain reference run from the same weights, batches and dropout. The
cell's limits file names the numbers compared; the others are printed.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench.lib import inputs
from portbench.lib.counting import attention_call, train_step_flops
from portbench.lib.harness import Check, Context, Outcome, free_memory, log
from portbench.lib.program import dacs_config
from portbench.lib.trace import traced
from portbench.reference.ssl_dacs import conv_out_frames

CHECKED_STEPS = 3


def _steps(trainer, seed: int):
    """(n_real, step_fn, args, row indices) of every step, epoch after
    epoch, as ``Trainer.train`` drives them."""
    epoch = 0
    while True:
        groups = trainer.train_batcher.epoch_indices(seed + epoch)
        for (n_real, (fn, args)), g in zip(trainer.train_batches(epoch), groups):
            yield n_real, fn, args, g
        epoch += 1


def run(ctx: Context) -> Outcome:
    from privacy_preserve_federated_asr_tpu_torch.data.audio import normalize_input_values
    from privacy_preserve_federated_asr_tpu_torch.data.dataset import AsrExample
    from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from privacy_preserve_federated_asr_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfgj, tr, dev = ctx.config, ctx.traffic, ctx.device
    corpus = inputs.train_corpus(tr, ctx.seed)
    examples = [AsrExample(path=f"utt{i:05d}", array=w, text=None,
                           dementia_label=int(corpus["dementia"][i]),
                           input_values=normalize_input_values(w), labels=corpus["labels"][i])
                for i, w in enumerate(corpus["waves"])]
    cfg = dacs_config(cfgj, stage=0, dense_impl="int8_train" if ctx.control else "fp")
    tcfg = TrainerConfig(batch_size=tr["batch_size"], compute_dtype=cfgj["compute_dtype"],
                         seed=ctx.seed, time_multiple=tr["time_multiple"],
                         label_multiple=tr["label_multiple"], logging_steps=1 << 30,
                         eval_steps=1 << 30, save_steps=1 << 30, prefetch=0)
    weights = inputs.draw_weights(cfgj, ctx.seed, dev)
    trainer = Trainer(cfg, weights, examples, None, CTCCharTokenizer(), tcfg, device=dev)
    del weights
    frames_of = [conv_out_frames(cfgj, len(e.input_values))
                 for e in trainer.train_batcher.examples]
    tx = trainer.state.tx
    named = dict(zip(tx.names, tx.params))
    start = {k: p.detach().clone() for k, p in named.items()}
    steps = _steps(trainer, ctx.seed)

    # set-up: the checked steps, then warm-up steps, all through the window's call
    losses, first_grad, change = [], {}, {}
    for i in range(CHECKED_STEPS + tr["warmup_steps"]):
        _, fn, args, _ = next(steps)
        metrics = fn(trainer.state, *args)
        if i < CHECKED_STEPS:
            losses.append(float(metrics["loss"]))
        if i == 0:
            first_grad = {k: _first_gradient(tx.adamw.state.get(p, {}))
                          for k, p in named.items()}
        if i == CHECKED_STEPS - 1:
            change = {k: float((p.detach() - start[k]).norm()) for k, p in named.items()}
            del start
    _sync(dev)

    t0 = time.perf_counter()
    n_steps = utts = 0
    flops = 0.0
    while True:
        n_real, fn, args, g = next(steps)
        fn(trainer.state, *args)
        n_steps += 1
        utts += n_real
        flops += train_step_flops(cfgj, [frames_of[j] for j in g if j >= 0])
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    _sync(dev)
    window = time.perf_counter() - t0
    log(f"window: {n_steps} steps, {utts} utterances in {window:.3f} s")

    obs = {"window_s": window, "flops": flops}
    trace = None
    if ctx.trace:
        heads, hd = cfgj["num_attention_heads"], cfgj["hidden_size"] // cfgj["num_attention_heads"]
        layers = cfgj["num_hidden_layers"]
        fwd0, bwd0 = flash_attention_fwd.launches, flash_attention_bwd.launches
        b1 = b2 = None
        box: dict = {}
        with traced(box, ctx.device):
            for _ in range(tr["trace_steps"]):
                _, fn, args, g = next(steps)
                rows = [frames_of[j] for j in g if j >= 0]
                with torch.profiler.record_function("portbench.train_step"):
                    fn(trainer.state, *args)
                w1 = attention_call(rows, None, heads, hd)
                w2 = attention_call(rows, None, heads, hd, backward=True)
                b1 = w1 if b1 is None else b1.add(w1)
                b2 = w2 if b2 is None else b2.add(w2)
        trace = box["trace"]
        calls = tr["trace_steps"] * layers
        obs.update(trace=trace, trace_steps=tr["trace_steps"],
                   b1_least_s=b1.least_s * layers, b2_least_s=b2.least_s * layers,
                   b1_calls=flash_attention_fwd.launches - fwd0,
                   b2_calls=flash_attention_bwd.launches - bwd0, calls_expected=calls)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del trainer, steps, named, tx
    free_memory()
    checks, obs["diag"] = compare(ctx, corpus, losses, first_grad, change)
    return Outcome(e2e={"train_utt_per_s": utts / window}, attempted=utts, failed=0,
                   t_window=t0, memory_peak=peak, checks=checks, obs=obs, trace=trace)


def _first_gradient(state: dict) -> torch.Tensor | None:
    """The gradient AdamW received at its first step, from its first moment
    (over 1 - beta1), held on the host; None where the step left no state."""
    m = state.get("exp_avg")
    return None if m is None else m.detach().float().div(1 - 0.9).cpu()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_steps(ctx: Context, corpus: dict, prog_first: dict) -> tuple[list, dict,
                                                                          dict, dict]:
    """The reference's losses, first clipped gradients (per-leaf norms),
    per-leaf parameter changes over the first three steps, and the cosine
    of each leaf's first gradient with the program's (``prog_first``)."""
    from portbench.reference import ssl_dacs as ref

    cfgj, tr, dev = ctx.config, ctx.traffic, ctx.device
    ref.fp32_only()
    w = {k: t.clone() for k, t in inputs.draw_weights(cfgj, ctx.seed, dev).items()}
    trainable = {k: t.requires_grad_() for k, t in w.items() if ref.stage0_trainable(k)}
    start = {k: t.detach().clone() for k, t in trainable.items()}
    opt = ref.AdamW(trainable, lambda c: ref.lr_at(c, tr["peak_lr"], tr["warmup_updates"],
                                                   tr["batches"]),
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
    losses, first, change, cos = [], {}, {}, {}
    for s in range(CHECKED_STEPS):
        idx = groups[perm[s]]
        lens = np.array([len(waves[j]) for j in idx])
        bucket = -(-int(lens.max()) // tr["time_multiple"]) * tr["time_multiple"]
        audio = ref.pad_rows([ref.normalize(waves[j]) for j in idx], bucket)
        labels = corpus["labels"][idx]
        t = ref.conv_out_frames(cfgj, bucket)
        plan = ref.DropoutPlan(cfgj, len(idx), t, seeds, dev, dtype)
        loss, grads = ref.train_step_grads(
            cfgj, w, trainable, audio, lens, labels,
            np.full(len(idx), labels.shape[1]), plan, dev, tr["reference_block"], dtype)
        del plan
        clipped = opt.step(grads)
        losses.append(loss)
        if s == 0:
            first = {k: float(g.norm()) for k, g in clipped.items()}
            cos = {k: _cosine(prog_first.get(k), g) for k, g in clipped.items()}
    change = {k: float((p.detach() - start[k]).norm()) for k, p in trainable.items()}
    return losses, first, change, cos


def _cosine(a: torch.Tensor | None, b: torch.Tensor) -> float:
    """cos(a, b) of two leaves in float64; 0 where either is missing or 0."""
    if a is None:
        return 0.0
    a, b = a.to(b.device, torch.float64).flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else 0.0


def leaf_gaps(prog: dict, ref: dict, keys) -> dict[str, float]:
    """Each leaf's |norm gap| over max(its reference norm, the median leaf's
    reference norm)."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def compare(ctx: Context, corpus: dict, losses, first_grad,
            change) -> tuple[list[Check], dict]:
    """Every number of the three checked steps; the limits file names those
    compared, and the rest come back as ``diag``, printed only."""
    t0 = time.perf_counter()
    r_losses, r_first, r_change, cos = reference_steps(ctx, corpus, first_grad)
    log(f"reference: three steps in {time.perf_counter() - t0:.1f} s; losses program "
        f"{losses} reference {r_losses}")
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
    norms = {k: 0.0 if g is None else float(g.norm()) for k, g in first_grad.items()}
    grads = leaf_gaps(norms, r_first, list(r_first))
    med = statistics.median(r_first.values())
    moved = [k for k in r_change if r_first[k] >= 1e-3 * med]
    skipped = sorted(set(r_change) - set(moved))
    changes = leaf_gaps(change, r_change, moved)
    turns = {k: 1.0 - cos[k] for k in moved}
    grad_at, change_at = max(grads, key=grads.get), max(changes, key=changes.get)
    turn_at = max(turns, key=turns.get)
    log(f"worst first-gradient leaf {grad_at}; worst change leaf {change_at}; worst "
        f"first-gradient direction {turn_at}; {len(skipped)} leaves left out of the change "
        f"and the direction (reference gradient < 1e-3 x median), e.g. {skipped[:2]}")
    numbers = {"loss_rel_gap": max(step_gaps), "first_grad_leaf_gap": grads[grad_at],
               "change_leaf_gap": changes[change_at], "first_grad_cos_gap": turns[turn_at],
               "loss_step1_gap": step_gaps[0],
               "grad_leaf_median": statistics.median(grads.values()),
               "change_leaf_median": statistics.median(changes.values()),
               "grad_cos_gap_median": statistics.median(turns.values())}
    checks = [Check(k, numbers[k], v) for k, v in ctx.limits.items()]
    diag = {k: v for k, v in numbers.items() if k not in ctx.limits}
    log("diag " + " ".join(f"{k} {v:.4g}" for k, v in diag.items()))
    return checks, diag
