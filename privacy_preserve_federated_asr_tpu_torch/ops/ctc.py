"""CTC loss with the JAX package's semantics (the port's ``ops/ctc.py``).

A log-space alpha recursion over the extended label sequence (blanks
interleaved), looped over time in Python, with the analytic backward of the
JAX fast path (``ops/ctc.py:118-235`` there): the beta recursion and the path
posterior, in a ``torch.autograd.Function``. ``-inf`` is replaced by the
``LOG_EPSILON = -1e5`` sentinel so gradients stay finite; labels arrive
padded ``[B, L]`` (padding < 0, like HF's -100).

``torch.nn.functional.ctc_loss`` is not used: the JAX loss has its own
behaviour on the batch-padding rows the trainer builds (``frame_lengths`` 0,
``label_lengths`` 0). ``alpha0`` still reads frame 0, so such a row adds
``-log p(blank at t=0)`` to the loss value, while the time mask gives it a
zero gradient. The port keeps both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span

LOG_EPSILON = -1e5


def _ctc_structure(labels: torch.Tensor, label_lengths: torch.Tensor,
                   blank_id: int, vocab_size: int):
    """Float tensors of the discrete structure: the extended labels one-hot
    ``[B, S, V]``, valid states, allowed s-2 skips and final states
    ``[B, S]``."""
    labels = torch.where(labels < 0, torch.zeros_like(labels), labels).long()
    b, l = labels.shape
    ext = torch.full((b, 2 * l + 1), blank_id, dtype=torch.long, device=labels.device)
    ext[:, 1::2] = labels
    s_max = ext.shape[1]
    s_idx = torch.arange(s_max, device=labels.device)[None, :]
    ll = label_lengths.long()[:, None]
    valid_s = s_idx < 2 * ll + 1
    ext_shift2 = F.pad(ext, (2, 0), value=blank_id)[:, :s_max]
    can_skip = (ext != blank_id) & (ext != ext_shift2)
    onehot = F.one_hot(ext, vocab_size).float()
    last = 2 * ll
    final_ind = (s_idx == last) | ((s_idx == last - 1) & (ll > 0))
    return onehot, valid_s.float(), can_skip.float(), final_ind.float()


def _frames_run(len_f: torch.Tensor, t_max: int) -> int:
    """Frames the recursions step through. On the CPU they stop after the
    longest row (at least frame 0): past it no row is active, so the alphas
    only repeat and the betas hold the sentinel, written without the loop;
    the values are those of the full loop. On the card the loop runs all
    ``t_max`` frames, so that reading the lengths costs no device sync."""
    if len_f.device.type != "cpu":
        return t_max
    return min(max(int(len_f.max()), 1), t_max) if len_f.numel() else t_max


def _alphas(emit, valid_s, can_skip, len_f):
    """Forward recursion -> alphas [T, B, S]. Every value is floored at the
    sentinel, so ``logaddexp`` gives the JAX step's max-shifted logsumexp;
    the recursion writes into one buffer whose two leading columns hold the
    sentinel (the s-1 and s-2 predecessors of states 0 and 1): a few
    launches per frame."""
    b, t_max, s_max = emit.shape
    neg = LOG_EPSILON
    emit_inv = (emit + ((1.0 - valid_s) * neg)[:, None, :]).transpose(0, 1)  # [T, B, S]
    skip_pen = (1.0 - can_skip) * neg
    buf = torch.full((t_max, b, s_max + 2), neg, device=emit.device)
    s_iota = torch.arange(s_max, device=emit.device)[None, :]
    a0 = torch.where(s_iota < 2, emit_inv[0], torch.full_like(emit_inv[0], neg))
    buf[0, :, 2:] = a0.clamp_min(neg)
    active = (torch.arange(t_max, device=emit.device)[:, None] < len_f[None, :])[:, :, None]
    t_run = _frames_run(len_f, t_max)
    for t in range(1, t_run):
        prev = buf[t - 1]
        alpha, prev1 = prev[:, 2:], prev[:, 1:-1]
        prev2 = (prev[:, :-2] + skip_pen).clamp_min_(neg)
        new = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = new.add_(emit_inv[t]).clamp_min_(neg)
        torch.where(active[t], new, alpha, out=buf[t, :, 2:])
    buf[t_run:] = buf[t_run - 1]  # no row is active there: each frame copies the last
    return buf[:, :, 2:]


def _betas(emit, valid_s, can_skip, final_ind, len_f):
    """Backward recursion -> betas [T, B, S] (beta_t excludes emit at t);
    the contribution ``c`` goes into a buffer whose two trailing columns hold
    the sentinel (the s+1 and s+2 successors of the last states)."""
    b, t_max, s_max = emit.shape
    neg = LOG_EPSILON
    invalid = (1.0 - valid_s) * neg
    # a move s -> s+2 is allowed iff can_skip[s+2]
    skip_fwd = F.pad((1.0 - can_skip) * neg, (0, 2), value=neg)[:, 2:]
    init_row = torch.where(final_ind > 0, 0.0, neg)
    emit_t = emit.transpose(0, 1)  # [T, B, S]
    steps = torch.arange(t_max, device=emit.device)[:, None]
    is_last = (steps == (len_f - 1).long()[None, :])[:, :, None]  # [T, B, 1]
    beyond = (steps >= len_f[None, :])[:, :, None]
    betas = torch.empty((t_max, b, s_max), device=emit.device)
    c = torch.full((b, s_max + 2), neg, device=emit.device)
    beta = neg_row = torch.full((b, s_max), neg, device=emit.device)
    t_run = _frames_run(len_f, t_max)
    betas[t_run:] = neg_row  # beyond every row's length
    for t in range(t_run - 1, -1, -1):
        torch.add(emit_t[min(t + 1, t_max - 1)], beta, out=c[:, :s_max]).clamp_min_(neg)
        nxt2 = (c[:, 2:] + skip_fwd).clamp_min_(neg)
        new = torch.logaddexp(torch.logaddexp(c[:, :s_max], c[:, 1:-1]), nxt2)
        new = new.add_(invalid).clamp_min_(neg)
        new = torch.where(is_last[t], init_row, new)
        beta = torch.where(beyond[t], neg_row, new, out=betas[t])
    return betas


class _CTCNLL(torch.autograd.Function):
    """Per-sample CTC negative log-likelihood with the posterior gradient."""

    @staticmethod
    def forward(ctx, log_probs, onehot, valid_s, can_skip, final_ind, len_f):
        lp = log_probs.float()
        emit = torch.einsum("btv,bsv->bts", lp, onehot)
        alphas = _alphas(emit, valid_s, can_skip, len_f)
        neg = LOG_EPSILON
        masked_final = torch.where(final_ind > 0, alphas[-1], torch.full_like(alphas[-1], neg))
        m = masked_final.amax(1).clamp_min(neg)
        log_z = m + torch.log((torch.exp(masked_final - m[:, None]) * final_ind).sum(1))
        ctx.save_for_backward(emit, alphas, log_z, onehot, valid_s, can_skip,
                              final_ind, len_f)
        return -log_z

    @staticmethod
    def backward(ctx, g):
        with span("dacs.ctc.backward"):
            emit, alphas, log_z, onehot, valid_s, can_skip, final_ind, len_f = \
                ctx.saved_tensors
            neg = LOG_EPSILON
            betas = _betas(emit, valid_s, can_skip, final_ind, len_f)
            # posterior; gamma <= 0 mathematically, clamped before exp so an
            # infeasible row (log_z ~ neg) cannot overflow
            gamma = alphas + betas - log_z[None, :, None]
            dnll = -torch.exp(gamma.clamp(2.0 * neg, 0.0))
            feasible = (log_z > 0.5 * neg).float()[None, :, None]
            t_max = emit.shape[1]
            tm = (torch.arange(t_max, device=emit.device)[:, None] < len_f[None, :]).float()
            dnll = dnll * feasible * tm[:, :, None]
            dlp = torch.einsum("tbs,bsv->btv", dnll, onehot) * g[:, None, None]
            return dlp, None, None, None, None, None


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0, reduction: str = "sum",
             zero_infinity: bool = True) -> torch.Tensor:
    """CTC loss of ``[B, T, V]`` log-softmax outputs against ``[B, L]``
    padded labels. ``reduction='mean'`` divides each sample's loss by its
    label length (clamped to 1) before averaging, like torch;
    ``zero_infinity`` zeros the loss of impossible alignments (target longer
    than the input), otherwise they are ``inf``."""
    with span("dacs.ctc.forward"):
        structure = _ctc_structure(labels, label_lengths, blank_id, log_probs.shape[-1])
        nll = _CTCNLL.apply(log_probs, *structure, input_lengths.float())
        infeasible = nll > 0.5 * -LOG_EPSILON  # impossible alignments sit at ~|LOG_EPSILON|
        fill = 0.0 if zero_infinity else float("inf")
        nll = torch.where(infeasible, torch.full_like(nll, fill), nll)
        if reduction == "none":
            return nll
        if reduction == "sum":
            return nll.sum()
        if reduction == "mean":
            return (nll / label_lengths.clamp_min(1).to(nll.dtype)).mean()
        raise ValueError(f"unknown reduction: {reduction!r}")
