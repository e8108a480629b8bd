"""CTC loss with the JAX package's semantics (the port's ``ops/ctc.py``).

A log-space alpha recursion over the extended label sequence (blanks
interleaved), with the analytic backward of the JAX fast path
(``ops/ctc.py:118-235`` there): the beta recursion and the path posterior, in
a ``torch.autograd.Function``. ``-inf`` is replaced by the
``LOG_EPSILON = -1e5`` sentinel so gradients stay finite; labels arrive
padded ``[B, L]`` (padding < 0, like HF's -100).

The recursions run

  * on CUDA tensors as two hand-written kernels (``csrc/ctc.cu``):
    ``ctc_alpha_cuda`` in the forward and ``ctc_beta_cuda`` (the betas and
    the posterior) in the backward, each walking all the frames in one
    launch, with the lengths read on the device (no host sync),
  * on CPU tensors as Python loops over the frames (``_alphas``, ``_dnll``),

and nothing else: there is no fallback from one to the other. Both do the
same fp32 arithmetic in the same order.

``torch.nn.functional.ctc_loss`` is not used: the JAX loss has its own
behaviour on the batch-padding rows the trainer builds (``frame_lengths`` 0,
``label_lengths`` 0). ``alpha0`` still reads frame 0, so such a row adds
``-log p(blank at t=0)`` to the loss value, while the time mask gives it a
zero gradient. The port keeps both.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import cuda_build

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
    """Frames the CPU loops step through: up to the longest row (at least
    frame 0). Past it no row is active, so the alphas only repeat and the
    betas hold the sentinel, written without the loop; the values are those
    of the full loop."""
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


def _dnll(emit, alphas, log_z, valid_s, can_skip, final_ind, len_f):
    """The posterior gradient of each row's NLL, [T, B, S]: the betas, then
    ``-exp(alpha + beta - log_z)`` at feasible rows' frames ``t < len``."""
    neg = LOG_EPSILON
    betas = _betas(emit, valid_s, can_skip, final_ind, len_f)
    # posterior; gamma <= 0 mathematically, clamped before exp so an
    # infeasible row (log_z ~ neg) cannot overflow
    gamma = alphas + betas - log_z[None, :, None]
    dnll = -torch.exp(gamma.clamp(2.0 * neg, 0.0))
    feasible = (log_z > 0.5 * neg).float()[None, :, None]
    t_max = emit.shape[1]
    tm = (torch.arange(t_max, device=emit.device)[:, None] < len_f[None, :]).float()
    return dnll * feasible * tm[:, :, None]


MAX_STATES = 8192  # csrc/ctc.cu: 512 threads of at most 16 states each (L <= 4095)
_ALPHA_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BETA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _cuda_args(name: str, emit: torch.Tensor, *xs):
    """``emit`` [B, T, S] and the tensors of ``xs``, each given with its
    layout (``"bs"`` [B, S], ``"b"`` [B], ``"tbs"`` [T, B, S]), checked and
    made contiguous for the kernels."""
    b, t, s = emit.shape
    dims = {"b": b, "t": t, "s": s}
    tensors = [emit, *(x for x, _ in xs)]
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"{name} takes fp32 tensors")
    if b < 1 or t < 1 or s > MAX_STATES:
        raise ValueError(f"{name} takes B >= 1 rows, T >= 1 frames and at most "
                         f"{MAX_STATES} extended states (labels up to "
                         f"{MAX_STATES // 2 - 1}), got B={b}, T={t}, S={s}")
    for x, layout in xs:
        if tuple(x.shape) != tuple(dims[d] for d in layout):
            raise ValueError(f"{name}: a [{', '.join(layout.upper())}] input has shape "
                             f"{tuple(x.shape)} for emit {tuple(emit.shape)}")
    if not emit.is_cuda or any(x.device != emit.device for x in tensors):
        raise ValueError(f"{name} needs all its tensors on one CUDA device")
    return [x.contiguous() for x in tensors]


def ctc_alpha_cuda(emit, valid_s, can_skip, len_f):
    """Launch ``csrc/ctc.cu``'s alpha kernel: the alphas [T, B, S] of
    ``_alphas``, one CTA per row walking all T frames. Counts each launch in
    ``ctc_alpha_cuda.launches``."""
    emit, valid_s, can_skip, len_f = _cuda_args(
        "ctc_alpha_cuda", emit, (valid_s, "bs"), (can_skip, "bs"), (len_f, "b"))
    b, t_max, s_max = emit.shape
    alphas = torch.empty((t_max, b, s_max), device=emit.device)
    rc = cuda_build.symbol("ctc", "ctc_alpha", _ALPHA_ARGTYPES)(
        emit.data_ptr(), valid_s.data_ptr(), can_skip.data_ptr(), len_f.data_ptr(),
        alphas.data_ptr(), b, t_max, s_max,
        torch.cuda.current_stream(emit.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ctc_alpha kernel launch failed: CUDA error {rc}")
    ctc_alpha_cuda.launches += 1
    return alphas


ctc_alpha_cuda.launches = 0


def ctc_beta_cuda(emit, alphas, log_z, valid_s, can_skip, final_ind, len_f):
    """Launch ``csrc/ctc.cu``'s beta kernel: ``_dnll``'s posterior gradient
    [T, B, S], the betas kept in the CTA and never stored. Reads the stream
    at call time (the backward runs on autograd's device thread). Counts each
    launch in ``ctc_beta_cuda.launches``."""
    emit, alphas, log_z, valid_s, can_skip, final_ind, len_f = _cuda_args(
        "ctc_beta_cuda", emit, (alphas, "tbs"), (log_z, "b"), (valid_s, "bs"),
        (can_skip, "bs"), (final_ind, "bs"), (len_f, "b"))
    b, t_max, s_max = emit.shape
    dnll = torch.empty((t_max, b, s_max), device=emit.device)
    rc = cuda_build.symbol("ctc", "ctc_beta", _BETA_ARGTYPES)(
        emit.data_ptr(), alphas.data_ptr(), log_z.data_ptr(), valid_s.data_ptr(),
        can_skip.data_ptr(), final_ind.data_ptr(), len_f.data_ptr(), dnll.data_ptr(),
        b, t_max, s_max, torch.cuda.current_stream(emit.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ctc_beta kernel launch failed: CUDA error {rc}")
    ctc_beta_cuda.launches += 1
    return dnll


ctc_beta_cuda.launches = 0


def _log_z(alphas, final_ind):
    """Each row's log-likelihood: the logsumexp of the last frame's alphas
    over its final states."""
    neg = LOG_EPSILON
    masked_final = torch.where(final_ind > 0, alphas[-1], torch.full_like(alphas[-1], neg))
    m = masked_final.amax(1).clamp_min(neg)
    return m + torch.log((torch.exp(masked_final - m[:, None]) * final_ind).sum(1))


class _CTCNLL(torch.autograd.Function):
    """Per-sample CTC negative log-likelihood with the posterior gradient:
    the kernels on CUDA tensors, the loops on CPU tensors."""

    @staticmethod
    def forward(ctx, log_probs, onehot, valid_s, can_skip, final_ind, len_f):
        lp = log_probs.float()
        emit = torch.einsum("btv,bsv->bts", lp, onehot)
        alphas = (ctc_alpha_cuda if emit.is_cuda else _alphas)(emit, valid_s, can_skip,
                                                               len_f)
        log_z = _log_z(alphas, final_ind)
        ctx.save_for_backward(emit, alphas, log_z, onehot, valid_s, can_skip,
                              final_ind, len_f)
        return -log_z

    @staticmethod
    def backward(ctx, g):
        with span("dacs.ctc.backward"):
            emit, alphas, log_z, onehot, valid_s, can_skip, final_ind, len_f = \
                ctx.saved_tensors
            dnll = (ctc_beta_cuda if emit.is_cuda else _dnll)(
                emit, alphas, log_z, valid_s, can_skip, final_ind, len_f)
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
