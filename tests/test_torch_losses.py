"""The port's loss ops (privacy_preserve_federated_asr_tpu_torch/ops/ctc.py,
losses.py, grl.py) against the JAX package's on the same numpy inputs:
values and gradients, fp32 on both sides (tolerances: sums taken in
another order, rtol 1e-5 on values and atol 1e-6 on gradients unless
stated at the check)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu.ops import ctc as jctc
from privacy_preserve_federated_asr_tpu.ops import grl as jgrl
from privacy_preserve_federated_asr_tpu.ops import losses as jlosses
from privacy_preserve_federated_asr_tpu_torch.ops import ctc, grl, losses
from test_torch_backbone import one_torch_thread  # noqa: F401


def _ctc_inputs():
    """Rows: feasible, infeasible (5 labels in 3 frames), label length 0,
    frame length 0 (a batch-padding row: labels -100)."""
    rng = np.random.default_rng(0)
    b, t, v, l = 4, 12, 6, 5
    logits = rng.normal(0, 2, (b, t, v)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(1, v, (b, l)).astype(np.int32)
    labels[0, 1] = labels[0, 0]  # a repeat: the s-2 skip is barred there
    label_lengths = np.array([4, 5, 0, 0], np.int32)
    input_lengths = np.array([12, 3, 9, 0], np.int32)
    labels[np.arange(l)[None, :] >= label_lengths[:, None]] = -100
    weights = rng.uniform(0.5, 1.5, b).astype(np.float32)
    return log_probs.astype(np.float32), labels, input_lengths, label_lengths, weights


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("zero_infinity", [True, False])
def test_ctc_loss_values_and_grads_match_jax(reduction, zero_infinity):
    lp, labels, il, ll, w = _ctc_inputs()

    def jax_obj(x):
        out = jctc.ctc_loss(x, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
                            reduction=reduction, zero_infinity=zero_infinity)
        fin = jnp.where(jnp.isfinite(out), out, 0.0)
        return (fin * w).sum() if reduction == "none" else fin, out

    (_, ref), ref_grad = jax.jit(jax.value_and_grad(jax_obj, has_aux=True))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    out = ctc.ctc_loss(x, *(torch.from_numpy(a) for a in (labels, il, ll)),
                       reduction=reduction, zero_infinity=zero_infinity)
    fin = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    ((fin * torch.from_numpy(w)).sum() if reduction == "none" else fin).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5)
    # the port adds log-space terms with logaddexp (a few launches per
    # frame), JAX with a max-shifted exp-sum: gradients agree to ~2e-6
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), atol=5e-6)
    if reduction == "none":
        nll = out.detach().numpy()
        # the padding row: -log p(blank at t=0) in the value, no gradient
        np.testing.assert_allclose(nll[3], -lp[3, 0, 0], rtol=1e-6)
        assert not x.grad[3].any()
        assert (nll[1] == 0.0) if zero_infinity else np.isinf(nll[1])
        assert not x.grad[1].any()


def test_ctc_long_sequence_matches_jax():
    """T=249 (a 5 s utterance) with near-uniform log-probs, as a random
    model gives them: alpha and beta reach ~-1e3, where fp32 resolves ~1e-4,
    so the two libraries' exp/log move the posterior gradient by up to
    ~5e-5 of its largest value (measured); held to 2e-4 of it, the value to
    rtol 1e-6."""
    rng = np.random.default_rng(4)
    b, t, v = 2, 249, 32
    logits = rng.normal(0, 0.5, (b, t, v))
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    labels = rng.integers(1, v, (b, 30)).astype(np.int32)
    labels[1, 25:] = -100
    ll, il = np.array([30, 25], np.int32), np.array([249, 210], np.int32)
    ref, ref_grad = jax.jit(jax.value_and_grad(lambda x: jctc.ctc_loss(
        x, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll))))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    out = ctc.ctc_loss(x, *(torch.from_numpy(a) for a in (labels, il, ll)))
    out.backward()
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    assert np.abs(x.grad.numpy() - ref_grad).max() <= 2e-4 * np.abs(ref_grad).max()


KINDS = ["cel", "recall", "prec", "f1", "recall_ori", "prec_ori"]


@pytest.mark.parametrize("kind", KINDS)
def test_recall_family_matches_jax(kind):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 1.5, (6, 2)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    sw = np.array([1, 1, 1, 1, 0, 0], np.float32)
    weight = [0.3, 0.7] if kind != "cel" else None
    for mask in (None, sw):
        fn = jax.jit(jax.value_and_grad(lambda x: jlosses.recall_family_loss(
            x, jnp.asarray(labels), kind, weight,
            None if mask is None else jnp.asarray(mask))))
        ref, ref_grad = fn(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_()
        got = losses.recall_family_loss(x, torch.from_numpy(labels), kind, weight,
                                        None if mask is None else torch.from_numpy(mask))
        got.backward()
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), atol=1e-6)


@pytest.mark.parametrize("loss_type", ["cosface", "arcface", "sphereface"])
def test_am_softmax_matches_jax(loss_type):
    """Rows include an all-zero one (a padded frame): finite, zero gradient."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (10, 8)).astype(np.float32)
    x[3] = 0.0
    labels = np.array([0, 1] * 5, np.int32)
    w = rng.normal(0, 0.5, (2, 8)).astype(np.float32)  # [C, D], torch layout
    sw = np.ones(10, np.float32)
    sw[3] = 0.0

    def jax_fn(x_, w_):
        loss, wf = jlosses.am_softmax_loss(x_, jnp.asarray(labels), w_, loss_type,
                                           sample_weight=jnp.asarray(sw))
        return loss, wf

    (ref, ref_wf), (gx, gw) = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1),
                                                         has_aux=True))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got, wf = losses.am_softmax_loss(xt, torch.from_numpy(labels), wt, loss_type,
                                     sample_weight=torch.from_numpy(sw))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(wf.detach().numpy(), np.asarray(ref_wf), atol=1e-6)
    # s = 30-64 scales the logits: gradient tolerance 1e-5 absolute
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), atol=1e-5)
    assert np.isfinite(xt.grad.numpy()).all() and not xt.grad[3].any()


def test_gradient_reversal_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 3)).astype(np.float32)
    g = rng.normal(0, 1, (4, 3)).astype(np.float32)
    lam = 0.37
    ref = jax.grad(lambda v: (jgrl.gradient_reversal(v, lam) * g).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = grl.gradient_reversal(xt, lam)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), -lam * g, rtol=1e-7)
