"""The port's loss ops (privacy_preserve_federated_asr_tpu_torch/ops/ctc.py,
losses.py, grl.py) against the JAX package's on the same numpy inputs:
values and gradients, fp32 on both sides (tolerances: sums taken in
another order, rtol 1e-5 on values and atol 1e-6 on gradients unless
stated at the check), and the CTC kernels (csrc/ctc.cu) against the CPU
loops where a card is present. JAX is imported inside the tests that use it,
so the card-only tests also run where JAX is not installed:
``python -m pytest tests/test_torch_losses.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu_torch.ops import ctc, grl, losses
from test_torch_attention import one_torch_thread  # noqa: F401


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
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops import ctc as jctc

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
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops import ctc as jctc

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


def _cell_inputs():
    """The benchmark cell's CTC shape: B=64, T=249, V=32, 48 labels padded
    to 64, frame lengths 175-249 and a batch-padding row (lengths 0)."""
    rng = np.random.default_rng(5)
    b, t, v, l = 64, 249, 32, 64
    logits = rng.normal(0, 0.5, (b, t, v))
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    labels = rng.integers(1, v, (b, l)).astype(np.int32)
    input_lengths = rng.integers(175, 250, b).astype(np.int32)
    label_lengths = np.full(b, 48, np.int32)
    input_lengths[-1] = label_lengths[-1] = 0
    labels[np.arange(l)[None, :] >= label_lengths[:, None]] = -100
    return lp, labels, input_lengths, label_lengths, rng.uniform(0.5, 1.5, b).astype(np.float32)


def _wide_inputs():
    """S = 601 extended states (L=300), more than one CTA's threads, over
    T=749 frames, with a batch-padding row."""
    rng = np.random.default_rng(6)
    b, t, v, l = 4, 749, 32, 300
    logits = rng.normal(0, 0.5, (b, t, v))
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    labels = rng.integers(1, v, (b, l)).astype(np.int32)
    input_lengths = np.array([749, 700, 640, 0], np.int32)
    label_lengths = np.array([300, 280, 241, 0], np.int32)
    labels[np.arange(l)[None, :] >= label_lengths[:, None]] = -100
    return lp, labels, input_lengths, label_lengths, rng.uniform(0.5, 1.5, b).astype(np.float32)


def _widest_inputs(l):
    """L labels, so S = 2L+1 extended states: L = 700, 1500 and 3000 give
    the kernels' 4, 8 and 16 states per thread. Rows: all L labels over
    enough frames (feasible), half of them over half the frames, all L over
    a third of the frames (infeasible), a batch-padding row."""
    rng = np.random.default_rng(l)
    t, v = l + l // 16 + 8, 32
    logits = rng.normal(0, 0.5, (4, t, v))
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    labels = rng.integers(1, v, (4, l)).astype(np.int32)
    input_lengths = np.array([t, t // 2, t // 3, 0], np.int32)
    label_lengths = np.array([l, l // 2, l, 0], np.int32)
    labels[np.arange(l)[None, :] >= label_lengths[:, None]] = -100
    return lp, labels, input_lengths, label_lengths, rng.uniform(0.5, 1.5, 4).astype(np.float32)


def _ctc_run(inputs, device):
    """Per-row NLL, the gradient of their weighted sum, and the kernels'
    launch counts after the forward and after the backward."""
    lp, labels, il, ll, w = inputs
    x = torch.from_numpy(lp).to(device).requires_grad_()
    nll = ctc.ctc_loss(x, *(torch.from_numpy(a).to(device) for a in (labels, il, ll)),
                       reduction="none")
    counts = (ctc.ctc_alpha_cuda.launches, ctc.ctc_beta_cuda.launches)
    (nll * torch.from_numpy(w).to(device)).sum().backward()
    counts += (ctc.ctc_alpha_cuda.launches, ctc.ctc_beta_cuda.launches)
    return nll.detach().cpu(), x.grad.cpu(), counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ctc_inputs", "cell", "wide"])
def test_ctc_kernels_match_cpu_loops(case):
    """The kernel path on the card against the CPU loops on the same inputs.
    Values to rtol 1e-5. Gradients to atol 1e-6 plus 8 fp32 ulps of the
    row's NLL, relative: both sides do the same fp32 arithmetic, but their
    exp and log1p may round differently by an ulp, and where the sum
    ``max + log1p(exp(-d))`` is near a rounding boundary of the max, the
    alpha or beta moves by one ulp of its magnitude (~|NLL|), the posterior
    by that share of itself. Measured on an H100 against its host's CPU: up
    to 2.4 such ulps at the cell's shape, 1.2 on the wide set, 0.2 on
    ``_ctc_inputs()`` (1.2e-6 absolute there, the largest gradient 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/ctc.cu)")
    inputs = {"ctc_inputs": _ctc_inputs, "cell": _cell_inputs, "wide": _wide_inputs}[case]()
    a0, b0 = ctc.ctc_alpha_cuda.launches, ctc.ctc_beta_cuda.launches
    nll, grad, counts = _ctc_run(inputs, "cuda")
    assert counts == (a0 + 1, b0, a0 + 1, b0 + 1)  # one launch per forward, per backward
    nll2, grad2, _ = _ctc_run(inputs, "cuda")
    for x, y in ((nll, nll2), (grad, grad2)):  # no atomics: the same bits
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    ref_nll, ref_grad, counts = _ctc_run(inputs, "cpu")
    assert counts == (a0 + 2, b0 + 2) * 2  # the CPU path launches nothing
    np.testing.assert_allclose(nll.numpy(), ref_nll.numpy(), rtol=1e-5)
    ulps = 8 * np.finfo(np.float32).eps * np.abs(ref_nll.numpy())[:, None, None]
    excess = np.abs(grad.numpy() - ref_grad.numpy()) - ulps * np.abs(ref_grad.numpy())
    assert excess.max() <= 1e-6, excess.max()
    # the padding row: -log p(blank at t=0) in the value, no gradient
    lp = inputs[0]
    np.testing.assert_allclose(nll[-1].item(), -lp[-1, 0, 0], rtol=1e-6)
    assert not grad[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ctc_inputs", "cell", "wide", "l700", "l1500", "l3000"])
def test_ctc_kernels_equal_the_loops_on_the_card(case):
    """Each kernel against its CPU loop (``_alphas``, ``_dnll``) run on the
    card's tensors: the same bits, since both do the same fp32 operations in
    the same order with the card's exp and log1p. The cases reach every
    instantiation of the kernels: 1, 2, 4, 8 and 16 states per thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/ctc.cu)")
    make = {"ctc_inputs": _ctc_inputs, "cell": _cell_inputs, "wide": _wide_inputs}.get(
        case, lambda: _widest_inputs(int(case[1:])))
    lp, labels, il, ll, _ = make()
    labels, il, ll = (torch.from_numpy(a).cuda() for a in (labels, il, ll))
    onehot, valid_s, can_skip, final_ind = ctc._ctc_structure(labels, ll, 0, lp.shape[-1])
    emit = torch.einsum("btv,bsv->bts", torch.from_numpy(lp).cuda(), onehot)
    len_f = il.float()
    alphas = ctc.ctc_alpha_cuda(emit, valid_s, can_skip, len_f)
    log_z = ctc._log_z(alphas, final_ind)
    rows = (valid_s, can_skip, final_ind, len_f)
    for got, ref in ((alphas, ctc._alphas(emit, valid_s, can_skip, len_f)),
                     (ctc.ctc_beta_cuda(emit, alphas, log_z, *rows),
                      ctc._dnll(emit, alphas, log_z, *rows))):
        assert torch.equal(got.view(torch.int32), ref.contiguous().view(torch.int32))


def test_ctc_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernel wrappers raise before any build or launch: on CPU tensors,
    on another dtype, on a shape that does not fit emit's, on more extended
    states than a CTA takes."""
    emit, rows, lens = torch.zeros(2, 5, 7), torch.ones(2, 7), torch.full((2,), 5.0)
    with pytest.raises(ValueError, match="CUDA"):
        ctc.ctc_alpha_cuda(emit, rows, rows, lens)
    with pytest.raises(ValueError, match="CUDA"):
        ctc.ctc_beta_cuda(emit, emit.transpose(0, 1), lens, rows, rows, rows, lens)
    with pytest.raises(TypeError, match="fp32"):
        ctc.ctc_alpha_cuda(emit.double(), rows, rows, lens)
    with pytest.raises(ValueError, match="shape"):
        ctc.ctc_beta_cuda(emit, emit, lens, rows, rows, rows, lens)  # alphas [B, T, S]
    wide = torch.zeros(2, 5, ctc.MAX_STATES + 1)
    with pytest.raises(ValueError, match="extended states"):
        ctc.ctc_alpha_cuda(wide, wide[:, 0], wide[:, 0], lens)


KINDS = ["cel", "recall", "prec", "f1", "recall_ori", "prec_ori"]


@pytest.mark.parametrize("kind", KINDS)
def test_recall_family_matches_jax(kind):
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops import losses as jlosses

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
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops import losses as jlosses

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
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops import grl as jgrl

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
