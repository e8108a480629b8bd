"""The wide positional convolution (privacy_preserve_federated_asr_tpu_torch/
ops/pos_conv.py): on the CPU, the wrapper's plain version against the
module's former composition (``Conv1d`` -> crop -> GELU) bit for bit, the
``single`` module against the JAX package's conv, and the wrapper's checks;
on the card (``cuda`` marker), the kernels of ``csrc/pos_conv.cu`` against
the plain version in fp32, and their launches in one train step. JAX is
imported inside the test that uses it, so the card-only tests also run where
JAX is not installed:
``python -m pytest tests/test_torch_pos_conv.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from privacy_preserve_federated_asr_tpu_torch.data import (
    AsrExample,
    CTCCharTokenizer,
    prepare_examples,
)
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    init_dacs_state_dict,
)
from privacy_preserve_federated_asr_tpu_torch.models.backbone import (
    Conv1d,
    PositionalConvEmbedding,
)
from privacy_preserve_federated_asr_tpu_torch.ops import pos_conv
from privacy_preserve_federated_asr_tpu_torch.train import Trainer, TrainerConfig
from test_torch_attention import one_torch_thread  # noqa: F401

COUNTERS = (pos_conv.pos_conv_fwd_cuda, pos_conv.pos_conv_dgrad_cuda,
            pos_conv.pos_conv_wgrad_cuda)


def _launches() -> tuple[int, ...]:
    return tuple(fn.launches for fn in COUNTERS)


def _former(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """The ``single`` branch of ``PositionalConvEmbedding.forward`` before
    the wrapper: the conv module, the last frame dropped for an even kernel,
    GELU, over ``[B, T, D]``."""
    y = conv(x.transpose(1, 2))
    if conv.kernel_size[0] % 2 == 0:
        y = y[:, :, :-1]
    return F.gelu(y).transpose(1, 2)


def _grads(fn, x, conv, dy):
    x = x.detach().clone().requires_grad_()
    conv.zero_grad(set_to_none=True)
    y = fn(x)
    y.backward(dy)
    return y.detach(), x.grad, conv.weight.grad, conv.bias.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cg,k", [(2, 4), (2, 5), (8, 4), (8, 5), (12, 6), (12, 3)])
def test_plain_equals_former_composition(cg, k, dtype):
    """The wrapper on CPU tensors (its plain version) computes the former
    composition's output and gradients (x, weight, bias) bit for bit, at 3
    groups of ``cg`` channels and even and odd kernels, in fp32 and with
    bf16 compute over fp32 parameters."""
    g, b, t = 3, 2, 11
    torch.manual_seed(cg * 10 + k)
    conv = Conv1d(g * cg, g * cg, k, padding=k // 2, groups=g, dtype=dtype,
                  param_dtype=torch.float32)
    x = torch.randn(b, t, g * cg).to(dtype)
    dy = torch.randn(b, t, g * cg).to(dtype)
    a0 = _launches()
    got = _grads(lambda v: pos_conv.pos_conv_gelu(v, conv.weight, conv.bias, g), x, conv, dy)
    want = _grads(lambda v: _former(conv, v), x, conv, dy)
    assert got[0].shape == (b, t, g * cg) and got[0].dtype == dtype
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert _launches() == a0 == (0, 0, 0)  # nothing launches on the CPU


def test_single_module_matches_jax_conv():
    """The ``single`` module (wrapper, plain version) against the JAX
    package's ``PositionalConvEmbedding`` at a tiny shape (4 groups of 8
    channels, even kernel 6), fp32 on both sides: output and the gradients of
    the input and the kernel under one cotangent, to sums in another order
    (rtol 1e-5, atol 1e-6)."""
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.models import BackboneConfig as JaxCfg
    from privacy_preserve_federated_asr_tpu.models.backbone import (
        PositionalConvEmbedding as JaxPosConv,
    )

    kw = dict(hidden_size=32, num_conv_pos_embedding_groups=4, pos_conv_type="single",
              num_conv_pos_embeddings=6)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 13, 32)).astype(np.float32)
    dy = rng.normal(0, 1, (2, 13, 32)).astype(np.float32)
    kernel = rng.normal(0, 0.2, (6, 8, 32)).astype(np.float32)  # flax: [K, Cin / G, Cout]
    bias = rng.normal(0, 0.1, (32,)).astype(np.float32)
    jmod = JaxPosConv(JaxCfg.tiny_for_tests(**kw))
    params = {"conv": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    ref, vjp = jax.vjp(lambda p, v: jmod.apply({"params": p}, v), params, jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(dy))

    mod = PositionalConvEmbedding(BackboneConfig.tiny_for_tests(**kw), torch.float32,
                                  torch.float32)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(kernel.transpose(2, 1, 0).copy()))
        mod.conv.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt)
    y.backward(torch.from_numpy(dy))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **tol)
    np.testing.assert_allclose(mod.conv.weight.grad.numpy(),
                               np.asarray(dparams["conv"]["kernel"]).transpose(2, 1, 0), **tol)
    np.testing.assert_allclose(mod.conv.bias.grad.numpy(), np.asarray(dparams["conv"]["bias"]),
                               **tol)


@pytest.mark.parametrize("case", ["channels", "taps", "dtype", "device"])
def test_kernel_path_refuses_what_the_kernels_do_not_take(case):
    """The kernels' Function checks its inputs before it launches: channels
    a group that are not a multiple of 8 (or above 128), more than 256 taps,
    another dtype than bf16, and tensors off the card all raise."""
    cg, k, dtype = {"channels": (9, 4, torch.bfloat16), "taps": (8, 257, torch.bfloat16),
                    "dtype": (8, 4, torch.float16), "device": (8, 4, torch.bfloat16)}[case]
    x = torch.zeros(1, 5, 4 * cg, dtype=dtype)
    w, b = torch.zeros(4 * cg, cg, k), torch.zeros(4 * cg)
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        pos_conv._PosConvGelu.apply(x, w, b, 4)
    assert _launches() == (0, 0, 0)


def test_single_module_refuses_another_activation():
    """The ``single`` path computes GELU; a config asking for another
    activation there is refused when the module is built."""
    cfg = BackboneConfig.tiny_for_tests(pos_conv_type="single", feat_extract_activation="relu")
    with pytest.raises(ValueError, match="GELU"):
        PositionalConvEmbedding(cfg, torch.float32, torch.float32)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/pos_conv.cu)")


def _case(b, t, d, g, k, seed):
    """Seeded bf16 x and dy [B, T, D] on the card, an fp32 weight at the
    scale of a trained conv (std 1 / sqrt(fan-in)) and bias."""
    gen = torch.Generator("cuda").manual_seed(seed)
    cg = d // g
    x = torch.randn(b, t, d, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(b, t, d, generator=gen, device="cuda").bfloat16()
    w = torch.randn(d, cg, k, generator=gen, device="cuda") * (cg * k) ** -0.5
    bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
    return x, dy, w, bias


def _plain_fp32(x, dy, w, bias, g):
    """The plain version in fp32 (TF32 off) on the kernels' inputs: x and dy
    as bf16 holds them, the weight and bias rounded to bf16 as the kernels
    read them. -> y, dx, dw, db."""
    xf = x.float().requires_grad_()
    wf = w.bfloat16().float().requires_grad_()
    bf = bias.bfloat16().float().requires_grad_()
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = pos_conv.pos_conv_gelu_plain(xf, wf, bf, g)
        y.backward(dy.float())
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    return y.detach(), xf.grad, wf.grad, bf.grad


def _kernels(x, dy, w, bias, g):
    """The kernel path -> y, dx, dw, db, as autograd hands them to the
    parameters (fp32)."""
    xk = x.clone().requires_grad_()
    wk, bk = w.clone().requires_grad_(), bias.clone().requires_grad_()
    y = pos_conv.pos_conv_gelu(xk, wk, bk, g)
    y.backward(dy)
    return y.detach(), xk.grad, wk.grad, bk.grad


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 749, 1920, 16, 128), (8, 499, 1920, 16, 128),
                                   (4, 749, 1024, 16, 128), (3, 37, 768, 16, 128)],
                         ids=["xlsr-T749", "xlsr-T499", "large-T749", "base-T37"])
def test_kernels_match_plain_fp32_on_the_card(shape):
    """y, dx, dW and db of the kernels against the plain version in fp32 on
    the same bf16 inputs. The kernels sum in fp32 (the order of wgmma's and of
    the weight gradient's fixed chunks: ~1e-6 relative at 15360 or 5992
    terms) and round to bf16 where the former bf16 path rounded: pre and y,
    dz = dy GELU'(pre) and dx (2^-9 relative each). So each result's error
    norm is held to 1e-2 of its norm, about 4x the bf16 roundings' share, and
    its largest error to 2e-2 of its largest value; a wrong tap, channel or
    frame moves whole rows and reads near 1. dW and db come as fp32, and two
    backward passes give them bit for bit (no atomics)."""
    _needs_card()
    b, t, d, g, k = shape
    x, dy, w, bias = _case(b, t, d, g, k, seed=sum(shape))
    a0 = _launches()
    got = _kernels(x, dy, w, bias, g)
    assert _launches() == (a0[0] + 1, a0[1] + 1, a0[2] + 1)
    again = _kernels(x, dy, w, bias, g)
    want = _plain_fp32(x, dy, w, bias, g)
    for name, a, r in zip(("y", "dx", "dw", "db"), got, want):
        assert a.shape == r.shape, name
        assert a.dtype == (torch.float32 if name in ("dw", "db") else torch.bfloat16), name
        err = (a.float() - r).norm() / r.norm()
        peak = (a.float() - r).abs().max() / r.abs().max()
        assert err < 1e-2 and peak < 2e-2, (name, float(err), float(peak))
    for a, a2 in zip(got[2:], again[2:]):
        assert torch.equal(a, a2)


def _card_trainer(pos_conv_type: str) -> Trainer:
    """The tiny Trainer of test_torch_tracing.py (which imports JAX, so it
    is not imported here) in bf16 on the card, at head dim 64 (the
    attention kernels' width), 16 groups of 8 channels in the conv."""
    backbone = BackboneConfig.tiny_for_tests(
        hidden_size=128, num_attention_heads=2, intermediate_size=256,
        num_conv_pos_embedding_groups=16, pos_conv_type=pos_conv_type,
        num_conv_pos_embeddings=4 if pos_conv_type == "single" else 2)
    cfg = DACSConfig(backbone=backbone, stage=0)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    examples = prepare_examples(
        [AsrExample(path=f"S00{i}_PAR_{i}.wav", text=text, dementia_label=i,
                    array=rng.normal(0, 0.1, n).astype(np.float32))
         for i, (n, text) in enumerate([(1100, "THE JAR"), (800, "A STOOL")])],
        CTCCharTokenizer())
    tcfg = TrainerConfig(batch_size=2, learning_rate=1e-3, time_multiple=400, log_dir=".",
                         compute_dtype="bfloat16")
    return Trainer(cfg, sd, examples, None, CTCCharTokenizer(), tcfg, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pos_conv_type", ["single", "stacked"])
def test_train_step_launches_each_kernel_once(pos_conv_type):
    """One bf16 train step of a ``single`` model launches the forward, the
    input gradient and the weight gradient once each; a ``stacked`` model
    (data2vec) launches none of them."""
    _needs_card()
    tr = _card_trainer(pos_conv_type)
    _, (fn, args) = next(iter(tr.train_batches(0)))
    a0 = _launches()
    metrics = fn(tr.state, *args)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert tuple(n - m for n, m in zip(_launches(), a0)) == (
        (1, 1, 1) if pos_conv_type == "single" else (0, 0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["channels", "dtype"])
def test_wrapper_refuses_on_the_card(case):
    """On the card the wrapper launches the kernels or raises: 4 groups of 9
    channels (not a multiple of 8) and fp16 are refused, with nothing
    launched; there is no fallback."""
    _needs_card()
    cg, dtype = (9, torch.bfloat16) if case == "channels" else (8, torch.float16)
    x = torch.zeros(1, 5, 4 * cg, dtype=dtype, device="cuda")
    w, b = torch.zeros(4 * cg, cg, 4, device="cuda"), torch.zeros(4 * cg, device="cuda")
    a0 = _launches()
    with pytest.raises(ValueError if case == "channels" else TypeError):
        pos_conv.pos_conv_gelu(x, w, b, 4)
    assert _launches() == a0
