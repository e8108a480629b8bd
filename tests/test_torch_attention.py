"""The port's attention (privacy_preserve_federated_asr_tpu_torch/ops/
attention.py) against the JAX package's: the plain version against
``attention_xla`` and the Pallas kernel (interpret mode), the counter-based
dropout keep mask bit for bit, and the CUDA kernel against the plain version
where a card is present. JAX is imported inside the tests that use it, so
the card-only test also runs where JAX is not installed:
``python -m pytest tests/test_torch_attention.py -k cuda``."""

import math

import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu_torch.ops import attention as port

B, H, D = 2, 4, 16
TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 on both sides, sums in another order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the cores the
    parallel test workers share (restored after the module). Defined here,
    not imported from test_torch_backbone, which imports JAX."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (B, t, H, D)).astype(np.float32) for _ in range(3))
    lengths = np.array([t, t // 2 + 3])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, mask


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("t", [100, 128])
def test_ref_matches_attention_xla(t):
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops.attention import attention_xla

    q, k, v, mask = _inputs(t)
    ref = np.asarray(attention_xla(*(jnp.asarray(x) for x in (q, k, v, mask))))
    got = port.attention_ref(*_torch(q, k, v, mask)).numpy()
    valid = mask.astype(bool)  # rows with at least one valid key
    np.testing.assert_allclose(got[valid], ref[valid], **TOL)
    # CPU tensors take the plain version through the public entry point
    np.testing.assert_array_equal(
        port.multihead_attention(*_torch(q, k, v, mask)).numpy(), got)


def test_ref_matches_pallas_interpret():
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops.attention import multihead_attention as jax_mha

    q, k, v, mask = _inputs(100, seed=1)
    ref = np.asarray(jax_mha(*(jnp.asarray(x) for x in (q, k, v, mask)),
                             impl="pallas", block=64))
    got = port.attention_ref(*_torch(q, k, v, mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], ref[valid], **TOL)


def test_keep_mask_bit_equal_to_tpu_hash():
    from test_attention import _np_keep_mask

    t, rate = 96, 0.3
    got = port.keep_mask(12345, B * H, t, t, t, rate).numpy()
    want = np.stack([_np_keep_mask(12345, bh, t, rate) for bh in range(B * H)])
    np.testing.assert_array_equal(got, want)
    # negative int32 seeds wrap like the TPU's int32 arithmetic
    got_neg = port.keep_mask(-7, 1, 8, 8, 8, rate).numpy()
    np.testing.assert_array_equal(got_neg[0], _np_keep_mask(2**32 - 7, 0, 8, rate))


def test_dropout_forward_matches_jax_flash():
    """T=100 padded to the JAX block 64 -> T_pad=128: the port hashes with
    t_hash=128 and reproduces the TPU kernel's dropped forward."""
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops.attention import _flash_attention

    t, t_pad, rate, seed = 100, 128, 0.3, 12345
    q, k, v, mask = _inputs(t, seed=2)
    pad = ((0, 0), (0, t_pad - t), (0, 0), (0, 0))
    qp, kp, vp = (jnp.asarray(np.pad(x, pad)) for x in (q, k, v))
    mp = jnp.asarray(np.pad(mask, ((0, 0), (0, t_pad - t))))
    ref = np.asarray(_flash_attention(qp, kp, vp, mp,
                                      jnp.full((1, 1), seed, jnp.int32), 64, rate))[:, :t]
    got = port.attention_ref(*_torch(q, k, v, mask), rate=rate, seed=seed,
                             t_hash=t_pad).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], ref[valid], **TOL)
    no_drop = port.attention_ref(*_torch(q, k, v, mask)).numpy()
    assert not np.allclose(got[valid], no_drop[valid])


def test_all_masked_row_is_finite():
    q, k, v, mask = _inputs(40, seed=3)
    mask[1] = 0
    got = port.attention_ref(*_torch(q, k, v, mask)).numpy()
    assert np.isfinite(got).all()
    # every key gets exp(0): the row is the plain average of V
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), got[1].shape),
                               rtol=1e-5, atol=1e-6)


def _pallas_fwd_grads(q, k, v, mask, g, rate, seed, t_pad=128, block=64):
    """The output and (dq, dk, dv) of the JAX ``_flash_attention`` (TPU
    kernels B1/B2 in interpret mode) at T padded to ``t_pad``, cut back to T."""
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.ops.attention import _flash_attention

    t = q.shape[1]
    pad = ((0, 0), (0, t_pad - t), (0, 0), (0, 0))
    qp, kp, vp, gp = (jnp.asarray(np.pad(x, pad)) for x in (q, k, v, g))
    mp = jnp.asarray(np.pad(mask, ((0, 0), (0, t_pad - t))))
    seed_arr = jnp.full((1, 1), seed, jnp.int32)
    out, vjp = jax.vjp(lambda a, b, c: _flash_attention(a, b, c, mp, seed_arr, block, rate),
                       qp, kp, vp)
    return np.asarray(out)[:, :t], [np.asarray(x)[:, :t] for x in vjp(gp)]



@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bwd_ref_matches_pallas_grads(rate):
    """The plain B2 against jax.vjp through the TPU kernels (interpret mode)
    at T=100 (T_pad 128, block 64) with an explicit seed: the keep mask of
    the backward regenerates the forward's bit for bit. The cotangent is
    zeroed on padded query rows (their outputs are undefined)."""
    q, k, v, mask = _inputs(100, seed=5)
    g = np.random.default_rng(6).normal(0, 1, q.shape).astype(np.float32)
    g *= mask[:, :, None, None]
    seed = -123456789
    want = _pallas_fwd_grads(q, k, v, mask, g, rate, seed)[1]
    qt, kt, vt, mt, gt = _torch(q, k, v, mask, g)
    o = port.attention_ref(qt, kt, vt, mt, rate, seed, t_hash=128)
    got = port.attention_bwd_ref(qt, kt, vt, mt, o, gt, rate, seed, t_hash=128)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_autograd_function_matches_bwd_ref(rate):
    """multihead_attention with grads on CPU tensors goes through
    FlashAttention, whose backward is attention_bwd_ref; on rows with a key
    that equals torch autograd through attention_ref (fp32, atol 1e-5)."""
    q, k, v, mask = _inputs(40, seed=7)
    mask[1, 30:] = 0
    g = np.random.default_rng(8).normal(0, 1, q.shape).astype(np.float32)
    g *= mask[:, :, None, None]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mt, gt = _torch(mask, g)
    out = port.multihead_attention(*leaves, mt, rate, 77, 64)
    out.backward(gt)
    o = port.attention_ref(*_torch(q, k, v), mt, rate, 77, 64)
    np.testing.assert_array_equal(out.detach().numpy(), o.numpy())
    want = port.attention_bwd_ref(*_torch(q, k, v), mt, o, gt, rate, 77, 64)
    for leaf, w in zip(leaves, want):
        np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy())
    auto = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    port.attention_ref(*auto, mt, rate, 77, 64).backward(gt)
    for leaf, a in zip(leaves, auto):
        np.testing.assert_allclose(leaf.grad.numpy(), a.grad.numpy(), atol=1e-5)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit ops on the int32 view: the rounding of the card's
    fp32 kernels (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_split(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """``a @ b`` as the card's fp32 kernels run it on the tensor cores: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), the product
    lo.hi + hi.lo + hi.hi added small terms first (``products=3``), or
    hi.hi alone (``products=1``, plain TF32). A product of two TF32 values
    is exact in fp32, so only the sums round."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    return (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + ah @ bh


def _split_attention(q, k, v, mask, keep, inv_keep, g, products=3):
    """B1 and B2's fp32 function with every product through ``_mm_split``:
    ``(o, dq, dk, dv)`` of ``[B, T, H, D]`` inputs, ``keep`` the
    ``[B, H, T, T]`` keep mask (None: no dropout), ``g`` the cotangent. As
    the kernels: q scaled before the dot, masked keys replaced, the
    undropped denominator applied after P V, inv_keep once, dS = p (dP -
    delta) with delta = rowsum(dO o)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, kk, vv, gg = (x.permute(0, 2, 1, 3) for x in (q * scale, k, v, g))
    kt, vt = kk.transpose(-1, -2), vv.transpose(-1, -2)
    s = _mm_split(qs, kt, products)
    s = torch.where((mask > 0)[:, None, None, :], s, torch.tensor(port.NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    kept = e if keep is None else torch.where(keep, e, torch.tensor(0.0))
    o = _mm_split(kept, vv, products) * inv_keep / l
    p = e / l
    a = p if keep is None else torch.where(keep, p, torch.tensor(0.0)) * inv_keep
    dv = _mm_split(a.transpose(-1, -2), gg, products)
    dp = _mm_split(gg, vt, products)
    if keep is not None:
        dp = torch.where(keep, dp, torch.tensor(0.0)) * inv_keep
    ds = p * (dp - (gg * o).sum(-1, keepdim=True))
    dq = _mm_split(ds, kk, products) * scale
    dk = _mm_split(ds.transpose(-1, -2), qs, products)
    return [x.permute(0, 2, 1, 3) for x in (o, dq, dk, dv)]


def _held(got: np.ndarray, ref: np.ndarray) -> float:
    """chip_smoke.py phase 5's measure of a gradient: max|err| / max|ref|,
    or, for a gradient that is rounding noise on both sides (max|ref| <
    1e-3: dq and dk at T=1 without dropout), max|err| on the 1e-4 scale."""
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    return err / top if top >= 1e-3 else err


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_tf32_split_holds_fp32_tolerance(rate):
    """The card's fp32 kernels run every product as three TF32 products
    (3xTF32). Emulated here in fp32 with TF32 rounding by bit ops, at the
    ragged T = 1, 63, 65, 129 (B=2, H=2, D=64; one batch row keyed up to
    3/4 of T, the other with every key masked), the forward holds
    chip_smoke.py phase 2's fp32 atol 1e-4 and each gradient its phase 5's
    max|err|/max|ref| <= 1e-4 against the JAX package's attention (TPU
    kernels in interpret mode, all four lengths padded to T_pad 256 and
    stacked along the batch: one JAX call per rate) and against the port's
    fp32 plain versions (the all-masked row and the whole cotangent too).
    One TF32 product alone misses the forward's tolerance."""
    ts, t_pad, h, d, seed = (1, 63, 65, 129), 256, 2, 64, 4321
    rng = np.random.default_rng(17)
    q, k, v, g = (rng.normal(0, 1, (2 * len(ts), t_pad, h, d)).astype(np.float32)
                  for _ in range(4))
    lengths = np.array([n for t in ts for n in (t - t // 4, 0)])
    mask = (np.arange(t_pad)[None] < lengths[:, None]).astype(np.int32)
    g *= mask[:, :, None, None]  # no cotangent on padded query rows, as in training
    want_o, want = _pallas_fwd_grads(q, k, v, mask, g, rate, seed, t_pad, block=128)
    inv_keep = 1.0 / (1.0 - rate)
    keep_all = (port.keep_mask(seed, 2 * len(ts) * h, t_pad, t_pad, t_pad, rate)
                .view(2 * len(ts), h, t_pad, t_pad) if rate else None)
    one_product = 0.0  # plain TF32's forward error, which the tolerance must see
    for i, t in enumerate(ts):
        rows = slice(2 * i, 2 * i + 2)
        qt, kt, vt, gt = (torch.from_numpy(x[rows, :t].copy()) for x in (q, k, v, g))
        mt = torch.from_numpy(mask[rows, :t].copy())
        keep = None if keep_all is None else keep_all[rows, :, :t, :t]
        o, *grads = _split_attention(qt, kt, vt, mt, keep, inv_keep, gt)
        np.testing.assert_allclose(o[0].numpy(), want_o[rows][0, :t], rtol=0, atol=1e-4,
                                   err_msg=f"T={t} output")
        o1 = _split_attention(qt, kt, vt, mt, keep, inv_keep, gt, products=1)[0]
        one_product = max(one_product, float(np.abs(o1[0].numpy() - want_o[rows][0, :t]).max()))
        for name, a, w in zip(("dq", "dk", "dv"), grads, want):
            assert _held(a.numpy(), w[rows, :t]) <= 1e-4, (t, name)
        # the port's plain versions, every row and the whole cotangent; on
        # its own the slice hashes (b*h) from 0
        whole = torch.from_numpy(rng.normal(0, 1, qt.shape).astype(np.float32))
        if rate:
            keep = port.keep_mask(seed, 2 * h, t, t, t_pad, rate).view(2, h, t, t)
        o, *grads = _split_attention(qt, kt, vt, mt, keep, inv_keep, whole)
        ref_o = port.attention_ref(qt, kt, vt, mt, rate, seed, t_pad)
        np.testing.assert_allclose(o.numpy(), ref_o.numpy(), rtol=0, atol=1e-4)
        ref = port.attention_bwd_ref(qt, kt, vt, mt, ref_o, whole, rate, seed, t_pad)
        for name, a, w in zip(("dq", "dk", "dv"), grads, ref):
            assert _held(a.numpy(), w.numpy()) <= 1e-4, (t, name, "plain")
    assert one_product > 1e-4, one_product  # one TF32 product would not hold it


# bf16: about two bf16 ulps of the output (rtol) over a small floor, as
# chip_smoke.py holds the kernel at the serving shapes
CUDA_TOL = {"float32": dict(rtol=0.0, atol=1e-4),
            "bfloat16": dict(rtol=1.6e-2, atol=4e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_ref(dtype):
    """Runs on a card only (the kernel has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B1 runs only on the card")
    rng = np.random.default_rng(4)
    b, t, h, d = 2, 150, 4, 64
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, t, h, d)).astype(np.float32))
               .to("cuda", getattr(torch, dtype)) for _ in range(3))
    lengths = torch.tensor([t, 70], device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lengths[:, None]).to(torch.int32)
    for rate in (0.0, 0.1):
        n0 = port.flash_attention_fwd.launches
        got = port.flash_attention_fwd(q, k, v, mask, rate, 99, 192).float()
        assert port.flash_attention_fwd.launches == n0 + 1
        ref = port.attention_ref(q, k, v, mask, rate, 99, 192).float()
        torch.cuda.synchronize()
        valid = mask.bool()
        torch.testing.assert_close(got[valid], ref[valid], **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_ref(dtype):
    """Kernel B2 against attention_bwd_ref; runs on a card only. fp32 atol
    1e-4 (3xTF32 products, sums in another order); bf16 gradients are
    compared relative to their largest magnitude (2e-2: bf16 operands of
    the five products). Row 2 has every key masked; the cotangent is once
    zeroed on the padded query rows (as in training) and once left whole,
    so the all-masked row's 1/T weights reach the gradients. A second call
    on the same inputs gives bit-equal gradients in either dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B2 runs only on the card")
    rng = np.random.default_rng(9)
    b, t, h, d = 3, 150, 4, 64
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (b, t, h, d)).astype(np.float32))
                  .to("cuda", dt) for _ in range(4))
    lengths = torch.tensor([t, 70, 0], device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lengths[:, None]).to(torch.int32)
    for cot in (g * mask[:, :, None, None].to(dt), g):
        for rate in (0.0, 0.1):
            o, lse = port.flash_attention_fwd(q, k, v, mask, rate, 5, 256, return_lse=True)
            n0 = port.flash_attention_bwd.launches
            got = port.flash_attention_bwd(q, k, v, mask, o, cot, lse, rate, 5, 256)
            assert port.flash_attention_bwd.launches == n0 + 1
            again = port.flash_attention_bwd(q, k, v, mask, o, cot, lse, rate, 5, 256)
            want = port.attention_bwd_ref(q, k, v, mask, o, cot, rate, 5, 256)
            torch.cuda.synchronize()
            for a, a2 in zip(got, again):
                assert torch.equal(a, a2)
            for a, w in zip(got, want):
                a, w = a.float(), w.float()
                if dtype == "float32":
                    torch.testing.assert_close(a, w, rtol=0.0, atol=1e-4)
                else:
                    assert (a - w).abs().max() <= 2e-2 * w.abs().max()


def _card_inputs(b, t, h, dtype, seed, lengths, qkv_views=False):
    """q, k, v, a cotangent g and the int32 key mask on the card; with
    ``qkv_views`` q, k and v are strided views of one [b, t, 3*h*64]
    projection, as the encoder hands them over."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    d = 64

    def card(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to("cuda", dt)

    if qkv_views:
        qkv = card(b, t, 3 * h * d)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d) for i in range(3))
    else:
        q, k, v = (card(b, t, h, d) for _ in range(3))
    lens = torch.tensor([min(max(n, 0), t) for n in lengths], device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)
    return q, k, v, card(b, t, h, d), mask


def _check_both_kernels(dtype, q, k, v, g, mask, rate, t_hash):
    """B1 against attention_ref on rows with a key, B2 against
    attention_bwd_ref with the cotangent zeroed on padded rows and whole.
    A bf16 gradient that is 0 in exact arithmetic (dq and dk at T=1 without
    dropout: one key, so dS = dP - delta = 0) holds only rounding noise on
    both sides: where max |ref| < 1e-3 it is held at atol 1e-4 instead."""
    valid = mask.bool()
    got = port.flash_attention_fwd(q, k, v, mask, rate, 7, t_hash).float()
    ref = port.attention_ref(q, k, v, mask, rate, 7, t_hash).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got[valid], ref[valid], **CUDA_TOL[dtype])
    o, lse = port.flash_attention_fwd(q, k, v, mask, rate, 7, t_hash, return_lse=True)
    for cot in (g * mask[:, :, None, None].to(g.dtype), g):
        grads = port.flash_attention_bwd(q, k, v, mask, o, cot, lse, rate, 7, t_hash)
        want = port.attention_bwd_ref(q, k, v, mask, o, cot, rate, 7, t_hash)
        torch.cuda.synchronize()
        for a, w in zip(grads, want):
            a, w = a.float(), w.float()
            assert torch.isfinite(a).all()
            if dtype == "float32" or w.abs().max() < 1e-3:
                torch.testing.assert_close(a, w, rtol=0.0, atol=1e-4)
            else:
                assert (a - w).abs().max() <= 2e-2 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 63, 65, 128, 129, 192])
def test_cuda_kernels_ragged_t(t, dtype):
    """B1 and B2 at lengths that end inside a tile or fill the 32-, 64- and
    128-row tiles exactly, dropout 0 and 0.1; runs on a card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 run only on the card")
    q, k, v, g, mask = _card_inputs(3, t, 2, dtype, t, [t, t // 2 + 1, 0])
    for rate in (0.0, 0.1):
        _check_both_kernels(dtype, q, k, v, g, mask, rate, -(-t // 128) * 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_on_strided_qkv_views(dtype):
    """q, k, v as views of one [B, T, 3*H*64] projection (strides that are
    not a contiguous [B, T, H, D]); runs on a card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 run only on the card")
    q, k, v, g, mask = _card_inputs(2, 200, 3, dtype, 11, [200, 77], qkv_views=True)
    assert not q.is_contiguous() and q.stride()[1] == 3 * 3 * 64
    for rate in (0.0, 0.1):
        _check_both_kernels(dtype, q, k, v, g, mask, rate, 256)


@pytest.mark.cuda
def test_cuda_bwd_kernel_is_deterministic():
    """Two B2 calls on the same inputs give bit-equal dq, dk and dv (the key
    tiles add their dQ shares in a fixed order); runs on a card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B2 runs only on the card")
    q, k, v, g, mask = _card_inputs(2, 700, 4, "bfloat16", 3, [700, 333])
    o, lse = port.flash_attention_fwd(q, k, v, mask, 0.1, 1, 768, return_lse=True)
    first = port.flash_attention_bwd(q, k, v, mask, o, g, lse, 0.1, 1, 768)
    for _ in range(3):
        again = port.flash_attention_bwd(q, k, v, mask, o, g, lse, 0.1, 1, 768)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
