"""The port's attention (privacy_preserve_federated_asr_tpu_torch/ops/
attention.py) against the JAX package's: the plain version against
``attention_xla`` and the Pallas kernel (interpret mode), the counter-based
dropout keep mask bit for bit, and the CUDA kernel against the plain version
where a card is present. JAX is imported inside the tests that use it, so
the card-only test also runs where JAX is not installed:
``python -m pytest tests/test_torch_attention.py -k cuda``."""

import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu_torch.ops import attention as port

B, H, D = 2, 4, 16
TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 on both sides, sums in another order


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


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cuda_kernel_matches_ref(dtype, tol):
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
        torch.testing.assert_close(got[valid], ref[valid], rtol=tol, atol=tol)
