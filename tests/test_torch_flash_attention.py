"""The port's flash attention held against the JAX package on the CPU: its
plain version against the reference's Pallas kernel (interpret mode) and
dense oracle, the reference's block clamps and tiling check, and the batched
one-launch form.  The gpu-marked test holds the CUDA kernel against the
plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_single as jflash
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as tref
from repro_torch.kernels.runtime import width_refusal
from _torch_threads import one_thread  # noqa: F401

# f32 on both sides; exp and the order of the sums differ between the
# frameworks and between tiled and dense softmax, by a few ulps.
TOL = 2e-5


def _inputs(seed, Sq, Sk, d, dv, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (Sq, d)).astype(np.float32),
            rng.normal(size=lead + (Sk, d)).astype(np.float32),
            rng.normal(size=lead + (Sk, dv)).astype(np.float32))


@pytest.mark.parametrize("Sq,Sk,d,dv", [
    (128, 128, 64, 64),
    (128, 256, 64, 128),
    (256, 256, 128, 128),
    (64, 128, 32, 32),
    (128, 128, 256, 256),     # recurrentgemma-2b's heads
    (128, 128, 192, 128),     # deepseek-v3's MLA q/k and value heads
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_reference(Sq, Sk, d, dv, causal):
    """The shapes of ``tests/test_kernels.py::test_flash_matches_ref``,
    blocks of 64: the port's single-slice form (plain version on the CPU)
    against the reference's kernel and its dense oracle."""
    q, k, v = _inputs(Sq + Sk + d, Sq, Sk, d, dv)
    got = FA.flash_attention_single(*map(torch.as_tensor, (q, k, v)),
                                    causal=causal, block_q=64, block_k=64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jflash(jq, jk, jv, causal=causal, block_q=64, block_k=64),
                 jref.flash_attention(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_flash_bf16_matches_reference():
    """bf16 inputs (``test_flash_dtypes``): computed in f32, returned in
    bf16; 2e-2 as in the reference's own test (one bf16 ulp at 1 is 8e-3,
    and the two frameworks round the einsum's bf16 result differently)."""
    q, k, v = (x.astype(jnp.bfloat16) for x in
               map(jnp.asarray, _inputs(1, 128, 128, 128, 128)))
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (q, k, v))
    got = FA.flash_attention_single(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = jflash(q, k, v)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_flash_untiled_shape_raises():
    """Where the reference's kernel fails its tiling assertion, the port
    raises ``ValueError`` (on the CPU too, before any work)."""
    q, k, v = _inputs(2, 96, 96, 32, 32)
    with pytest.raises(AssertionError):
        jflash(*map(jnp.asarray, (q, k, v)), block_q=64, block_k=64)
    with pytest.raises(ValueError, match="tiled"):
        FA.flash_attention_single(*map(torch.as_tensor, (q, k, v)),
                                  block_q=64, block_k=64)
    with pytest.raises(ValueError):
        FA.flash_attention_single(*map(torch.as_tensor,
                                       _inputs(2, 8, 8, 4, 4, (2,))))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_batched_equals_slices(causal):
    """The batched form over [B, H, S, d] equals the single form slice by
    slice, and the dense oracle."""
    q, k, v = map(torch.as_tensor, _inputs(3, 64, 64, 16, 16, (2, 3)))
    got = FA.flash_attention(q, k, v, causal=causal)
    assert got.shape == (2, 3, 64, 16)
    for b in range(2):
        for h in range(3):
            one = FA.flash_attention_single(q[b, h], k[b, h], v[b, h],
                                            causal=causal)
            torch.testing.assert_close(got[b, h], one, atol=0, rtol=0)
    torch.testing.assert_close(got, tref.flash_attention(q, k, v, causal),
                               atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at the forward's tile (128)
    and at small tiles, causal and not, one launch per call; head width 160
    (stablelm-12b: K and V tiles in two chunks); the CUDA-core form at head
    widths 256, 192 (value width 128) and 176 (tiles of 8), and at value
    width 48; a value width that is not a multiple of 16 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [((4, 2), 256, 256, 64, 64, 128), ((3,), 128, 256, 64, 128, 64),
             ((2,), 64, 128, 32, 32, 64), ((2, 2), 64, 64, 16, 16, 128),
             ((2,), 256, 256, 160, 160, 128),
             ((2,), 256, 256, 256, 256, 128), ((3,), 128, 256, 192, 128, 64),
             ((2,), 64, 64, 176, 64, 8), ((2,), 64, 64, 48, 48, 32)]
    for i, (lead, Sq, Sk, d, dv, blk) in enumerate(cases):
        q, k, v = (torch.as_tensor(x, device="cuda")
                   for x in _inputs(10 + i, Sq, Sk, d, dv, lead))
        for causal in (False, True):
            before = FA.LAUNCHES
            got = FA.flash_attention(q, k, v, causal=causal, block_q=blk,
                                     block_k=blk)
            want = FA.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert FA.LAUNCHES == before + 1
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    q, k, v = (torch.as_tensor(x, device="cuda")
               for x in _inputs(20, 64, 64, 48, 40))
    with pytest.raises(ValueError, match="value widths"):
        FA.flash_attention(q, k, v)


@pytest.mark.parametrize("d,dv", [(256, 256), (64, 48), (192, 64), (64, 40),
                                  (200, 64), (272, 64), (64, 272)])
def test_flash_kernel_refuses_widths_it_does_not_take(d, dv):
    """Value widths that are not a multiple of 16, widths over 256, and
    heads over 160 that are not a multiple of 16 raise before any launch.
    The first three widths were refused until the kernel took every head
    and value width that is a multiple of 16 up to 256 (its CUDA-core
    form): they are held instead, the plain version (the CPU path) against
    the reference's kernel and its dense oracle."""
    q, k, v = _inputs(21, 128, 128, d, dv)
    if width_refusal(d, dv) is None:
        got = FA.flash_attention_single(*map(torch.as_tensor, (q, k, v)),
                                        causal=True)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        for want in (jflash(jq, jk, jv, causal=True),
                     jref.flash_attention(jq, jk, jv, causal=True)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL)
        return
    before = FA.LAUNCHES
    with pytest.raises(ValueError, match="value widths"):
        FA.launch_kernel(*(torch.as_tensor(x)[None] for x in (q, k, v)),
                         True, 0.125, 128, 128)
    assert FA.LAUNCHES == before
