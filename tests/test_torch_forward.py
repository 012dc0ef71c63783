"""The cache-free forward held against the JAX package on the CPU: whole-
model logits of reduced stablelm-1.6b for every attention impl, with the
reference's weights carried across; the uncached attention dispatch
``kernels.ops.attention``; the chunked (``xla``) attention with padding,
GQA and a sliding window; and the cached forward of the dense impls over
a paged cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

IMPLS = ("xla", "flash", "bitstopper", "bitstopper_xla")
# Dense impls: f32 matmuls summed in another order differ by ulps (measured
# 1.3e-6 on these logits).  BitStopper impls: an ulp can also move one
# INT12-quantized value across a rounding boundary, which shifts a score by
# one quantization step in that layer and propagates (measured 7.4e-5; the
# reason is the one of test_torch_model.py's forward test, and so is 1e-3).
LOGIT_TOL = {"xla": 2e-5, "flash": 2e-5, "bitstopper": 1e-3,
             "bitstopper_xla": 1e-3}
ATTN_TOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced("stablelm-1.6b").replace(bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(weights, impl):
    """``forward(params, tokens, cfg)`` with no caches: logits within the
    stated tolerance and the same argmax at every position."""
    jcfg, tcfg, jparams, tparams = weights
    tokens = np.random.default_rng(3).integers(0, 256, (2, 64)).astype(
        np.int32)
    want, jc, _ = JT.forward(jparams, jnp.asarray(tokens),
                             jcfg.replace(attn_impl=impl))
    got, tc, _ = TT.forward(tparams, torch.as_tensor(tokens),
                            tcfg.replace(attn_impl=impl))
    assert jc is None and tc is None
    want = np.asarray(want)
    tol = LOGIT_TOL[impl]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_forward_untiled_length_raises_for_the_kernel(weights):
    """The kernel branch runs unpadded, as the reference's does: a length
    its tiles do not fit fails there (assertion) and raises here, while
    the block oracle pads."""
    jcfg, tcfg, jparams, tparams = weights
    tokens = np.zeros((1, 20), np.int32)
    with pytest.raises(AssertionError):
        JT.forward(jparams, jnp.asarray(tokens),
                   jcfg.replace(attn_impl="bitstopper"))
    with pytest.raises(ValueError, match="multiple of 8"):
        TT.forward(tparams, torch.as_tensor(tokens),
                   tcfg.replace(attn_impl="bitstopper"))
    got, _, _ = TT.forward(tparams, torch.as_tensor(tokens),
                           tcfg.replace(attn_impl="bitstopper_xla"))
    assert got.shape == (1, 20, tcfg.vocab)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cached_dense_impls_stay_unported(weights, impl):
    """The cached forward of the dense impls, once refused here, is now
    ported (the name is kept): over a paged cache, a prefill of 4 tokens
    then a decode step give the reference's logits, and the written K/V
    and positions equal its cache leaves."""
    from repro.serving.engine import _attach_tables as jattach
    from repro_torch.serving.engine import _attach_tables as tattach
    jcfg, tcfg, jparams, tparams = weights
    jcfg, tcfg = jcfg.replace(attn_impl=impl), tcfg.replace(attn_impl=impl)
    table = np.array([[1, 0]], np.int32)
    jcaches = JT.init_caches(jcfg, 1, 16, paged=JA.PagedLayout(4, 8, 2))
    tcaches = TT.init_caches(tcfg, 1, paged=TA.PagedLayout(4, 8, 2))
    tokens = np.random.default_rng(6).integers(0, 256, (1, 5)).astype(
        np.int32)
    for lo, hi in ((0, 4), (4, 5)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        length = np.array([lo], np.int32)
        want, jcaches, _ = JT.forward(
            jparams, jnp.asarray(tokens[:, lo:hi]), jcfg,
            caches=jattach(jcaches, table, length),
            positions=jnp.asarray(pos))
        got, tcaches, _ = TT.forward(
            tparams, torch.as_tensor(tokens[:, lo:hi]), tcfg,
            caches=tattach(tcaches, torch.as_tensor(table),
                           torch.as_tensor(length)),
            positions=torch.as_tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL[impl], rtol=LOGIT_TOL[impl])
    back = TT.caches_to_numpy(tcaches, tcfg)
    ref = jax.tree.map(np.asarray, jcaches)
    for t, j in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("causal", [False, True])
def test_ops_attention_matches_reference(impl, causal):
    """``ops.attention`` over [B, H, S, d] for every impl, against the
    reference's dispatch (its kernels in interpret mode)."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 2, 64, 32)).astype(np.float32)
               for _ in range(3))
    want = jops.attention(*map(jnp.asarray, (q, k, v)), impl=impl,
                          causal=causal, cfg=JConfig(alpha=0.6),
                          block_q=32, block_k=32)
    got = tops.attention(*map(torch.as_tensor, (q, k, v)), impl=impl,
                         causal=causal, cfg=TConfig(alpha=0.6), block_q=32,
                         block_k=32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_chunked_attention_matches_reference(window):
    """Grouped GQA (4 query heads on 2 KV heads), lengths that pad to whole
    chunks (40 queries and keys in chunks of 16), causal, with and without
    a sliding window."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(40, dtype=np.int32)
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, window=window, chunk_q=16,
                                chunk_k=16)
    got = TA.chunked_attention(*map(torch.as_tensor, (q, k, v, pos, pos)),
                               causal=True, window=window, chunk_q=16,
                               chunk_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_flash_with_window_takes_the_chunked_path(weights):
    """A sliding-window layer under ``impl="flash"`` runs the chunked
    attention, as in the reference: one layer's output against its."""
    jcfg, tcfg, jparams, tparams = weights
    jac = jcfg.replace(attn_impl="flash", window=16).attn_config(local=True)
    tac = tcfg.replace(attn_impl="flash", window=16).attn_config(local=True)
    assert (tac.window, tac.chunk_q) == (16, jac.chunk_q)
    p = jax.tree.map(np.asarray, jparams["seg0"]["b0"]["attn"])
    p = jax.tree.map(lambda a: a[0], p)
    x = np.random.default_rng(10).normal(size=(2, 48, jcfg.d_model)).astype(
        np.float32)
    pos = np.arange(48, dtype=np.int32)
    want, _ = JA.attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jnp.asarray(pos), jac)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), p)
    got, _ = TA.attention(tp, torch.as_tensor(x), torch.as_tensor(pos), tac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
