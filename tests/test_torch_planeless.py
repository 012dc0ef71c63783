"""Planeless paged pools (a page size that is not a multiple of 8) held
against the reference on the CPU.  Such a pool carries no quant scales and
no plane pool, so its decode gathers each slot's view for the single-query
BESF (``besf_attention_decode``); several queries per slot run the
per-token BESF.  Integer observables (survivors, planes fetched) and the
scores must be equal, outputs within ``TOL``; served tokens, allocator
state, block tables and fill levels equal after every tick."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.core.besf import besf_attention_decode as jdecode
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.core.besf import besf_attention_decode as tdecode
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import PagedEngine, Request, ServeConfig
from _torch_threads import one_thread  # noqa: F401

TOL = 1e-6            # f32 softmax and S x V: exp and sum order differ


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _check(want, got):
    np.testing.assert_array_equal(got.stats.survivors.numpy(),
                                  np.asarray(want.stats.survivors))
    np.testing.assert_array_equal(got.stats.planes_fetched.numpy(),
                                  np.asarray(want.stats.planes_fetched))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("alpha,min_rounds", [(0.6, 1), (0.9, 1), (0.6, 3)])
def test_besf_attention_decode_matches_reference(alpha, min_rounds):
    """Per-slot masks (one slot cut short, one with a hole at the front);
    a hot key makes LATS prune."""
    rng = np.random.default_rng(0)
    B, H, Sk, d = 3, 4, 37, 16
    q = 2 * rng.normal(size=(B, H, 1, d)).astype(np.float32)
    k = rng.normal(size=(B, H, Sk, d)).astype(np.float32)
    v = rng.normal(size=(B, H, Sk, d)).astype(np.float32)
    k[:, :, 5] *= 4
    mask = np.ones((B, 1, 1, Sk), bool)
    mask[0, ..., 30:] = False
    mask[2, ..., :3] = False
    jc = JConfig(alpha=alpha, min_rounds=min_rounds)
    tc = TConfig(alpha=alpha, min_rounds=min_rounds)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=jc,
                   mask=jnp.asarray(mask))
    got = tdecode(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                  cfg=tc, mask=torch.as_tensor(mask))
    _check(want, got)
    assert 0 < np.asarray(want.stats.survivors).mean() < 1
    with pytest.raises(ValueError, match="single-query"):
        tdecode(torch.as_tensor(q).expand(B, H, 2, d), torch.as_tensor(k),
                torch.as_tensor(v), cfg=tc)


@pytest.mark.parametrize("B,Sq", [(3, 1), (2, 3), (1, 5)])
def test_cached_attention_branches_match_reference(B, Sq):
    """Each BitStopper branch of ``_cached_attention`` on gathered views:
    one query per slot (planeless decode), several per slot (the per-token
    BESF) and one slot's chunk (block BitStopper), every row masked by its
    own fill level; GQA with two query heads per KV head."""
    rng = np.random.default_rng(B * 10 + Sq)
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              impl="bitstopper_xla")
    jcfg = JA.AttnConfig(**kw, bitstopper=JConfig(alpha=0.8))
    tcfg = TA.AttnConfig(**kw, bitstopper=TConfig(alpha=0.8))
    T = 24
    q = rng.normal(size=(B, Sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(B, T, 2, 16)).astype(np.float32)
    v = rng.normal(size=(B, T, 2, 16)).astype(np.float32)
    fill = rng.integers(Sq + 3, T + 1, B)
    k_pos = np.where(np.arange(T)[None] < fill[:, None], np.arange(T)[None],
                     TA.POS_SENTINEL).astype(np.int32)
    q_pos = (fill[:, None] - Sq + np.arange(Sq)[None]).astype(np.int32)
    if B > 1:
        q_pos[-1] = TA.POS_SENTINEL            # a row still prefilling
    want = JA._cached_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(q_pos),
                                jnp.asarray(k_pos), jcfg)
    got = TA._cached_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), torch.as_tensor(q_pos),
                               torch.as_tensor(k_pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


# A page of 12 tokens: pages and 8-token prefill buckets never align.
_KW = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=12)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.7, 7)])
def test_planeless_serve_lockstep(model, temperature, seed):
    """Greedy and sampled serving at page_size=12, a shared prompt prefix
    of two full pages: no kernel resolves, no scale or plane leaf exists,
    and every tick equals the reference's."""
    jcfg, tcfg, jparams, tparams = model
    jeng = JEngine(jcfg, jparams, JServe(temperature=temperature, **_KW))
    teng = PagedEngine(tcfg, tparams, ServeConfig(temperature=temperature,
                                                  **_KW), device="cpu")
    assert jeng.cfg.fused_decode is teng.cfg.fused_decode is False
    layer = teng.caches["seg0"][0]["b0"]
    assert not {"k_amax", "v_amax", "kq"} & set(layer)
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, 24, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, L,
                                                    dtype=np.int32)])
               for L in (5, 13, 9)]
    jreqs = [jeng.submit(JRequest(prompt=p.copy(), max_new_tokens=10))
             for p in prompts]
    treqs = [teng.submit(Request(prompt=p.copy(), max_new_tokens=10))
             for p in prompts]
    jeng.begin(seed)
    teng.begin(seed)
    ticks = 0
    while jeng.pending() or teng.pending():
        jeng.step()
        teng.step()
        ticks += 1
        assert teng.pool.snapshot() == jeng.pool.snapshot(), ticks
        np.testing.assert_array_equal(teng.table, jeng.table)
        np.testing.assert_array_equal(teng.lengths, jeng.lengths)
        assert ([r.generated for r in treqs]
                == [r.generated for r in jreqs]), ticks
    assert all(len(r.generated) == 10 for r in treqs)
    assert teng.counters["prefix_hit_tokens"] >= 24
    assert teng.counters == {k: jeng.counters[k] for k in teng.counters}
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


def test_planeless_pool_refuses_kernel_and_speculation(model):
    """The reference's two refusals on a planeless pool, with its
    messages: the decode kernel (at ServeConfig) and speculative serving
    (at the engine, whose verify shares the pool-wide scales)."""
    jcfg, tcfg, jparams, tparams = model
    with pytest.raises(ValueError) as want:
        JServe(fused_decode=True, **_KW)
    with pytest.raises(ValueError) as got:
        ServeConfig(fused_decode=True, **_KW)
    assert str(got.value) == str(want.value)
    for spec in ("ngram", "draft"):
        with pytest.raises(ValueError) as want:
            JEngine(jcfg, jparams, JServe(speculative=spec, **_KW))
        with pytest.raises(ValueError) as got:
            PagedEngine(tcfg, tparams, ServeConfig(speculative=spec, **_KW),
                        device="cpu")
        assert str(got.value) == str(want.value)
