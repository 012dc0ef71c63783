"""The port's model held against the JAX package on the CPU: the layers,
the paged cache write path (every cache leaf byte-equal after each write,
including the requant-on-growth branch), the gathered view, the numpy
bridge and whole-model logits of reduced stablelm-1.6b with the reference's
weights carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT


def _t(a):
    return torch.as_tensor(np.array(a))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_layers_match_reference():
    """f32 layers within 1e-5 (elementwise transcendental functions and
    reduction order differ by a few ulps between the frameworks)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    lin = {"w": rng.normal(size=(16, 3, 4)).astype(np.float32),
           "b": rng.normal(size=(3, 4)).astype(np.float32)}
    ln = {"scale": rng.normal(size=16).astype(np.float32),
          "bias": rng.normal(size=16).astype(np.float32)}
    mlp = {k: {"w": rng.normal(size=s).astype(np.float32) * 0.3}
           for k, s in (("wi_gate", (16, 32)), ("wi_up", (16, 32)),
                        ("wo", (32, 16)), ("wi", (16, 32)))}
    emb = {"table": rng.normal(size=(11, 16)).astype(np.float32)}
    pos = np.array([[0, 3, 7, 100, 1000]] * 2, np.int32)
    tt = lambda tree: jax.tree.map(_t, tree)
    jj = lambda tree: jax.tree.map(jnp.asarray, tree)
    pairs = [
        (TL.linear(tt(lin), _t(x)), JL.linear(jj(lin), jnp.asarray(x))),
        (TL.layer_norm(tt(ln), _t(x)), JL.layer_norm(jj(ln), jnp.asarray(x))),
        (TL.rms_norm(tt({"scale": ln["scale"]}), _t(x)),
         JL.rms_norm(jj({"scale": ln["scale"]}), jnp.asarray(x))),
        (TL.rope(_t(x.reshape(2, 5, 2, 8)), _t(pos)),
         JL.rope(jnp.asarray(x.reshape(2, 5, 2, 8)), jnp.asarray(pos))),
        (TL.mlp(tt(mlp), _t(x), "swiglu"),
         JL.mlp(jj(mlp), jnp.asarray(x), "swiglu")),
        (TL.mlp(tt(mlp), _t(x), "gelu"),
         JL.mlp(jj(mlp), jnp.asarray(x), "gelu")),
        (TL.mlp(tt(mlp), _t(x), "geglu"),
         JL.mlp(jj(mlp), jnp.asarray(x), "geglu")),
        (TL.unembed(tt(emb), _t(x)), JL.unembed(jj(emb), jnp.asarray(x))),
        (TL.embed(tt(emb), _t(pos % 11)),
         JL.embed(jj(emb), jnp.asarray(pos % 11))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_truncated_normal_init():
    gen = torch.Generator().manual_seed(0)
    w = TL.truncated_normal_init(gen, (400, 300), 1.0)
    std = 1.0 / np.sqrt(400)
    assert w.shape == (400, 300) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    assert abs(float(w.std()) / std - 0.88) < 0.02      # N(0,1) cut at 2


def _acfg(fused=True, G=1):
    kw = dict(d_model=16, n_heads=2 * G, n_kv_heads=2, head_dim=8,
              impl="bitstopper_xla", fused_decode=fused)
    return JA.AttnConfig(**kw), TA.AttnConfig(**kw)


def _cache_pair(batch, layout, table, fused=True):
    jc, tc = _acfg(fused)
    jcache = JA.init_cache(jc, batch=batch, max_len=64,
                           paged=JA.PagedLayout(*layout))
    tcache = TA.init_cache(tc, batch, paged=TA.PagedLayout(*layout))
    jcache = dict(jcache, table=jnp.asarray(table, jnp.int32))
    tcache = dict(tcache, table=_t(np.asarray(table, np.int32)))
    return jcache, tcache


def _assert_same_cache(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        got, want = tcache[key].numpy(), np.asarray(jcache[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("fused", [True, False])
def test_cache_writes_byte_equal_with_requant_on_growth(fused):
    """A write sequence through two block tables: a mid-page prefill, an
    idle row at the sentinel, a page-crossing append, a decode write that
    grows the running amax (whole-pool requant) and writes that do not.
    Every leaf (k/v/pos/table/length/k_amax/v_amax/kq) equals the
    reference's after each write."""
    jcache, tcache = _cache_pair(2, (6, 8, 3), [[1, 2, 3], [4, 5, 0]], fused)
    rng = np.random.default_rng(0)
    S = POS = JA.POS_SENTINEL
    writes = [
        (5, np.stack([np.arange(5), np.full(5, S)]), 1.0),
        (6, np.stack([np.arange(5, 11),
                      np.concatenate([np.arange(3), [S] * 3])]), 0.5),
        (1, np.asarray([[11], [3]]), 20.0),               # growth
        (1, np.asarray([[12], [4]]), 0.1),
        (2, np.asarray([[13, 14], [POS, POS]]), 0.3),
        (1, np.asarray([[40], [5]]), 0.2),                # past the table
    ]
    grew = []
    for n, pos, scale in writes:
        k = (rng.normal(size=(2, n, 2, 8)) * scale).astype(np.float32)
        v = (rng.normal(size=(2, n, 2, 8)) * scale).astype(np.float32)
        before = np.asarray(jcache["k_amax"]).copy()
        jcache = JA._update_paged_cache(jcache, jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(pos))
        tcache = TA._update_paged_cache(tcache, _t(k), _t(v), _t(pos))
        _assert_same_cache(tcache, jcache)
        grew.append(bool((np.asarray(jcache["k_amax"]) > before).any()))
    assert grew[2] and not grew[3] and not all(grew)
    jv = JA.gather_paged_view(jcache, jnp.asarray([True, False]))
    tv = TA.gather_paged_view(tcache, torch.tensor([True, False]))
    for got, want in zip(tv, jv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_write_recycled_block():
    """A block recycled from one request to another: the new owner's
    writes start at bit 0 and leave no trace of the old content."""
    jcache, tcache = _cache_pair(1, (4, 8, 2), [[1, 2]])
    rng = np.random.default_rng(1)
    k = rng.normal(size=(1, 12, 2, 8)).astype(np.float32)
    pos = np.arange(12)[None]
    jcache = JA._update_paged_cache(jcache, jnp.asarray(k), jnp.asarray(k),
                                    jnp.asarray(pos))
    tcache = TA._update_paged_cache(tcache, _t(k), _t(k), _t(pos))
    jcache = dict(jcache, table=jnp.asarray([[2, 1]], jnp.int32),
                  length=jnp.zeros((1,), jnp.int32))
    tcache = dict(tcache, table=_t(np.asarray([[2, 1]], np.int32)),
                  length=torch.zeros(1, dtype=torch.int32))
    k2 = (rng.normal(size=(1, 10, 2, 8)) * 0.5).astype(np.float32)
    jcache = JA._update_paged_cache(jcache, jnp.asarray(k2), jnp.asarray(k2),
                                    jnp.asarray(np.arange(10)[None]))
    tcache = TA._update_paged_cache(tcache, _t(k2), _t(k2),
                                    _t(np.arange(10)[None]))
    _assert_same_cache(tcache, jcache)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(_tree_np(jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def test_registry_mirrors_reference():
    from repro.configs import get_config as jget
    from repro.configs.registry import list_archs
    for name in list_archs():
        got = get_config(name)
        want = jget(name)
        for field in ("d_model", "vocab", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "qkv_bias", "act", "norm",
                      "tie_embeddings", "window", "n_layers"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    full = get_config("stablelm-1.6b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (24, 2048, 32, 32, 64,
                                                      5632, 100352)
    assert full.norm == "ln" and full.qkv_bias and not full.tie_embeddings


def test_init_model_shapes_match_reference(model):
    jcfg, tcfg, jparams, _ = model
    own = TT.init_model(tcfg, torch.Generator().manual_seed(0))
    ref = TT.params_from_numpy(_tree_np(jparams), tcfg)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(own) == shapes(ref)


def test_forward_logits_match_reference(model):
    """Cache-free forward with the BitStopper score path: logits within
    1e-3.  f32 matmuls summed in another order differ by ulps, and an ulp
    can move one INT12-quantized value across a rounding boundary; that
    shifts a score by one quantization step and the change propagates to
    later positions (measured: 1e-6 before the first such flip, under 2e-4
    after)."""
    jcfg, tcfg, jparams, tparams = model
    tokens = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(
        np.int32)
    want, _, _ = JT.forward(jparams, jnp.asarray(tokens), jcfg)
    got, _, _ = TT.forward(tparams, _t(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3)


def test_paged_prefill_and_decode_forward_match_reference(model):
    """Prefill chunks (one slot each, as the engine runs them) and a decode
    step of both slots through paged caches: logits within 1e-3 (the
    reason is in the test above); positions, tables and fill levels equal;
    K/V pools and scales within 1e-3 (deeper layers' K/V carry the same
    quantization-step differences).  The bridge maps the per-layer caches back to
    the reference's stacked layout and round-trips it exactly."""
    from repro.serving.engine import _attach_tables as jattach
    from repro_torch.serving.engine import _attach_tables as tattach
    jcfg, tcfg, jparams, tparams = model
    jcfg = jcfg.replace(fused_decode=True)
    tcfg = tcfg.replace(fused_decode=True)
    layout = (9, 8, 4)
    jcaches = JT.init_caches(jcfg, 2, 32, paged=JA.PagedLayout(*layout))
    tcaches = TT.init_caches(tcfg, 2, paged=TA.PagedLayout(*layout))
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    S = JA.POS_SENTINEL
    rng = np.random.default_rng(4)
    steps = [  # rows, tokens, positions, fill levels before the write
        (slice(0, 1), rng.integers(0, 256, (1, 16)), np.arange(16)[None],
         [0]),
        (slice(1, 2), rng.integers(0, 256, (1, 16)),
         np.r_[np.arange(11), [S] * 5][None], [0]),
        (slice(0, 2), rng.integers(0, 256, (2, 1)), np.array([[16], [11]]),
         [16, 11]),
    ]
    for rows, tokens, pos, length in steps:
        tokens, pos = tokens.astype(np.int32), pos.astype(np.int32)
        length = np.asarray(length, np.int32)
        jc = jattach(jcaches, table[rows], length)
        tc = tattach(tcaches, _t(table[rows]), _t(length))
        want, jcaches, _ = JT.forward(jparams, jnp.asarray(tokens), jcfg,
                                      caches=jc, positions=jnp.asarray(pos))
        got, tcaches, _ = TT.forward(tparams, _t(tokens), tcfg, caches=tc,
                                     positions=_t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                   rtol=1e-3)
        back = TT.caches_to_numpy(tcaches, tcfg)["seg0"]["b0"]
        ref = _tree_np(jcaches)["seg0"]["b0"]
        for key in ("pos", "table", "length"):
            np.testing.assert_array_equal(back[key], ref[key])
        for key in ("k", "v", "k_amax", "v_amax"):
            np.testing.assert_allclose(back[key], ref[key], atol=1e-3,
                                       rtol=1e-3)
    ref = _tree_np(jcaches)
    again = TT.caches_to_numpy(TT.caches_from_numpy(ref, tcfg), tcfg)
    for key, leaf in ref["seg0"]["b0"].items():
        np.testing.assert_array_equal(again["seg0"]["b0"][key], leaf)
