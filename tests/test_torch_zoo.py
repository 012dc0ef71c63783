"""The port's model zoo held against the reference on the CPU, with the
same seeded weights in both: cache-free logits of all 11 registry
architectures (reduced configs); single-token cached decode of the MLA
(``xla`` and ``bitstopper_xla``), SSM and RG-LRU mixers, step by step
against the reference's and at the end against the cache-free forward;
the MTP head and ``forward(embeds=)`` with the frontend stubs; and C8: a
multi-token call on an SSM or RG-LRU cache, which the reference answers
wrongly and the port refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.configs import reduced_config as jreduced
from repro.models import frontend as JF
from repro.models import transformer as JT
from repro_torch.configs import reduced_config
from repro_torch.models import frontend as TF
from repro_torch.models import transformer as TT
from repro_torch.serving import Request, ServeConfig, StaticBucketEngine
from _torch_threads import one_thread  # noqa: F401

_PARAMS = {}
_FORWARDS = {}


def _ref_layout(tree, cfg):
    """The port's parameters as the reference's pytree (numpy leaves):
    segments the reference scans are stacked along a leading axis."""
    out = {}
    for key, val in tree.items():
        if key.startswith("seg"):
            reps = cfg.segments[int(key[3:])][1]
            units = jax.tree.map(lambda t: t.numpy(), val)
            out[key] = (jax.tree.map(lambda *xs: np.stack(xs), *units)
                        if cfg.scan_layers and reps > 1 else units)
        else:
            out[key] = jax.tree.map(lambda t: t.numpy(), val)
    return out


def _model(arch, **kw):
    """(reference cfg, port cfg, reference params, port params): the port
    draws each arch's parameters once (seeded) and the reference gets the
    same values in its layout."""
    tcfg = reduced_config(arch).replace(**kw)
    if arch not in _PARAMS:
        tparams = TT.init_model(tcfg, torch.Generator().manual_seed(0))
        _PARAMS[arch] = (tparams, jax.tree.map(
            jnp.asarray, _ref_layout(tparams, tcfg)))
    tparams, jparams = _PARAMS[arch]
    return jreduced(arch).replace(**kw), tcfg, jparams, tparams


def _jforward(jcfg):
    """The reference's forward, jitted once per config (its eager scans
    re-trace on every call)."""
    if jcfg not in _FORWARDS:
        _FORWARDS[jcfg] = jax.jit(
            lambda p, t, c, pos: JT.forward(p, t, jcfg, caches=c,
                                            positions=pos))
    return _FORWARDS[jcfg]


def _tokens(cfg, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, S)).astype(
        np.int32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("arch", list_archs())
def test_cache_free_logits_match_reference(arch):
    """Every block kind of the registry (attn, local_attn, mla, ssm and
    rglru mixers; dense and MoE FFNs): logits within 1e-4 of the largest
    (f32 sums in another order), the aux loss within 1e-5."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = _tokens(jcfg)
    want, _, jaux = _jforward(jcfg)(jparams, jnp.asarray(tokens), None,
                                    jnp.arange(16))
    got, _, taux = TT.forward(tparams, _t(tokens), tcfg)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 16, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-9)


_DECODE = [("deepseek-v3-671b", "xla"), ("deepseek-v3-671b",
                                         "bitstopper_xla"),
           ("mamba2-130m", "xla"), ("recurrentgemma-2b", "xla")]


@pytest.mark.parametrize("arch,impl", _DECODE)
def test_single_token_decode_matches_reference(arch, impl):
    """12 single-token steps on the contiguous caches (the reference's
    test_decode_smoke): each step's logits within 1e-4 of the largest of
    the reference's (1e-3 on ``bitstopper_xla``, where an ulp can move an
    INT12 value across a rounding boundary: test_torch_model.py), every
    cache leaf within 1e-4 (the cursor exactly), and on the dense paths the
    last logits within the reference's 2e-3 of the port's cache-free
    forward (BitStopper decode prunes keys the dense forward keeps)."""
    tol = 1e-3 if impl == "bitstopper_xla" else 1e-4
    jcfg, tcfg, jparams, tparams = _model(arch, attn_impl=impl)
    tokens = _tokens(jcfg, 12, seed=1)
    jc = JT.init_caches(jcfg, 2, 32)
    tc = TT.init_caches(tcfg, 2, 32)
    for t in range(12):
        jl, jc, _ = _jforward(jcfg)(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                    jc, jnp.arange(t, t + 1))
        tl, tc, _ = TT.forward(tparams, _t(tokens[:, t:t + 1]), tcfg,
                               caches=tc, positions=torch.arange(t, t + 1))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl,
                                   atol=tol * np.abs(jl).max(), rtol=0,
                                   err_msg=str(t))
    got = jax.tree.leaves(TT.caches_to_numpy(tc, tcfg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jc))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        else:
            np.testing.assert_array_equal(g, w)
    if impl == "xla":
        full, _, _ = TT.forward(tparams, _t(tokens), tcfg)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, 11].numpy(),
                                   atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_multi_token_recurrent_cache_c8(arch):
    """ROADMAP C8: 8 tokens in one call on an SSM / RG-LRU cache.  The
    reference returns logits far from its cache-free forward's (it rolls
    the conv window by 8 but convolves and updates the state once); the
    port raises ValueError, and so its static engine refuses such a model
    at prefill."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = _tokens(jcfg, 8, seed=2)
    want, _, _ = _jforward(jcfg)(jparams, jnp.asarray(tokens), None,
                                 jnp.arange(8))
    wrong, _, _ = _jforward(jcfg)(jparams, jnp.asarray(tokens),
                                  JT.init_caches(jcfg, 2, 32),
                                  jnp.arange(8))
    gap = float(jnp.abs(wrong[:, -1] - want[:, -1]).max())
    assert gap > 1.0, gap
    with pytest.raises(ValueError, match="C8"):
        TT.forward(tparams, _t(tokens), tcfg,
                   caches=TT.init_caches(tcfg, 2, 32),
                   positions=torch.arange(8))
    eng = StaticBucketEngine(tcfg, tparams, ServeConfig(max_len=32),
                             device="cpu")
    with pytest.raises(ValueError, match="C8"):
        eng.generate([Request(prompt=tokens[0], max_new_tokens=2)])


def test_static_engine_serves_mla_like_reference():
    """The static engine prefills an MLA model's prompt in one call on its
    latent cache, as the reference's does: the same greedy tokens."""
    from repro.serving import Request as JRequest
    from repro.serving import ServeConfig as JServe
    from repro.serving.engine import StaticBucketEngine as JStatic
    jcfg, tcfg, jparams, tparams = _model("deepseek-v3-671b")
    prompts = [_tokens(jcfg, 8, seed=s)[0] for s in (3, 4)]
    jreqs = [JRequest(prompt=p.copy(), max_new_tokens=4) for p in prompts]
    treqs = [Request(prompt=p.copy(), max_new_tokens=4) for p in prompts]
    JStatic(jcfg, jparams, JServe(max_len=32)).generate(jreqs)
    StaticBucketEngine(tcfg, tparams, ServeConfig(max_len=32),
                       device="cpu").generate(treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


def test_mtp_logits_match_reference():
    """DeepSeek's MTP head over the trunk's hidden states."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jcfg, tcfg, jparams, tparams = _model("deepseek-v3-671b")
    assert tcfg.mtp and "mtp_block" in tparams
    tokens = _tokens(jcfg)
    pos = np.arange(16)

    @jax.jit
    def ref(p, toks):
        jh, _, _ = JT.run_segments(p, JL.embed(p["embed"], toks),
                                   jnp.asarray(pos), jcfg)
        return JT.mtp_logits(p, toks, jh, jcfg, jnp.asarray(pos))

    want = ref(jparams, jnp.asarray(tokens))
    th, _, _ = TT.run_segments(tparams, TL.embed(tparams["embed"],
                                                 _t(tokens)), _t(pos), tcfg)
    got = TT.mtp_logits(tparams, _t(tokens), th, tcfg, _t(pos))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    own = TT.init_model(tcfg, torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(own) == shapes(tparams)


@pytest.mark.parametrize("arch", ["llava-next-34b", "musicgen-medium"])
def test_frontend_embeds_match_reference(arch):
    """The frontend stubs and ``forward(embeds=)``: precomputed patch
    embeddings prepended to the text (vision), EnCodec codes through the
    embedding table (audio)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = _tokens(jcfg)
    if jcfg.frontend == "vision":
        patches = np.random.default_rng(5).normal(
            size=(2, 4, jcfg.d_model)).astype(np.float32)
        jemb = JF.vision_frontend(jparams, jnp.asarray(tokens),
                                  jnp.asarray(patches), jcfg)
        temb = TF.vision_frontend(tparams, _t(tokens), _t(patches), tcfg)
    else:
        jemb = JF.audio_frontend(jparams, jnp.asarray(tokens), jcfg)
        temb = TF.audio_frontend(tparams, _t(tokens), tcfg)
    np.testing.assert_array_equal(temb.numpy(), np.asarray(jemb))
    want, _, _ = JT.forward(jparams, jnp.asarray(tokens), jcfg, embeds=jemb)
    got, _, _ = TT.forward(tparams, None, tcfg, embeds=temb)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
