"""Training's pieces held against the JAX package on the CPU: the data
pipeline, AdamW with clipping and the cosine schedule, the chunked
attention's manual backward, the remat policies, the losses and their
gradients on reduced configs, and int8 gradient compression with error
feedback.  Parameters are drawn by the port's seeded init and
handed to the reference in its stacked layout (``params_to_numpy``)."""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.configs import reduced_config as jreduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models import attention as JA
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of each leaf's max |g|
# The reference's functions are compiled without LLVM's costly passes:
# half the compile time, values an ulp or so from the default build's.
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def jax_compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` under FAST_XLA."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(x):
    return x.detach().cpu().numpy()


def _flat(tree):
    """{path: numpy leaf} of a reference-layout pytree."""
    return {jtu.keystr(k): np.asarray(v)
            for k, v in jtu.tree_leaves_with_path(tree)}


def _assert_grads_close(tgrads, jgrads, cfg, tol=GRAD_TOL):
    got = _flat(TT.params_to_numpy(tgrads, cfg))
    want = _flat(jgrads)
    assert got.keys() == want.keys()
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[key] - w).max())
        assert err <= tol * scale, (key, err, scale)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_data_batches_shards_and_prefetch_match_reference():
    """Batches equal to the reference's; shards tile the global batch; the
    prefetch thread yields batch_at(step)."""
    kw = dict(vocab=300, seq_len=48, global_batch=8, seed=5)
    port, ref = (SyntheticLMDataset(DataConfig(**kw)),
                 JDataset(JDataConfig(**kw)))
    for step in (0, 3, 17):
        np.testing.assert_array_equal(port.batch_at(step), ref.batch_at(step))
    full = port.batch_at(3)
    shards = [SyntheticLMDataset(DataConfig(**kw), shard=i, num_shards=4)
              for i in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([s.batch_at(3) for s in shards]), full)
    np.testing.assert_array_equal(
        shards[2].batch_at(3),
        JDataset(JDataConfig(**kw), shard=2, num_shards=4).batch_at(3))
    port.start_prefetch(start_step=5)
    got = [port.next_batch() for _ in range(2)]
    port.stop()
    assert [s for s, _ in got] == [5, 6]
    for s, batch in got:
        np.testing.assert_array_equal(batch, ref.batch_at(s))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(6, 5)).astype(np.float32),
            "seg": [{"w": rng.normal(size=(4,)).astype(np.float32)},
                    {"w": rng.normal(size=(4,)).astype(np.float32)}]}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 1e9])
def test_adamw_update_matches_reference(moment_dtype, grad_clip):
    """Three updates on identical carried-over grads: parameters and
    moments within 1e-6 absolute, ``step`` exact, the grad norm and lr
    within 1e-6 relative; clipping and the cosine schedule alone too."""
    cfg = dict(lr=0.05, weight_decay=0.1, grad_clip=grad_clip,
               moment_dtype=moment_dtype)
    tcfg, jcfg = TO.AdamWConfig(**cfg), JO.AdamWConfig(**cfg)
    p0 = _opt_tree(0)
    tp = TO.tree_map(_t, p0)
    jp = jax.tree.map(jnp.asarray, p0)
    ts, js = TO.init_opt_state(tp, tcfg), JO.init_opt_state(jp, jcfg)
    for i in range(3):
        g = _opt_tree(10 + i)
        lr_t = TO.cosine_schedule(ts["step"], warmup=1, total=4)
        lr_j = JO.cosine_schedule(js["step"], warmup=1, total=4)
        assert abs(float(lr_t) - float(lr_j)) <= 1e-6 * abs(float(lr_j))
        tp, ts, tm = TO.adamw_update(tp, TO.tree_map(_t, g), ts, tcfg, lr_t)
        jp, js, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                     jcfg, lr_j)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                1e-6 * abs(float(jm[key]))
        for t_tree, j_tree in ((tp, jp), (ts["m"], js["m"]),
                               (ts["v"], js["v"])):
            for a, b in zip(TO.tree_leaves(t_tree),
                            jax.tree.leaves(j_tree)):
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           atol=1e-6, rtol=0)
    g = _opt_tree(20)
    tc, tn = TO.clip_by_global_norm(TO.tree_map(_t, g), 0.5)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for a, b in zip(TO.tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    for s in (0, 5, 10, 55, 100, 200):
        a = float(TO.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                     warmup=10, total=100))
        b = float(JO.cosine_schedule(jnp.int32(s), warmup=10, total=100))
        assert abs(a - b) <= 1e-6 * max(abs(b), 1e-6)


# ---------------------------------------------------------------------------
# The chunked attention's manual backward
# ---------------------------------------------------------------------------

_ATTN = {
    "causal": dict(Sq=32, Hq=4, Hkv=4, causal=True, window=None, chunk=16),
    "windowed": dict(Sq=32, Hq=4, Hkv=4, causal=True, window=8, chunk=8),
    "gqa": dict(Sq=32, Hq=8, Hkv=2, causal=True, window=None, chunk=16),
    "ragged": dict(Sq=27, Hq=4, Hkv=2, causal=True, window=6, chunk=8),
    "noncausal": dict(Sq=20, Hq=4, Hkv=1, causal=False, window=None,
                      chunk=8),
}


@pytest.mark.parametrize("case", list(_ATTN))
def test_chunked_attention_backward(case):
    """dq, dk, dv of the manual backward against the reference's
    ``custom_vjp`` and against autograd through the plain forward (dk and
    dv at the KV heads, pad rows dropped): within 1e-5 of each one's max."""
    c = _ATTN[case]
    rng = np.random.default_rng(7)
    B, D, S = 2, 16, c["Sq"]
    q = rng.normal(size=(B, S, c["Hq"], D)).astype(np.float32)
    k = rng.normal(size=(B, S, c["Hkv"], D)).astype(np.float32)
    v = rng.normal(size=(B, S, c["Hkv"], D)).astype(np.float32)
    w = rng.normal(size=(B, S, c["Hq"], D)).astype(np.float32)
    pos = np.arange(S)
    geo = dict(causal=c["causal"], window=c["window"], chunk_q=c["chunk"],
               chunk_k=c["chunk"])

    def jloss(q, k, v):
        out = JA.chunked_attention(q, k, v, jnp.asarray(pos),
                                   jnp.asarray(pos), **geo)
        return jnp.sum(out * jnp.asarray(w))

    jqkv = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = jax_compiled(jax.grad(jloss, argnums=(0, 1, 2)), *jqkv)(*jqkv)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = TA.chunked_attention(tq, tk, tv, _t(pos), _t(pos), **geo)
    got = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))

    # Autograd through the plain forward (no custom backward).
    pq, pk, pv = (_t(x).requires_grad_(True) for x in (q, k, v))
    G = c["Hq"] // c["Hkv"]
    cq = min(c["chunk"], S)
    pad = (-S) % cq
    F = torch.nn.functional
    qp = F.pad(pq, (0, 0, 0, 0, 0, pad))
    kp, vp = F.pad(pk, (0, 0, 0, 0, 0, pad)), F.pad(pv, (0, 0, 0, 0, 0, pad))
    qpos = F.pad(_t(pos), (0, pad), value=-1)
    kpos = F.pad(_t(pos), (0, pad), value=TA.POS_SENTINEL)
    plain, _ = TA._chunked_fwd(qp.reshape(B, S + pad, c["Hkv"], G, D), kp,
                               vp, qpos, kpos, c["causal"], c["window"], cq,
                               cq)
    plain = plain.reshape(B, S + pad, c["Hq"], D)[:, :S]
    auto = torch.autograd.grad((plain * _t(w)).sum(), (pq, pk, pv))
    np.testing.assert_array_equal(_n(out), _n(plain))
    for g, a, j in zip(got, auto, want):
        j = np.asarray(j)
        assert g.shape == j.shape
        for ref in (j, _n(a)):
            np.testing.assert_allclose(_n(g), ref,
                                       atol=1e-5 * np.abs(ref).max(), rtol=0)


# ---------------------------------------------------------------------------
# Losses and gradients against the reference
# ---------------------------------------------------------------------------

_MODELS = {}
_GRADS = {}


def _model(arch, **kw):
    tcfg = reduced_config(arch).replace(**kw)
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        tparams = TS.trainable(TT.init_model(
            tcfg, torch.Generator().manual_seed(0)))
        _MODELS[key] = (tparams, jax.tree.map(
            jnp.asarray, TT.params_to_numpy(tparams, tcfg)))
    tparams, jparams = _MODELS[key]
    return jreduced(arch).replace(**kw), tcfg, jparams, tparams


def _batch(cfg, B=2, S=24, seed=0, patches=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if not patches:
        return tokens
    return {"tokens": tokens, "patches": rng.normal(
        size=(B, patches, cfg.d_model)).astype(np.float32)}


def _conv(batch, fn):
    return ({k: fn(v) for k, v in batch.items()} if isinstance(batch, dict)
            else fn(batch))


def _jgrads(jcfg, jparams, batch):
    jbatch = _conv(batch, jnp.asarray)
    if jcfg not in _GRADS:
        _GRADS[jcfg] = jax_compiled(jax.value_and_grad(
            lambda p, b: JS.loss_fn(p, b, jcfg, JS.TrainConfig())),
            jparams, jbatch)
    return _GRADS[jcfg](jparams, jbatch)


_LOSS_ARCHS = ["stablelm-1.6b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
               "mamba2-130m", "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", _LOSS_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` within 1e-5 relative and every gradient leaf within
    1e-4 of its max |g| of ``jax.grad``: the MoE aux loss (qwen2-moe), MLA
    and MTP at t+2 (deepseek-v3), the SSD chunks (mamba2), RG-LRU and
    windowed attention (recurrentgemma)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    batch = _batch(tcfg)
    jl, jg = _jgrads(jcfg, jparams, batch)
    tl, tg = TS.value_and_grad(tparams, _conv(batch, _t), tcfg,
                                TS.TrainConfig())
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _assert_grads_close(tg, jg, tcfg)


def test_lm_losses_match_reference():
    """``lm_loss`` and ``chunked_lm_loss`` (chunks of 8 over 20 positions,
    the last chunk padded; an untied head at shift 2, the MTP target, and a
    tied one at shift 1) within 1e-5 relative."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 20, 64)).astype(np.float32) * 3
    tokens = rng.integers(0, 64, (2, 20)).astype(np.int32)
    for ignore_last in (True, False):
        a = float(TS.lm_loss(_t(logits), _t(tokens), ignore_last))
        b = float(JS.lm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                             ignore_last))
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    for arch, shift in (("stablelm-1.6b", 2), ("paper-opt1.3b", 1)):
        jcfg, tcfg, jparams, tparams = _model(arch)
        h = rng.normal(size=(2, 20, tcfg.d_model)).astype(np.float32)
        tok = rng.integers(0, tcfg.vocab, (2, 20)).astype(np.int32)
        with torch.no_grad():
            a = float(TS.chunked_lm_loss(_t(h), tparams, _t(tok), tcfg,
                                         chunk=8, shift=shift))
        b = float(JS.chunked_lm_loss(jnp.asarray(h), jparams,
                                     jnp.asarray(tok), jcfg, chunk=8,
                                     shift=shift))
        assert abs(a - b) <= LOSS_RTOL * abs(b)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b",
                                  "mamba2-130m"])
def test_remat_policies_give_equal_grads(arch):
    """"none", "full" and "dots" give the same loss and gradients, bit for
    bit (recomputation repeats the same operations)."""
    _, tcfg, _, tparams = _model(arch)
    batch = _t(_batch(tcfg))
    runs = [TS.value_and_grad(tparams, batch, tcfg.replace(remat=r),
                               TS.TrainConfig())
            for r in ("none", "full", "dots")]
    for loss, grads in runs[1:]:
        assert float(loss) == float(runs[0][0])
        for a, b in zip(TO.tree_leaves(grads), TO.tree_leaves(runs[0][1])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TS.value_and_grad(tparams, batch, tcfg.replace(remat="other"),
                           TS.TrainConfig())


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_trains(arch):
    """Finite loss, finite gradients on every leaf and at least one nonzero
    (the reference's test_train_step_smoke), for every registry arch."""
    _, tcfg, _, tparams = _model(arch)
    batch = _batch(tcfg, B=2, S=16,
                   patches=4 if tcfg.frontend == "vision" else 0)
    loss, grads = TS.value_and_grad(tparams, _conv(batch, _t), tcfg,
                                     TS.TrainConfig())
    leaves = TO.tree_leaves(grads)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in leaves)
    assert any(float(g.abs().max()) > 0 for g in leaves)


def test_int8_compression_matches_reference():
    """``_compress_int8``, ``compress_grads`` and ``decompress_grads``:
    int8 values, scales and residuals equal to the reference's; and the
    reference's error-feedback property (test_properties.py): the mean of
    8 delivered gradients within 2e-2 of the true one."""
    rng = np.random.default_rng(4)
    grads = {"a": rng.normal(size=(64,)).astype(np.float32),
             "b": [rng.normal(size=(3, 5)).astype(np.float32)]}
    err = {"a": (rng.normal(size=(64,)) * 1e-3).astype(np.float32),
           "b": [np.zeros((3, 5), np.float32)]}
    tq, ts, te = TS.compress_grads(TO.tree_map(_t, grads),
                                   TO.tree_map(_t, err))
    jq, js, je = JS.compress_grads(jax.tree.map(jnp.asarray, grads),
                                   jax.tree.map(jnp.asarray, err))
    for a, b in zip(TO.tree_leaves(tq), jax.tree.leaves(jq)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(TO.tree_leaves(ts), jax.tree.leaves(js)):
        assert float(a) == float(b)
    for a, b in zip(TO.tree_leaves(te), jax.tree.leaves(je)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(TO.tree_leaves(TS.decompress_grads(tq, ts)),
                    jax.tree.leaves(JS.decompress_grads(jq, js))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for seed in range(3):
        g_true = np.random.default_rng(seed).normal(size=(64,)).astype(
            np.float32)
        e = torch.zeros(64)
        delivered = np.zeros(64)
        for _ in range(8):
            q, scale, e = TS._compress_int8(_t(g_true), e)
            delivered += q.numpy().astype(np.float32) * float(scale)
        np.testing.assert_allclose(delivered / 8, g_true, atol=2e-2)
    with pytest.raises(NotImplementedError, match="mesh training"):
        TS.allreduce_int8_ef(grads, err, mesh=None)


def test_train_config_mirrors_reference():
    assert dataclasses.asdict(TS.TrainConfig()) == \
        dataclasses.asdict(JS.TrainConfig())
