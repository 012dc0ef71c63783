"""The port's speculative decoding held against the reference on the CPU:
drafter proposals, a tick-by-tick lockstep of the two PagedEngines with the
n-gram and draft-model drafters (reduced stablelm-1.6b, the reference's
weights carried across), the undo of a draft-block write on the growth
bailout, and the port's own losslessness: speculative traces equal
non-speculative ones."""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving import DraftModelDrafter as JDraftModelDrafter
from repro.serving import NGramDrafter as JNGramDrafter
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import (DraftModelDrafter, NGramDrafter,
                                 PagedEngine, Request, ServeConfig,
                                 make_drafter)
from repro_torch.serving.engine import _layers
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _scfg(**kw):
    """The reference's tests/test_speculative.py geometry."""
    return ServeConfig(max_len=kw.pop("max_len", 64),
                       max_slots=kw.pop("max_slots", 2),
                       prefill_bucket=kw.pop("prefill_bucket", 8),
                       page_size=kw.pop("page_size", 8), **kw)


def _prompts(lens, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, L, dtype=np.int32) for L in lens]
    return out if prefix is None else [np.concatenate([prefix, p])
                                       for p in out]


def _serve(tcfg, tparams, prompts, max_new, drafter=None, **kw):
    eng = PagedEngine(tcfg, tparams, _scfg(**kw), device="cpu",
                      drafter=drafter)
    reqs = [Request(prompt=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    eng.generate(reqs)
    return eng, [r.generated for r in reqs]


class _GarbageDrafter:
    """Always proposes k wrong tokens, so every tick claims draft-tail
    blocks and rolls them back."""

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, context, k):
        return [(int(context[-1]) + 1 + i) % self.vocab for i in range(k)]


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(0)
    contexts = [np.asarray(c, np.int32) for c in (
        [7, 1, 2, 3, 9, 1, 2, 3], [5, 9, 5], np.arange(10), [4], [3, 3, 3])]
    contexts += [rng.integers(0, 6, n).astype(np.int32) for n in (9, 17, 40)]
    for args in ((3, 1), (2, 2), (4, 1)):
        mine, ref = NGramDrafter(*args), JNGramDrafter(*args)
        for ctx in contexts:
            for k in (1, 3, 5):
                assert mine.propose(ctx, k) == ref.propose(ctx, k)
    assert NGramDrafter().propose(
        np.asarray([7, 1, 2, 3, 9, 1, 2, 3]), 3) == [9, 1, 2]
    with pytest.raises(ValueError):
        NGramDrafter(max_n=1, min_n=2)


def test_draft_model_drafter_matches_reference(model):
    """Self-draft proposals equal the reference's and the port's own greedy
    continuation (cache-free forward), across context length buckets."""
    jcfg, tcfg, jparams, tparams = model
    mine = DraftModelDrafter(tcfg, tparams, bucket=8)
    ref = JDraftModelDrafter(jcfg, jparams, bucket=8)
    rng = np.random.default_rng(0)
    for n in (5, 11, 16):
        ctx = rng.integers(0, tcfg.vocab, n, dtype=np.int32)
        got = mine.propose(ctx, 3)
        assert got == ref.propose(ctx, 3)
        seq = list(ctx)
        for _ in range(3):
            logits, _, _ = TT.forward(tparams, torch.tensor([seq]), tcfg)
            seq.append(int(torch.argmax(logits[0, -1])))
        assert got == seq[n:]


# ---------------------------------------------------------------------------
# the growth bailout's undo, against the reference's immutable caches
# ---------------------------------------------------------------------------


def _np_cache(cache):
    return {k: np.asarray(v) for k, v in cache.items() if k != "undo"}


@pytest.mark.parametrize("scale", [20.0, 0.1])
def test_verify_write_and_undo_match_reference_bitwise(scale):
    """A draft-block write through two tables (crossing a page, a padding
    query, a dropped write past the table) equals the reference's write in
    every leaf; undoing it gives back the reference's cache before the
    write, bit for bit, whether the write grew the scales and requantized
    the whole plane pool (scale 20) or merged its bits (scale 0.1)."""
    kw = dict(d_model=16, n_heads=2, n_kv_heads=2, head_dim=8,
              impl="bitstopper_xla", fused_decode=True)
    layout = (6, 8, 3)
    table = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    jcache = dict(JA.init_cache(JA.AttnConfig(**kw), batch=2, max_len=64,
                                paged=JA.PagedLayout(*layout)),
                  table=jnp.asarray(table))
    tcache = dict(TA.init_cache(TA.AttnConfig(**kw), 2,
                                paged=TA.PagedLayout(*layout)),
                  table=torch.as_tensor(table))
    rng = np.random.default_rng(0)
    S = JA.POS_SENTINEL
    prefill = np.stack([np.arange(6), np.r_[np.arange(3), [S] * 3]])
    draft = np.array([[6, 7, 8, 9], [3, 4, S, S]], np.int32)
    for pos, sc in ((prefill, 1.0), (draft, scale)):
        k = (rng.normal(size=(2, pos.shape[1], 2, 8)) * sc).astype(np.float32)
        v = (rng.normal(size=(2, pos.shape[1], 2, 8)) * sc).astype(np.float32)
        jnew = JA._update_paged_cache(jcache, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos.astype(np.int32)))
        if pos is prefill:
            jcache = jnew
            tcache = TA._update_paged_cache(tcache, torch.as_tensor(k),
                                            torch.as_tensor(v),
                                            torch.as_tensor(pos))
            continue
        before = _np_cache(jcache)
        tc = dict(tcache, undo=[])
        tnew = TA._update_paged_cache(tc, torch.as_tensor(k),
                                      torch.as_tensor(v),
                                      torch.as_tensor(pos))
        want = _np_cache(jnew)
        for key, got in _np_cache(tnew).items():
            np.testing.assert_array_equal(got, want[key], err_msg=key)
        grew = bool((want["k_amax"] > before["k_amax"]).any())
        assert grew == (scale > 1) == ("kq" in tc["undo"][0])
        for record in reversed(tc["undo"]):
            TA.undo_paged_write(tc, record)
        for key, got in _np_cache(tcache).items():
            np.testing.assert_array_equal(got, before[key], err_msg=key)


# ---------------------------------------------------------------------------
# lockstep with the reference engine
# ---------------------------------------------------------------------------


_KW = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8)


def _cache_tree(caches):
    return {f"{seg}.{i}.{b}.{key}": np.asarray(val)
            for seg, units in caches.items() for i, unit in enumerate(
                units if isinstance(units, list) else [units])
            for b, layer in unit.items() for key, val in layer.items()}


@pytest.mark.parametrize("speculative,fused", [("ngram", False),
                                               ("draft", True)])
def test_engine_lockstep_with_reference(model, speculative, fused):
    """The reference's trace (lengths 5, 11, 17; 6 new tokens; draft_k 3;
    for the n-gram drafter also a prompt that repeats a pattern, so it
    proposes) through both engines one tick at a time: token streams,
    tables, fill levels and allocator state equal after every tick.  At a
    growth bailout the port's undone caches equal its caches before the
    verify write in every leaf, and the reference's after its bailout:
    integer leaves exactly, f32 K/V and scales within 1e-3 (the model's
    matmuls differ by ulps between the frameworks,
    test_torch_model.py::test_paged_prefill_and_decode_forward_match_reference)."""
    jcfg, tcfg, jparams, tparams = model
    jeng = JEngine(jcfg, jparams, JServe(fused_decode=False,
                                         speculative=speculative, draft_k=3,
                                         **_KW))
    teng = PagedEngine(tcfg, tparams, ServeConfig(
        fused_decode=fused, speculative=speculative, draft_k=3, **_KW),
        device="cpu")
    prompts = _prompts((5, 11, 17))
    if speculative == "ngram":
        prompts.append(np.tile(_prompts((4,), seed=7)[0], 5))
    jreqs = [jeng.submit(JRequest(prompt=p.copy(), max_new_tokens=6))
             for p in prompts]
    treqs = [teng.submit(Request(prompt=p.copy(), max_new_tokens=6))
             for p in prompts]
    seen = {"pre": None, "bailouts": 0}
    verify, plain = teng._verify_forward, teng._plain_decode_tick
    jplain = jeng._plain_decode_tick

    def spy_verify(*a):
        seen["pre"] = TT.caches_to_numpy(teng.caches, tcfg)
        return verify(*a)

    def spy_plain(active):
        if seen["pre"] is not None:          # right after a bailout
            undone = TT.caches_to_numpy(teng.caches, tcfg)
            seen["port"] = _cache_tree(undone)
            for key, val in _cache_tree(seen["pre"]).items():
                np.testing.assert_array_equal(seen["port"][key], val,
                                              err_msg=key)
            seen["bailouts"] += 1
        seen["pre"] = None
        return plain(active)

    def spy_jplain(active):
        if "port" in seen:
            ref = _cache_tree(jax.tree.map(np.asarray, jeng.caches))
            for key, val in ref.items():
                got = seen["port"][key]
                if val.dtype.kind == "f":
                    np.testing.assert_allclose(got, val, atol=1e-3,
                                               rtol=1e-3, err_msg=key)
                else:
                    np.testing.assert_array_equal(got, val, err_msg=key)
            del seen["port"]
        return jplain(active)

    teng._verify_forward = spy_verify
    teng._plain_decode_tick = spy_plain
    jeng._plain_decode_tick = spy_jplain
    jeng.begin(0)
    ticks = 0
    while jeng.pending() or teng.pending():
        teng.step()
        seen["pre"] = None
        jeng.step()
        ticks += 1
        assert teng.pool.snapshot() == jeng.pool.snapshot(), ticks
        np.testing.assert_array_equal(teng.table, jeng.table)
        np.testing.assert_array_equal(teng.lengths, jeng.lengths)
        assert ([r.generated for r in treqs]
                == [r.generated for r in jreqs]), ticks
        for key, val in teng.counters.items():
            assert jeng.counters[key] == val, (ticks, key)
    c = teng.counters
    assert c["spec_ticks"] > 0 and seen["bailouts"] == c["spec_bailouts"]
    assert teng.pool.live_blocks() == 0
    if speculative == "draft":
        assert c["spec_bailouts"] > 0 and c["spec_accepted"] > 0


# ---------------------------------------------------------------------------
# losslessness and rollback inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["garbage", "eos", "prefix", "snug"])
def test_speculative_trace_equals_plain(model, case):
    """Speculative serving gives the non-speculative trace: wrong drafts
    that cross pages (every tail rolled back, reservations restored), an
    EOS inside an accepted block, chunked prefill with a shared prefix, and
    a pool snug enough that rolled-back blocks recycle."""
    _, tcfg, _, tparams = model
    kw, drafter, max_new = {}, None, 6
    prompts = _prompts((9, 14))
    if case == "garbage":
        kw = dict(speculative="ngram", draft_k=7, max_len=96,
                  fused_decode=True)
        drafter = _GarbageDrafter(tcfg.vocab)
    elif case == "eos":
        prompts, max_new = _prompts((20,), seed=2), 8
        _, free = _serve(tcfg, tparams, prompts, max_new)
        kw = dict(speculative="draft", draft_k=4, eos_id=free[0][2])
    elif case == "prefix":
        sysp = np.random.default_rng(42).integers(0, 256, 24, dtype=np.int32)
        prompts, max_new = _prompts((3, 7, 5), prefix=sysp), 4
        kw = dict(speculative="draft", draft_k=4, prefill_chunk=8,
                  max_len=96, fused_decode=True)
    else:
        prompts, max_new = _prompts((12, 9, 11, 7), seed=3), 4
        kw = dict(speculative="draft", draft_k=3, pool_blocks=7,
                  prefix_sharing=False)
    base = {key: kw[key] for key in kw if key in (
        "max_len", "prefill_chunk", "pool_blocks", "prefix_sharing",
        "eos_id", "fused_decode")}
    plain, want = _serve(tcfg, tparams, prompts, max_new, **base)
    eng, got = _serve(tcfg, tparams, prompts, max_new, drafter=drafter, **kw)
    assert got == want
    assert eng.pool.live_blocks() == 0
    assert eng.pool.available() == eng.pool.capacity
    assert (eng.table == 0).all()
    c = eng.counters
    assert c["spec_ticks"] > 0
    if case == "garbage":
        assert c["spec_accepted"] < c["spec_proposed"]
        assert eng.pool.alloc_count > plain.pool.alloc_count
    if case == "eos":
        assert got[0] == want[0][:3] and c["spec_accepted"] > 0
    if case == "prefix":
        assert c["prefix_hit_tokens"] > 0
    if case == "snug":
        assert eng.pool.alloc_count > eng.pool.capacity


def test_rollback_never_crosses_shared_prefix(model):
    """Rolled-back blocks are only this tick's exclusively owned draft
    tails: the system-prompt blocks stay published and a later batch still
    hits them."""
    _, tcfg, _, tparams = model
    sysp = np.random.default_rng(41).integers(0, 256, 16, dtype=np.int32)
    eng = PagedEngine(tcfg, tparams, _scfg(speculative="ngram", draft_k=6,
                                           max_len=96),
                      device="cpu", drafter=_GarbageDrafter(tcfg.vocab))
    eng.generate([Request(prompt=p, max_new_tokens=5)
                  for p in _prompts((4, 6), prefix=sysp)])
    assert eng.pool.live_blocks() == 0
    hits = eng.counters["prefix_hit_tokens"]
    eng.generate([Request(prompt=_prompts((5,), 5, sysp)[0],
                          max_new_tokens=4)])
    assert eng.counters["prefix_hit_tokens"] >= hits + 16


@pytest.mark.parametrize("grow", ["k_amax", "v_amax", None])
def test_growth_probe_covers_k_and_v_scales(model, grow):
    """The verify forward reports growth when a draft write grows any
    layer's K or V scale (a V-only growth must bail out too), and its undo
    puts every pool back."""
    _, tcfg, _, tparams = model
    eng = PagedEngine(tcfg, tparams, _scfg(speculative="ngram",
                                           fused_decode=True), device="cpu")
    eng.submit(Request(prompt=_prompts((12,))[0], max_new_tokens=6))
    while not eng.lengths[0]:
        eng.step()
    for c in _layers(eng.caches):
        c["k_amax"] = torch.full_like(c["k_amax"], 1e6)
        c["v_amax"] = torch.full_like(c["v_amax"], 1e6)
        if grow is not None:
            c[grow] = torch.full_like(c[grow], 1e-3)
    before = _cache_tree(TT.caches_to_numpy(eng.caches, tcfg))
    B, n = len(eng.slots), int(eng.lengths[0])
    tokens = np.zeros((B, 3), np.int32)
    positions = np.full((B, 3), TA.POS_SENTINEL, np.int32)
    positions[0] = n + np.arange(3)                   # inside page 1
    _, new, grew, undo = eng._verify_forward(tokens, positions)
    assert grew == (grow is not None)
    undo()
    after = _cache_tree(TT.caches_to_numpy(eng.caches, tcfg))
    for key, val in before.items():
        np.testing.assert_array_equal(after[key], val, err_msg=key)


class _FailingDrafter:
    def propose(self, context, k):
        raise RuntimeError("drafter down")


def test_config_validation_and_failing_drafter(model):
    _, tcfg, _, tparams = model
    with pytest.raises(ValueError):
        ServeConfig(speculative="mtp")
    with pytest.raises(ValueError):
        ServeConfig(speculative="ngram", draft_k=0)
    with pytest.raises(ValueError):
        PagedEngine(tcfg, tparams, _scfg(), device="cpu",
                    drafter=NGramDrafter())
    with pytest.raises(ValueError):
        make_drafter("mtp", tcfg, tparams)
    with pytest.raises(ValueError):
        make_drafter("draft", tcfg, tparams,
                     draft_cfg=tcfg.replace(vocab=128), draft_params=tparams)
    eng = PagedEngine(tcfg, tparams, _scfg(speculative="draft"),
                      device="cpu")
    assert isinstance(eng._drafter, DraftModelDrafter)
    # A drafter is asked while the budget leaves room for a draft: after
    # the first and second of four tokens.
    eng, got = _serve(tcfg, tparams, _prompts((6,)), 4,
                      drafter=_FailingDrafter(), speculative="ngram")
    assert eng.counters["drafter_failures"] == 2
    assert eng.counters["spec_ticks"] == 0
    assert got == _serve(tcfg, tparams, _prompts((6,)), 4)[1]


def test_serve_cli_speculative_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main(["--device", "cpu", "--requests", "2", "--new-tokens",
                     "4", "--max-prompt", "16", "--speculative", "ngram",
                     "--draft-k", "3"])
    text = out.getvalue()
    assert "8 new tokens" in text and "speculative(ngram, k=3)" in text


@pytest.mark.gpu
def test_engine_on_card_matches_reference_speculative(model):
    """On the card: speculative serving through the CUDA verify kernel
    gives the reference's tokens, with one verify launch per layer per
    verify forward (bailouts included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_verify as pv
    jcfg, tcfg, jparams, tparams = model
    prompts = _prompts((5, 11, 17))
    jeng = JEngine(jcfg, jparams, JServe(fused_decode=False,
                                         speculative="draft", draft_k=3,
                                         **_KW))
    jreqs = [JRequest(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    jeng.generate(jreqs, seed=0)
    cuda_params = TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cuda")
    teng = PagedEngine(tcfg, cuda_params, ServeConfig(
        speculative="draft", draft_k=3, **_KW))
    assert teng.cfg.fused_decode is True
    treqs = [Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    before = pv.LAUNCHES
    teng.generate(treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert (pv.LAUNCHES - before
            == teng.counters["spec_ticks"] * tcfg.n_layers)
