"""The KV memory hierarchy and the handoffs of the port at bf16
(``ServeConfig.cache_dtype="bfloat16"``) held against the reference on the
CPU: reduced stablelm-1.6b (alpha 0.8) with the reference's weights
carried across.

Swap-to-host preemption on tests/test_swap.py's oversubscribed trace, the
engine API's ``extract()``/``insert()`` through a ``DisaggController``, and
the persistent prefix store.  Records carry bf16 rows as their bits, so
swap records, payloads and store records are half an f32 one's K/V bytes;
the swap counters, ``memory_report()`` and the transfer counters must equal
the reference's.

The reference cannot warm-start from a bf16 prefix store (ROADMAP C7): its
records hold ml_dtypes arrays, ``np.load`` gives them back as 2-byte void
arrays, and its splice's ``astype`` refuses those.  The port loads them as
bf16 bits, so a store the reference wrote warms the port, and the port's
warm run at one slot equals its cold run in tokens, scales and planes, and
the reference's cold run in tokens."""

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving.engine import _amax_leaves as j_amax_leaves
from repro.serving.frontdoor import DisaggController as JDisagg
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import PagedEngine, Request, ServeConfig
from repro_torch.serving.engine import _amax_arrays
from repro_torch.serving.frontdoor import DisaggController
from _torch_threads import one_thread  # noqa: F401

AMAX_RTOL = 1e-6      # a few f32 ulps: each package's own K/V projections
BF = dict(cache_dtype="bfloat16")
# tests/test_swap.py's oversubscribed shape and swap budget.
_OS = dict(max_len=64, max_slots=3, prefill_bucket=8, page_size=8,
           pool_blocks=10, oversubscribe=True)
_SWAP = 1 << 22
_COUNTERS = ("preemptions", "swap_outs", "swap_ins", "swap_fallbacks",
             "swap_in_tokens", "prefill_chunks")
# tests/test_swap.py's store geometry.
_STORE = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8,
              prefill_chunk=8)
_SYS = np.random.default_rng(42).integers(0, 256, 16, dtype=np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _prompts(lens, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    tails = [rng.integers(0, 256, L, dtype=np.int32) for L in lens]
    if prefix is None:
        return tails
    return [np.concatenate([prefix, t]) for t in tails]


def _engine(model, pkg, **kw):
    jcfg, tcfg, jparams, tparams = model
    if pkg == "ref":
        return JEngine(jcfg, jparams, JServe(**kw))
    return PagedEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")


def _serve(model, pkg, prompts, seed=0, max_new=16, engine=None, **kw):
    eng = engine if engine is not None else _engine(model, pkg, **kw)
    R = JRequest if pkg == "ref" else Request
    reqs = [R(prompt=p.copy(), max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, seed=seed)
    return eng, [r.generated for r in reqs]


def _amax(pkg, eng):
    if pkg == "ref":
        return [np.asarray(a, np.float32) for a in j_amax_leaves(eng.caches)]
    return _amax_arrays(eng.caches, True)


def _assert_grids_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=AMAX_RTOL, atol=0)


# ---------------------------------------------------------------------------
# swap-to-host preemption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused,temperature", [(False, 0.0), (True, 0.7)])
def test_swap_resume_equals_reference(model, fused, temperature):
    """tests/test_swap.py's oversubscribed trace with a swap tier at bf16,
    greedy through the oracle and sampled at 0.7 through the kernels'
    plain versions (the record then carries the plane rows too): the
    reference's tokens, swap and prefill counters and ``memory_report()``
    (whose host swap bytes count 2-byte K/V values), and the port's own
    recompute run's tokens with fewer prefill chunks."""
    prompts = _prompts((12, 9, 11))
    kw = dict(_OS, fused_decode=fused, temperature=temperature, **BF)
    seed = 7 if temperature else 0
    jeng, jtok = _serve(model, "ref", prompts, seed, swap_host_bytes=_SWAP,
                        **kw)
    teng, ttok = _serve(model, "port", prompts, seed, swap_host_bytes=_SWAP,
                        **kw)
    rec, rtok = _serve(model, "port", prompts, seed, **kw)
    assert ttok == jtok == rtok
    assert ({k: teng.counters[k] for k in _COUNTERS}
            == {k: jeng.counters[k] for k in _COUNTERS})
    assert teng.counters["swap_ins"] >= 1
    assert teng.counters["prefill_chunks"] < rec.counters["prefill_chunks"]
    assert teng.memory_report() == jeng.memory_report()
    assert teng._swap.peak_bytes == jeng._swap.peak_bytes > 0
    assert teng._swap.bytes_used == 0


# ---------------------------------------------------------------------------
# extract / insert
# ---------------------------------------------------------------------------


def test_disaggregated_handoff_equals_reference(model):
    """Prefill on one engine, ``extract()`` to host, ``insert()`` into a
    decode engine, at bf16 and through the kernels' plain versions: the
    reference's tokens (equal to its colocated run), transfer counters and
    payload bytes, which are an f32 run's K/V bytes halved."""
    kw = dict(max_len=64, prefill_bucket=8, page_size=8, fused_decode=True)
    prompts = _prompts((5, 11, 7))
    _, colocated = _serve(model, "ref", prompts, max_new=5, max_slots=2,
                          **kw, **BF)
    out = {}
    for pkg, dtype in (("ref", "bfloat16"), ("port", "bfloat16"),
                       ("port", "float32")):
        D = JDisagg if pkg == "ref" else DisaggController
        ctl = D(_engine(model, pkg, max_slots=1, cache_dtype=dtype, **kw),
                _engine(model, pkg, max_slots=2, cache_dtype=dtype, **kw))
        _, toks = _serve(model, pkg, prompts, max_new=5, engine=ctl)
        out[pkg, dtype] = (ctl, toks)
    (j, jtok), (t, ttok) = out["ref", "bfloat16"], out["port", "bfloat16"]
    assert ttok == jtok == colocated
    assert t.xfer.counters == j.xfer.counters
    assert t.counters == j.counters
    f32 = out["port", "float32"][0].xfer.counters
    assert f32["blocks_transferred"] == t.xfer.counters["blocks_transferred"]
    tcfg = model[1]
    kv16 = (t.xfer.counters["blocks_transferred"] * 8 * tcfg.n_layers * 2
            * tcfg.n_kv_heads * tcfg.head_dim * 2)   # bf16 K/V of the blocks
    assert f32["payload_bytes"] - t.xfer.counters["payload_bytes"] == kv16
    _assert_grids_close(_amax("port", t.decode_engine),
                        _amax("ref", j.decode_engine))


# ---------------------------------------------------------------------------
# the prefix store (C7)
# ---------------------------------------------------------------------------


def _store_prompts():
    """tests/test_swap.py's ``_store_reqs``: the system prompt, then a
    tail."""
    rng = np.random.default_rng(3)
    return [np.concatenate([_SYS, rng.integers(0, 256, L, dtype=np.int32)])
            for L in (6, 9)]


def test_reference_bf16_store_warms_port_not_reference(model, tmp_path):
    """A bf16 store flushed by the reference: the reference's own warm
    engine dies on it with ``TypeError`` (C7, documented here, not
    expected to pass), and the port's warm engine loads the records as
    bf16 bits and serves the reference's cold tokens with fewer prefill
    chunks."""
    d = str(tmp_path)
    kw = dict(_STORE, max_slots=1, fused_decode=True, **BF)
    first, _ = _serve(model, "ref", _store_prompts(), max_new=8,
                      prefix_store_dir=d, **kw)
    assert first.flush_prefixes() >= 2
    _, jcold = _serve(model, "ref", _store_prompts(), max_new=8, **kw)
    with pytest.raises(TypeError, match="V2"):
        _serve(model, "ref", _store_prompts(), max_new=8,
               prefix_store_dir=d, **kw)
    tcold, tcold_tok = _serve(model, "port", _store_prompts(), max_new=8,
                              **kw)
    twarm, twarm_tok = _serve(model, "port", _store_prompts(), max_new=8,
                              prefix_store_dir=d, **kw)
    assert twarm_tok == tcold_tok == jcold
    assert twarm.counters["prefix_store_hits"] >= 2
    assert twarm.counters["prefill_chunks"] < tcold.counters["prefill_chunks"]


def test_port_bf16_warm_start_equals_cold_with_one_slot(model, tmp_path):
    """The port's own bf16 store at one slot
    (test_torch_prefix_store.py::test_warm_grid_equals_cold_with_one_slot
    at bf16): the warm run's tokens, scales and plane bytes equal its cold
    run's, its tokens the reference's cold bf16 run's, and its store
    records hold the reference's bytes format (2-byte K/V values)."""
    _, tcfg, _, _ = model
    d = str(tmp_path)
    kw = dict(_STORE, max_slots=1, fused_decode=True, **BF)
    first, _ = _serve(model, "port", _store_prompts(), max_new=8,
                      prefix_store_dir=d, **kw)
    assert first.flush_prefixes() >= 2
    cold, cold_tok = _serve(model, "port", _store_prompts(), max_new=8, **kw)
    warm, warm_tok = _serve(model, "port", _store_prompts(), max_new=8,
                            prefix_store_dir=d, **kw)
    _, jcold = _serve(model, "ref", _store_prompts(), max_new=8, **kw)
    assert warm_tok == cold_tok == jcold
    assert warm.counters["prefix_store_hits"] >= 2
    for a, b in zip(_amax("port", warm), _amax("port", cold)):
        np.testing.assert_array_equal(a, b)
    got = TT.caches_to_numpy(warm.caches, tcfg)["seg0"]["b0"]
    want = TT.caches_to_numpy(cold.caches, tcfg)["seg0"]["b0"]
    np.testing.assert_array_equal(got["kq"], want["kq"])
    chain = tstore.list_prefix_records(d)[0]
    rec = tstore.load_prefix_record(d, chain)[0]
    assert rec["k"].dtype == rec["v"].dtype == np.uint16
    assert warm.memory_report()["disk_prefix_bytes"] == \
        tstore.prefix_store_bytes(d) > 0
