"""The port's PagedEngine held against the reference's on the CPU: reduced
stablelm-1.6b with the reference's weights carried across, served greedy
tick by tick beside the reference engine.  Token streams must be identical
and the allocator state (free list, refcounts, prefix registry, LRU,
reservations), block tables and fill levels equal after every tick."""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JContinuous
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                 Request, ServeConfig)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


# The reference's tests/test_serving.py paged engine geometry.
_KW = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8)


def _prompts(lens, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    tails = [rng.integers(0, 256, L, dtype=np.int32) for L in lens]
    if prefix is None:
        return tails
    return [np.concatenate([prefix, t]) for t in tails]


def _lockstep(model, prompts, max_new, fused, device="cpu", **kw):
    """Serve the same trace through both engines one tick at a time; the
    reference runs its plain oracle (fused_decode=False), which its own
    tests pin to its kernel."""
    jcfg, tcfg, jparams, tparams = model
    if device != "cpu":
        tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device)
    jeng = JEngine(jcfg, jparams, JServe(fused_decode=False, **_KW, **kw))
    teng = PagedEngine(tcfg, tparams, ServeConfig(fused_decode=fused, **_KW,
                                                  **kw), device=device)
    jreqs = [jeng.submit(JRequest(prompt=p.copy(), max_new_tokens=max_new))
             for p in prompts]
    treqs = [teng.submit(Request(prompt=p.copy(), max_new_tokens=max_new))
             for p in prompts]
    jeng.begin(0)
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
    for key, val in teng.counters.items():
        assert jeng.counters[key] == val, key
    return teng, [r.generated for r in treqs]


@pytest.mark.parametrize("fused", [True, False])
def test_engine_matches_reference_greedy(model, fused):
    """The reference's trace (lengths 5, 11, 17, 9; alpha 0.8), through
    the kernel's plain version (fused) and through the torch oracle."""
    eng, toks = _lockstep(model, _prompts((5, 11, 17, 9)), 6, fused)
    assert eng.cfg.fused_decode is fused
    assert all(len(t) == 6 for t in toks)
    assert eng.pool.live_blocks() == 0
    assert eng.pool.available() == eng.pool.capacity


def test_engine_matches_reference_shared_prefix_recycled(model):
    """A common system prompt (prefix blocks mapped by several tables) on a
    pool small enough that physical blocks recycle mid-trace."""
    sys_prompt = np.random.default_rng(42).integers(0, 256, 16,
                                                    dtype=np.int32)
    eng, toks = _lockstep(model, _prompts((3, 7, 5, 9, 6), 9, sys_prompt),
                          4, True, pool_blocks=10)
    assert eng.counters["prefix_hit_tokens"] >= 16 * 2
    assert eng.pool.alloc_count > eng.pool.capacity      # blocks recycled


@pytest.mark.gpu
def test_engine_on_card_matches_reference(model):
    """On the card: the engine resolves to the CUDA kernel, launches it
    once per layer per decode tick, and serves the reference's trace with
    identical tokens and allocator state on every tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_decode as pd
    before = pd.LAUNCHES
    eng, toks = _lockstep(model, _prompts((5, 11, 17, 9)), 6, None,
                          device="cuda")
    assert eng.cfg.fused_decode is True
    assert (pd.LAUNCHES - before
            == eng.counters["decode_steps"] * model[1].n_layers)


def test_kv_bytes_resident(model):
    """Resident bytes equal the reference's on the plain path; the kernel
    path adds exactly the packed plane pool."""
    jcfg, tcfg, jparams, tparams = model
    jeng = JEngine(jcfg, jparams, JServe(fused_decode=False, **_KW))
    jeng.generate([JRequest(prompt=p, max_new_tokens=3)
                   for p in _prompts((9, 14))], seed=0)
    engines = {}
    for fused in (False, True):
        engines[fused] = PagedEngine(tcfg, tparams,
                                     ServeConfig(fused_decode=fused, **_KW),
                                     device="cpu")
        engines[fused].generate([Request(prompt=p, max_new_tokens=3)
                                 for p in _prompts((9, 14))])
    assert engines[False].kv_bytes_resident() == jeng.kv_bytes_resident()
    blocks = engines[True].pool.peak_live_blocks
    planes = tcfg.n_layers * 12 * tcfg.n_kv_heads * tcfg.head_dim // 8
    assert (engines[True].kv_bytes_resident()
            - engines[False].kv_bytes_resident()) == blocks * 8 * planes


def test_serve_config_validation():
    """The reference's validation cases raise ValueError with the
    reference's message (or its first clause); sampling and the QoS fields
    construct."""
    bad = [dict(max_slots=0), dict(prefill_bucket=0), dict(max_len=-1),
           dict(page_size=0), dict(pool_blocks=1), dict(max_blocks_per_req=0),
           dict(prefill_chunk=0), dict(prefill_bucket=16, prefill_chunk=24),
           dict(temperature=-0.5), dict(cache_dtype="float16"),
           dict(preempt_policy="roulette"), dict(deadline_ticks=0),
           dict(shed_watermark=0.5), dict(oversubscribe=True,
                                          shed_watermark=1.0),
           dict(fused_decode=True, page_size=12), dict(snapshot_every=-1)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            JServe(**kw)
        with pytest.raises(ValueError) as got:
            ServeConfig(**kw)
        # (the port leaves out the reference's remarks on jit shapes)
        assert str(want.value).startswith(str(got.value)), kw
    # tests/test_serving.py: only the kernel needs whole plane bytes; a
    # planeless pool (page % 8 != 0) serves through the dense gather.
    with pytest.raises(ValueError):
        ServeConfig(fused_decode=True, page_size=12)
    assert ServeConfig(page_size=12).fused_decode is None
    with pytest.raises(NotImplementedError, match="A10"):
        ServeConfig(cache_dtype="bfloat16")
    scfg = ServeConfig(temperature=0.7, oversubscribe=True,
                       preempt_policy="lifo", deadline_ticks=5,
                       shed_watermark=0.9, max_len=64, page_size=16)
    assert scfg.resolved_max_blocks() == 4
    assert scfg.resolved_pool_blocks() == 1 + 4 * 4
    assert scfg.resolved_chunk() % scfg.prefill_bucket == 0
    assert ServeConfig().resolved_pool_blocks() == 1 + 4 * 32


def test_hierarchy_config_validation(model):
    """tests/test_swap.py:395-415: the memory hierarchy's fields raise
    ValueError with the reference's message, the contiguous engine refuses
    a prefix store (it has no paged pool to tier) with the reference's
    message, and ``flush_prefixes()`` without a store raises
    RuntimeError."""
    bad = [dict(swap_host_bytes=-1), dict(prefix_host_bytes=-1),
           dict(swap_host_bytes=1 << 20),
           dict(prefix_store_dir="/tmp/x", prefix_sharing=False),
           dict(prefix_host_bytes=1 << 20, prefix_sharing=False)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            JServe(**kw)
        with pytest.raises(ValueError) as got:
            ServeConfig(**kw)
        assert str(got.value) == str(want.value), kw
    scfg = ServeConfig(oversubscribe=True, swap_host_bytes=1 << 20,
                       prefix_store_dir="/tmp/x", prefix_host_bytes=1 << 20)
    assert scfg.swap_host_bytes == 1 << 20
    jcfg, tcfg, jparams, tparams = model
    kw = dict(max_len=64, prefix_store_dir="/tmp/x")
    with pytest.raises(ValueError) as want:
        JContinuous(jcfg, jparams, JServe(**kw))
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tcfg, tparams, ServeConfig(**kw), "cpu")
    assert str(got.value) == str(want.value)
    eng = PagedEngine(tcfg, tparams, ServeConfig(**_KW), "cpu")
    with pytest.raises(RuntimeError, match="prefix_store_dir"):
        eng.flush_prefixes()
    assert eng.memory_report() == {
        "device_bytes": eng.kv_bytes_resident(peak=False),
        "device_bytes_peak": eng.kv_bytes_resident(peak=True),
        "host_swap_bytes": 0, "host_swap_bytes_peak": 0,
        "host_prefix_bytes": 0, "host_prefix_bytes_peak": 0,
        "disk_prefix_bytes": 0}


def test_device_and_kernel_resolution(model):
    _, tcfg, _, tparams = model
    scfg = ServeConfig(**_KW)
    assert PagedEngine(tcfg, tparams, scfg, "cpu").cfg.fused_decode is False
    on = PagedEngine(tcfg, tparams, ServeConfig(fused_decode=True, **_KW),
                     "cpu")
    assert on.cfg.fused_decode is True
    assert "kq" in on.caches["seg0"][0]["b0"]
    # Dense impls serve too (once refused): their pools carry no scales
    # and no planes.
    dense = PagedEngine(tcfg.replace(attn_impl="xla"), tparams, scfg, "cpu")
    assert not {"kq", "k_amax"} & set(dense.caches["seg0"][0]["b0"])
    if torch.cuda.is_available():
        assert PagedEngine(tcfg, tparams, scfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedEngine(tcfg, tparams, scfg)
    with pytest.raises(ValueError):
        PagedEngine(tcfg, tparams, scfg, "cpu").submit(
            Request(prompt=np.zeros(60, np.int32), max_new_tokens=200))


def test_fused_decode_refuses_pages_over_the_kernel_limit(model):
    """The decode and verify kernels take pages of up to 1024 tokens (over
    256 through their striped walk): an engine with fused decode builds at
    pages of 264 and 512, and one that would hand the kernels larger pages
    fails when it is built, not at its first decode tick.  The plain oracle
    serves such pages."""
    _, tcfg, _, tparams = model
    for page in (264, 512):
        eng = PagedEngine(tcfg, tparams, ServeConfig(
            fused_decode=True, **dict(_KW, page_size=page,
                                      max_len=2 * page)), "cpu")
        assert eng.cfg.fused_decode is True and "kq" in \
            eng.caches["seg0"][0]["b0"]
    big = dict(_KW, page_size=1032, max_len=2064)
    with pytest.raises(ValueError, match="at most 1024"):
        PagedEngine(tcfg, tparams, ServeConfig(fused_decode=True, **big),
                    "cpu")
    plain = PagedEngine(tcfg, tparams, ServeConfig(fused_decode=False, **big),
                        "cpu")
    assert plain.cfg.fused_decode is False and plain.layout.page_size == 1032


_LARGE = dict(max_len=1024, max_slots=2, prefill_bucket=8, page_size=512)


def _serve_large_pages(model, fused, device):
    """Three prompts (two of them over a page) served greedily at pages of
    512 tokens, the striped walk's size; returns the engine and tokens."""
    _, tcfg, jparams, tparams = model
    if device != "cpu":
        tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device)
    eng = PagedEngine(tcfg, tparams, ServeConfig(fused_decode=fused,
                                                 **_LARGE), device=device)
    reqs = [Request(prompt=p, max_new_tokens=5)
            for p in _prompts((600, 40, 530), seed=3)]
    eng.generate(reqs)
    return eng, [r.generated for r in reqs]


def test_engine_serves_pages_over_256_like_the_reference(model):
    """Pages of 512 tokens served through the kernel's plain version and
    through the torch oracle: the reference's tokens and counters."""
    jcfg, _, jparams, _ = model
    jeng = JEngine(jcfg, jparams, JServe(fused_decode=False, **_LARGE))
    jreqs = [JRequest(prompt=p, max_new_tokens=5)
             for p in _prompts((600, 40, 530), seed=3)]
    jeng.generate(jreqs)
    want = [r.generated for r in jreqs]
    for fused in (True, False):
        eng, toks = _serve_large_pages(model, fused, "cpu")
        assert eng.cfg.fused_decode is fused and toks == want
        for key, val in eng.counters.items():
            assert jeng.counters[key] == val, key


@pytest.mark.gpu
def test_engine_on_card_serves_pages_over_256(model):
    """On the card: the engine at pages of 512 tokens launches the striped
    walk once per layer per decode tick and serves the plain oracle's
    tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_decode as pd
    before = pd.LAUNCHES
    eng, fused = _serve_large_pages(model, True, "cuda")
    assert (pd.LAUNCHES - before
            == eng.counters["decode_steps"] * model[1].n_layers > 0)
    before = pd.LAUNCHES
    _, plain = _serve_large_pages(model, False, "cuda")
    assert pd.LAUNCHES == before and fused == plain


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        tserve.main(["--device", "cpu", "--requests", "3", "--new-tokens",
                     "3", "--max-prompt", "20", "--fused-decode", "on"])
    text = out.getvalue()
    assert "9 new tokens" in text and "fused_decode=True" in text
    assert "'requests_finished': 3" in text


def test_serve_cli_sampled_oversubscribed_on_cpu():
    """Sampled and oversubscribed: the pool of 10 blocks forces a
    preemption, and a second run at the same seed serves the same
    tokens."""
    argv = ["--device", "cpu", "--requests", "4", "--new-tokens", "12",
            "--max-prompt", "40", "--slots", "3", "--page-size", "8",
            "--temperature", "0.7", "--oversubscribe", "--pool-blocks", "10",
            "--seed", "0"]
    runs = []
    for _ in range(2):
        out = io.StringIO()
        with redirect_stdout(out):
            reqs = tserve.main(argv)
        text = out.getvalue()
        line = next(x for x in text.splitlines() if "oversubscribed(" in x)
        assert int(line.split(": ")[1].split()[0]) >= 1, line
        assert "'preemptions': 0" not in text
        runs.append(([r.generated for r in reqs],
                     [x for x in text.splitlines() if "counters" in x]))
    assert runs[0] == runs[1]
    assert all(len(t) == 12 for t in runs[0][0])


def test_serve_cli_swap_on_cpu():
    """``--swap-host-bytes`` on the sampled oversubscribed run: the
    ``hierarchy:`` line reports the swap-ins, and the tokens equal the run
    without swap."""
    argv = ["--device", "cpu", "--requests", "4", "--new-tokens", "12",
            "--max-prompt", "40", "--slots", "3", "--page-size", "8",
            "--temperature", "0.7", "--oversubscribe", "--pool-blocks", "10",
            "--seed", "0"]
    plain = tserve.main(argv)
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = tserve.main(argv + ["--swap-host-bytes", "4194304"])
    line = next(x for x in out.getvalue().splitlines()
                if x.startswith("[serve] hierarchy: "))
    swap_ins = int(line.split(" / ")[1].split()[0])
    assert swap_ins >= 1, line
    assert "'host_swap_bytes': 0" in line, line
    assert [r.generated for r in reqs] == [r.generated for r in plain]


def test_serve_cli_chaos_on_cpu(tmp_path):
    """A crash at tick 3 with a snapshot every tick: the chaos summary
    reports one crash and one restore, and the tokens equal a run without
    the plan."""
    base = ["--device", "cpu", "--requests", "3", "--new-tokens", "5",
            "--max-prompt", "20", "--page-size", "8", "--seed", "0"]
    plain = tserve.main(base)
    out = io.StringIO()
    with redirect_stdout(out):
        reqs = tserve.main(base + ["--snapshot-dir", str(tmp_path),
                                   "--snapshot-every", "1",
                                   "--fault-plan", '[["crash", 3]]'])
    line = next(x for x in out.getvalue().splitlines()
                if x.startswith("[serve] chaos: 1 crashes"))
    assert "1 restores" in line and "unfired=[]" in line, line
    assert "fired={'crash': 1}" in line, line
    assert [r.generated for r in reqs] == [r.generated for r in plain]
    assert all(len(r.generated) == 5 for r in reqs)


@pytest.mark.parametrize("head_dim", [8, 24, 272])
def test_fused_decode_refuses_head_widths_over_the_kernel_limits(head_dim):
    """The decode and verify kernels take head_dim at most 256 and a
    multiple of 16 (the V width, here head_dim, a multiple of 4): an engine
    that would hand them another width fails when it is built, with the
    reason.  The plain oracle serves that width."""
    cfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", head_dim=head_dim)
    params = TT.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="head_dim at most 256 and a "
                                         "multiple of 16"):
        PagedEngine(cfg, params, ServeConfig(fused_decode=True, **_KW),
                    "cpu")
    plain = PagedEngine(cfg, params, ServeConfig(fused_decode=False, **_KW),
                        "cpu")
    reqs = [Request(prompt=p, max_new_tokens=3) for p in _prompts((5, 9))]
    plain.generate(reqs)
    assert plain.cfg.fused_decode is False
    assert all(len(r.generated) == 3 and all(0 <= t < cfg.vocab
                                             for t in r.generated)
               for r in reqs)
