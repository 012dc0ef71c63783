"""The port's paged BESF decode held against the JAX package: the plain
version and the torch oracle against the JAX oracle and the Pallas kernel
in interpret mode, the per-KV-head ``rounds`` rule the CUDA kernel relies
on, and (on a card) the CUDA kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core.besf import BitStopperConfig as JConfig
from repro.core.besf import besf_attention_decode_paged as joracle
from repro.kernels.paged_decode import paged_bitstopper_decode as jkernel
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.core.besf import besf_attention_decode_paged as toracle
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels.runtime import on_card
from _torch_threads import one_thread  # noqa: F401


def _pool(seed, P=9, bs=16, Hkv=2, D=16, hot_heads=()):
    """Pool with stale garbage in unreferenced blocks (block 8 is larger
    than the running amax).  Each KV head in ``hot_heads`` gets one hot
    page (physical block 1) along a unit direction, returned per head."""
    rng = np.random.default_rng(seed)
    k = (rng.normal(size=(P, bs, Hkv, D)) * 2).astype(np.float32)
    v = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    hot = {}
    for h in hot_heads:
        u = rng.normal(size=D)
        hot[h] = (u / np.linalg.norm(u)).astype(np.float32)
        k[:, :, h] *= 0.02
        k[1, :, h] += 8.0 * hot[h]
    k_amax = np.abs(k).max(axis=(0, 1, 3))
    v_amax = np.abs(v).max(axis=(0, 1, 3))
    k[8] = 50.0
    return k, v, k_amax, v_amax, hot


# Shared prefix (block 1 in two tables), recycled blocks, a row ending
# mid-page and an inactive row (length 0).
_TABLE = np.array([[1, 2, 3, 4], [1, 5, 6, 0], [7, 3, 0, 0], [2, 0, 0, 0]],
                  np.int32)
_LENGTHS = np.array([64, 40, 19, 0], np.int32)


def _inputs(seed, G, hot_heads=(), D=16, bs=16):
    """Kernel operands; query heads of a hot KV head point at its hot
    page.  Fill levels scale with the page size ``bs``."""
    k, v, k_amax, v_amax, hot = _pool(seed, bs=bs, hot_heads=hot_heads, D=D)
    rng = np.random.default_rng(seed + 10)
    q = (rng.normal(size=(4, k.shape[2] * G, k.shape[3])) * 2).astype(
        np.float32)
    for h, u in hot.items():
        q[:, h * G:(h + 1) * G] = 8.0 * u + 0.05 * q[:, h * G:(h + 1) * G]
    lengths = (_LENGTHS * bs // 16).astype(np.int32)
    q_pos = np.maximum(lengths - 1, 0).astype(np.int32)
    kq = np.asarray(jq.pack_pool_planes(jnp.asarray(k), jnp.asarray(k_amax)))
    return k, kq, v, _TABLE, lengths, q_pos, k_amax, v_amax, q


def _t(a):
    return torch.as_tensor(np.array(a))


_CASES = [  # alpha, window, G, min_rounds, quantize_v
    (0.2, None, 1, 1, True),
    (0.6, None, 2, 1, True),
    (0.8, 24, 2, 1, False),
    (1.0, 16, 1, 3, True),
    (0.6, None, 4, 2, False),
]


@pytest.mark.parametrize("alpha,window,G,min_rounds,quantize_v", _CASES)
def test_plain_matches_jax_oracle(alpha, window, G, min_rounds, quantize_v):
    """rounds, survivors and v_fetched exactly; out within 1e-6 (f32 exp
    and the summation order differ between the frameworks)."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(0, G)
    kw = dict(alpha=alpha, min_rounds=min_rounds, quantize_v=quantize_v)
    want = joracle(*map(jnp.asarray, (q, k, v, table, lengths, q_pos,
                                      k_amax, v_amax)),
                   cfg=JConfig(**kw), window=window)
    rest = tuple(map(_t, (v, table, lengths, q_pos, k_amax, v_amax)))
    plain = pd.paged_bitstopper_decode(_t(q), _t(kq), *rest,
                                       cfg=TConfig(**kw), window=window)
    oracle = toracle(_t(q), _t(k), *rest, cfg=TConfig(**kw), window=window)
    for got in (plain, oracle):
        for field in ("rounds", "survivors", "v_fetched"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)))
        np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                                   atol=1e-6, rtol=1e-6)
    rounds = plain.rounds.numpy()
    assert rounds[1, 3] == 0 and (rounds[2, 2:] == 0).all()
    assert (rounds[3] == 0).all() and not plain.survivors[3].any()


@pytest.mark.parametrize("bs,G,window", [(48, 2, None), (64, 1, 40),
                                         (512, 1, None), (1024, 2, 700)])
def test_plain_matches_jax_oracle_large_pages(bs, G, window):
    """Pages of more than 32 tokens, which the CUDA kernel walks with
    several tokens a lane, and of 512 and 1024 tokens, which it walks in
    stripes: the plain version it is held to equals the JAX oracle there
    too."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(2, G,
                                                                  bs=bs)
    want = joracle(*map(jnp.asarray, (q, k, v, table, lengths, q_pos,
                                      k_amax, v_amax)),
                   cfg=JConfig(alpha=0.6), window=window)
    got = pd.paged_bitstopper_decode(
        *map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)),
        cfg=TConfig(alpha=0.6), window=window)
    for field in ("rounds", "survivors", "v_fetched"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               atol=1e-6, rtol=1e-6)
    assert got.survivors.shape[-1] == 4 * bs


def _dead_page_inputs(bs):
    """Pages on which every row of a KV head dies: four query heads a KV
    head point at the hot page (physical block 1, copied to block 5), so
    the cold pages after it stop in two rounds with no survivor.  Row 3
    walks hot, cold, hot, cold pages: a dead page between live ones."""
    k, _, v, _, lengths, _, k_amax, v_amax, q = _inputs(8, 4, hot_heads=(0, 1),
                                                        bs=bs)
    k = k.copy()
    k[5] = k[1]
    table = _TABLE.copy()
    table[3] = [1, 2, 5, 3]
    lengths = lengths.copy()
    lengths[3] = 4 * bs
    q_pos = np.maximum(lengths - 1, 0).astype(np.int32)
    kq = np.asarray(jq.pack_pool_planes(jnp.asarray(k), jnp.asarray(k_amax)))
    return k, kq, v, table, lengths, q_pos, k_amax, v_amax, q


# Pages with a survivor of some query head, per (row, KV head, page).
_DEAD_PAGE_LIVE = [[[1, 0, 0, 0]] * 2, [[1, 1, 0, 0]] * 2, [[1, 1, 0, 0]] * 2,
                   [[1, 0, 1, 0]] * 2]


@pytest.mark.parametrize("bs", [512, 1024])
def test_plain_matches_jax_oracle_pages_that_die_whole(bs):
    """The striped walk's inputs with whole dead pages (the card test below
    repeats its kernel on them): the plain version equals the JAX oracle,
    and the pages die as designed."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _dead_page_inputs(bs)
    want = joracle(*map(jnp.asarray, (q, k, v, table, lengths, q_pos,
                                      k_amax, v_amax)),
                   cfg=JConfig(alpha=0.4))
    got = pd.paged_bitstopper_decode(
        *map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)),
        cfg=TConfig(alpha=0.4))
    for field in ("rounds", "survivors", "v_fetched"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               atol=1e-6, rtol=1e-6)
    live = got.survivors.reshape(4, 2, 4, 4, bs).any(4).any(2)
    assert live.int().tolist() == _DEAD_PAGE_LIVE


@pytest.mark.parametrize("alpha,window,G", [(0.6, None, 2), (0.8, 24, 1)])
def test_plain_matches_jax_kernel_interpret(alpha, window, G):
    """Against the Pallas kernel itself (interpret mode)."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(1, G)
    want = jkernel(*map(jnp.asarray, (q, kq, v, table, lengths, q_pos,
                                      k_amax, v_amax)),
                   cfg=JConfig(alpha=alpha), window=window, interpret=True)
    got = pd.paged_bitstopper_decode(
        *map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)),
        cfg=TConfig(alpha=alpha), window=window)
    for field in ("rounds", "survivors", "v_fetched"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("G", [1, 2])
def test_rounds_is_max_over_kv_heads(G):
    """The CUDA kernel walks each (slot, KV head) on its own and writes
    per-head plane counts; the reference counts rounds per slot.  Run the
    plain version on each KV head alone: survivors and output per head are
    unchanged, and the slot's rounds is the max of the per-head rounds."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(
        2, G, hot_heads=(0,))
    cfg = TConfig(alpha=0.4)
    args = tuple(map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)))
    whole = pd.paged_bitstopper_decode(*args, cfg=cfg)
    per_head = []
    Hkv = kq.shape[3]
    for h in range(Hkv):
        hs = slice(h * G, (h + 1) * G)
        part = pd.paged_bitstopper_decode(
            args[0][:, hs], args[1][:, :, :, h:h + 1].contiguous(),
            args[2][:, :, h:h + 1].contiguous(), *args[3:6],
            args[6][h:h + 1], args[7][h:h + 1], cfg=cfg)
        np.testing.assert_array_equal(part.survivors.numpy(),
                                      whole.survivors[:, hs].numpy())
        np.testing.assert_allclose(part.out.numpy(), whole.out[:, hs].numpy(),
                                   atol=1e-6, rtol=1e-6)
        per_head.append(part.rounds)
    per_head = torch.stack(per_head, 1)
    np.testing.assert_array_equal(per_head.amax(1).numpy(),
                                  whole.rounds.numpy())
    assert (per_head[:, 0] != per_head[:, 1]).any()       # the max matters


@pytest.mark.parametrize("G", [2, 4])
def test_rounds_is_max_over_query_heads(G):
    """The CUDA kernel walks each query head in a warp of its own and
    writes, per KV head, the max of its query heads' plane counts.  Run the
    plain version on each query head alone, with its KV head's pool:
    survivors and output are unchanged, and each KV head's rounds is the max
    over its G query heads.  Only the first query head of KV head 0 points
    at the hot page, so siblings prune differently."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(
        5, G, hot_heads=(0,))
    q[:, 1:G] = np.random.default_rng(15).normal(size=q[:, 1:G].shape) * 2
    cfg = TConfig(alpha=0.4)
    args = tuple(map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)))
    whole = pd.paged_bitstopper_decode(*args, cfg=cfg)
    Hkv = kq.shape[3]
    per_kv = []
    for h in range(Hkv):
        pool = (args[1][:, :, :, h:h + 1].contiguous(),
                args[2][:, :, h:h + 1].contiguous())
        amax = (args[6][h:h + 1], args[7][h:h + 1])
        kv_alone = pd.paged_bitstopper_decode(
            args[0][:, h * G:(h + 1) * G], *pool, *args[3:6], *amax, cfg=cfg)
        heads = []
        for hq in range(h * G, (h + 1) * G):
            one = pd.paged_bitstopper_decode(
                args[0][:, hq:hq + 1], *pool, *args[3:6], *amax, cfg=cfg)
            np.testing.assert_array_equal(one.survivors.numpy(),
                                          whole.survivors[:, hq:hq + 1].numpy())
            np.testing.assert_allclose(one.out.numpy(),
                                       whole.out[:, hq:hq + 1].numpy(),
                                       atol=1e-6, rtol=1e-6)
            heads.append(one.rounds)
        heads = torch.stack(heads, 1)                        # [B, G, MB]
        np.testing.assert_array_equal(heads.amax(1).numpy(),
                                      kv_alone.rounds.numpy())
        if h == 0:
            assert (heads[:, 0] != heads[:, 1]).any()    # the max matters
        per_kv.append(kv_alone.rounds)
    np.testing.assert_array_equal(torch.stack(per_kv, 1).amax(1).numpy(),
                                  whole.rounds.numpy())


def test_plain_early_termination_and_stats_off():
    """A hot page completes all planes and is read; cold pages stop early
    and some V pages are never read.  ``stats=False`` drops the stats."""
    *ops, q = _inputs(4, 1, hot_heads=(0, 1))
    k, kq, v, table, lengths, q_pos, k_amax, v_amax = ops
    args = tuple(map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)))
    res = pd.paged_bitstopper_decode(*args, cfg=TConfig(alpha=0.4))
    rounds, vf = res.rounds.numpy()[0], res.v_fetched.numpy()[0]
    assert rounds[0] == 12 and vf[0]
    assert rounds.sum() < 12 * len(rounds) and not vf.all()
    lean = pd.paged_bitstopper_decode(*args, cfg=TConfig(alpha=0.4),
                                      stats=False)
    assert lean.survivors is None and lean.v_fetched is None
    assert torch.equal(lean.out, res.out) and torch.equal(lean.rounds,
                                                          res.rounds)


def test_cpu_tensors_take_the_plain_path():
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(0, 1)
    args = tuple(map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)))
    before = pd.LAUNCHES
    pd.paged_bitstopper_decode(*args)
    assert pd.LAUNCHES == before
    assert on_card(*args) is False
    with pytest.raises(ValueError):
        on_card(args[0], torch.empty(1, device="meta"))
    with pytest.raises(ValueError):
        pd.paged_bitstopper_decode(args[0], args[1][:, :6], *args[2:])


@pytest.mark.gpu
@pytest.mark.parametrize("alpha,window,G,min_rounds,quantize_v,D,bs",
                         [c + (16, 16) for c in _CASES]
                         + [(0.6, None, 2, 1, True, 128, 16),
                            (0.6, None, 3, 1, True, 16, 16),
                            (0.8, 24, 5, 2, False, 16, 16),
                            (0.6, None, 8, 1, True, 64, 16),
                            (0.6, None, 2, 1, True, 16, 64),
                            (0.8, 40, 1, 1, True, 16, 48),
                            (0.6, None, 2, 1, True, 16, 512),
                            (0.8, 700, 1, 2, False, 64, 1024),
                            (0.6, None, 8, 1, True, 16, 264)])
def test_cuda_kernel_matches_plain(alpha, window, G, min_rounds,
                                   quantize_v, D, bs):
    """On the card: the CUDA kernel against the plain version on the same
    CUDA tensors.  Integer observables exact, out within 1e-5 (the kernel's
    expf and summation order differ from the plain version's).  D = Dv = 128
    gives each lane several plane words and V columns; G = 3, 5 and 8 give
    other splits of walk and epilogue warps, beyond four walk warps a warp
    walks several heads; pages of 48 and 64 tokens give a lane several
    tokens; pages of 264, 512 and 1024 tokens run the striped walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(3, G, D=D,
                                                                  bs=bs)
    args = tuple(torch.as_tensor(np.array(a), device="cuda")
                 for a in (q, kq, v, table, lengths, q_pos, k_amax, v_amax))
    cfg = TConfig(alpha=alpha, min_rounds=min_rounds, quantize_v=quantize_v)
    before = pd.LAUNCHES
    ker = pd.paged_bitstopper_decode(*args, cfg=cfg, window=window)
    torch.cuda.synchronize()
    assert pd.LAUNCHES == before + 1
    ref = pd.paged_bitstopper_decode_plain(*args, cfg=cfg, window=window)
    for field in ("rounds", "survivors", "v_fetched"):
        assert torch.equal(getattr(ker, field), getattr(ref, field)), field
    assert float((ker.out - ref.out).abs().max()) <= 1e-5
    lean = pd.paged_bitstopper_decode(*args, cfg=cfg, window=window,
                                      stats=False)
    assert torch.equal(lean.rounds, ker.rounds)


@pytest.mark.gpu
@pytest.mark.parametrize("G,window,bs", [(1, None, 16), (2, 24, 16),
                                         (5, None, 16), (8, 24, 16),
                                         (2, None, 64), (1, None, 512),
                                         (2, 600, 1024)])
def test_cuda_kernel_equals_verify_kernel(G, window, bs):
    """On the card: the decode kernel's output equals, bit for bit, the
    verify kernel's for each real query of a draft block, as lossless
    speculative serving needs (the two share the epilogue's order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_verify as pv
    k, kq, v, table, _, _, k_amax, v_amax, _ = _inputs(6, G, hot_heads=(0,),
                                                       bs=bs)
    Sq = 3
    rng = np.random.default_rng(16)
    q = (rng.normal(size=(4, Sq, kq.shape[3] * G, kq.shape[4])) * 2).astype(
        np.float32)
    fill = np.array([58, 37, 16, 0], np.int32) * (bs // 16)
    q_pos = fill[:, None] + np.arange(Sq, dtype=np.int32)[None]
    lengths = np.where(fill[:, None] > 0, q_pos + 1, 0).astype(np.int32)
    q_pos = np.where(fill[:, None] > 0, q_pos, 0).astype(np.int32)
    dev = lambda a: torch.as_tensor(np.array(a), device="cuda")
    pool = tuple(map(dev, (kq, v, table)))
    amax = (dev(k_amax), dev(v_amax))
    cfg = TConfig(alpha=0.4)
    ver = pv.paged_bitstopper_verify(dev(q), *pool, dev(lengths),
                                     dev(q_pos), *amax, cfg=cfg,
                                     window=window)
    real = dev(lengths[:, 0] > 0)
    for s in range(Sq):
        dec = pd.paged_bitstopper_decode(
            dev(q[:, s]), *pool, dev(lengths[:, s]), dev(q_pos[:, s]), *amax,
            cfg=cfg, window=window)
        for field in ("out", "rounds", "survivors", "v_fetched"):
            assert torch.equal(getattr(dec, field)[real],
                               getattr(ver, field)[:, s][real]), (s, field)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [512, 1024])
def test_cuda_striped_kernel_on_pages_that_die_whole(bs):
    """On the card: the striped walk on pages where every row of a KV head
    dies, after a hot page and between live ones (a block that leaves such
    a page early must not race the next page's reset), 50 launches each of
    the decode and the verify: every one equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_verify as pv
    ops = _dead_page_inputs(bs)
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = (
        torch.as_tensor(np.array(a), device="cuda") for a in ops)
    cfg = TConfig(alpha=0.4)
    args = (q, kq, v, table, lengths, q_pos, k_amax, v_amax)
    ref = pd.paged_bitstopper_decode_plain(*args, cfg=cfg)
    vargs = (q[:, None], kq, v, table, lengths[:, None].contiguous(),
             q_pos[:, None].contiguous(), k_amax, v_amax)
    for i in range(50):
        ker = pd.paged_bitstopper_decode(*args, cfg=cfg)
        ver = pv.paged_bitstopper_verify(*vargs, cfg=cfg)
        for field in ("rounds", "survivors", "v_fetched"):
            assert torch.equal(getattr(ker, field), getattr(ref, field)), \
                (i, field)
            assert torch.equal(getattr(ver, field)[:, 0],
                               getattr(ker, field)), (i, field)
        assert float((ker.out - ref.out).abs().max()) <= 1e-5, i
        assert torch.equal(ver.out[:, 0], ker.out), i


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [16, 64, 512])
def test_cuda_kernel_copies_reachable_planes(bs):
    """On the card: the kernel's own count of the bytes it requested is
    every plane of every reachable page and V only of pages where some
    query head of the KV head has a survivor; a launch without stats adds
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(
        7, 2, hot_heads=(0,), bs=bs)
    args = tuple(torch.as_tensor(np.array(a), device="cuda")
                 for a in (q, kq, v, table, lengths, q_pos, k_amax, v_amax))
    cfg = TConfig(alpha=0.4)
    pd.copied_bytes()
    res = pd.paged_bitstopper_decode(*args, cfg=cfg)
    pd.paged_bitstopper_decode(*args, cfg=cfg, stats=False)
    planes, v_bytes = pd.copied_bytes()
    P, bits, bs8, Hkv, D = kq.shape
    pages = int(sum(-(-int(n) // bs) for n in lengths))
    assert planes == pages * Hkv * bits * bs8 * D
    B, Hq, _ = q.shape
    live = res.survivors.reshape(B, Hkv, Hq // Hkv, -1, bs).any(4).any(2)
    assert 0 < int(live.sum()) < pages * Hkv
    assert v_bytes == int(live.sum()) * bs * v.shape[-1] * 4


def test_runtime_resolution(monkeypatch):
    """No silent fallback: an unknown device or a missing nvcc raises."""
    from repro_torch.kernels import runtime
    assert runtime.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        runtime.resolve_device("meta")
    monkeypatch.setattr(runtime.shutil, "which", lambda name: None)
    monkeypatch.setattr(runtime.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        runtime.nvcc_path()


@pytest.mark.gpu
@pytest.mark.parametrize("bs,G,quantize_v,dead", [
    (16, 2, True, False), (16, 4, False, False), (64, 2, True, False),
    (512, 4, True, True), (1024, 1, True, False)])
def test_cuda_kernel_bf16_v_matches_plain(bs, G, quantize_v, dead):
    """On the card, a bf16 V pool (``cache_dtype="bfloat16"``): the kernel
    against the plain version on the same tensors, rounds, survivors and
    V fetches exactly and out within 1e-5; bit for bit the f32 kernel's on
    the widened pool (V is widened exactly in shared memory); V bytes
    requested half the f32 form's.  Pages of 512 and 1024 run the striped
    walk; ``dead`` gives it pages where every row dies, repeated 20
    times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops = _dead_page_inputs(bs) if dead else _inputs(3, G, hot_heads=(0,),
                                                     bs=bs)
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = (
        torch.as_tensor(np.array(a), device="cuda") for a in ops)
    vb = v.to(torch.bfloat16)
    cfg = TConfig(alpha=0.4, quantize_v=quantize_v)
    args = (q, kq, vb, table, lengths, q_pos, k_amax, v_amax)
    ref = pd.paged_bitstopper_decode_plain(*args, cfg=cfg)
    pd.copied_bytes()
    wide = pd.paged_bitstopper_decode(q, kq, vb.float(), *args[3:], cfg=cfg)
    _, v32 = pd.copied_bytes()
    for i in range(20 if dead else 1):
        ker = pd.paged_bitstopper_decode(*args, cfg=cfg)
        _, v16 = pd.copied_bytes()
        for field in ("rounds", "survivors", "v_fetched"):
            assert torch.equal(getattr(ker, field), getattr(ref, field)), \
                (i, field)
        assert float((ker.out - ref.out).abs().max()) <= 1e-5, i
        assert torch.equal(ker.out, wide.out), i
        assert 0 < v16 and 2 * v16 == v32, (i, v16, v32)
    if dead:
        live = ker.survivors.reshape(4, 2, 4, 4, bs).any(4).any(2)
        assert live.int().tolist() == _DEAD_PAGE_LIVE
