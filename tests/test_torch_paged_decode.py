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


def _inputs(seed, G, hot_heads=()):
    """Kernel operands; query heads of a hot KV head point at its hot
    page."""
    k, v, k_amax, v_amax, hot = _pool(seed, hot_heads=hot_heads)
    rng = np.random.default_rng(seed + 10)
    q = (rng.normal(size=(4, k.shape[2] * G, k.shape[3])) * 2).astype(
        np.float32)
    for h, u in hot.items():
        q[:, h * G:(h + 1) * G] = 8.0 * u + 0.05 * q[:, h * G:(h + 1) * G]
    q_pos = np.maximum(_LENGTHS - 1, 0).astype(np.int32)
    kq = np.asarray(jq.pack_pool_planes(jnp.asarray(k), jnp.asarray(k_amax)))
    return k, kq, v, _TABLE, _LENGTHS, q_pos, k_amax, v_amax, q


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
@pytest.mark.parametrize("alpha,window,G,min_rounds,quantize_v", _CASES)
def test_cuda_kernel_matches_plain(alpha, window, G, min_rounds,
                                   quantize_v):
    """On the card: the CUDA kernel against the plain version on the same
    CUDA tensors.  Integer observables exact, out within 1e-5 (the kernel's
    expf and summation order differ from the plain version's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(3, G)
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
