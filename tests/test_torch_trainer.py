"""Checkpoints and the Trainer held against the JAX package on the CPU.

The pytree checkpoints as ``tests/test_substrate.py`` holds the
reference's (roundtrip, atomicity, async save and retention); both
directions between the packages, leaf for leaf, with equal manifests and
leaf paths; and the Trainer on reduced stablelm-1.6b: six steps beside the
reference's Trainer started from the same weights (a port checkpoint at
step 0), a run of 3 steps resumed for 3 more equal to a straight run of 6
bit for bit, the port resumed from the reference's step-3 checkpoint, one
microbatched step beside the reference's, and
``python -m repro_torch.launch.train --device cpu``.  The reference's
Trainer compiles its step once, for the whole file."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JC
from repro.configs import reduced_config as jreduced
from repro.data import DataConfig as JDataConfig
from repro.train import train_step as JS
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import init_opt_state
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import store as TC
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "stablelm-1.6b"
STEPS = 6
LOSS_RTOL = 1e-5
# Parameters after six steps, every element: the largest gap measured is
# 9.7e-7 (six updates of lr 1e-3, each a step of about unit size per
# element, from gradients equal to ~1e-6 of their scale).  Adam's
# normalisation would amplify a last-bit gradient gap only where |g| is
# near eps; no element needs more room than this bound here.
PARAM_ATOL = 2e-6
# One reference step compiled without LLVM's costly passes (half the
# compile time, values an ulp or so from the default build's).
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.as_tensor(rng.normal(size=(4, 8)).astype(np.float32)),
            "nest": {"b": torch.arange(6, dtype=torch.int32),
                     "c": [torch.ones(3),
                           torch.zeros(2, dtype=torch.bfloat16)]}}


def _leaves_equal(a, b):
    for x, y in zip(TO.tree_leaves(a), TO.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# Checkpoints (tests/test_substrate.py's, for the port)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_atomicity_async_and_gc(tmp_path):
    """Roundtrip (bf16 and int leaves too); a stale staging dir never
    shadows the last promoted step; async saves with keep=2 leave the two
    newest, and restore takes the latest."""
    tree = _tree()
    TC.save_checkpoint(tree, str(tmp_path / "a"), 7, n_shards=3)
    restored, step = TC.load_checkpoint(_tree(1), str(tmp_path / "a"))
    assert step == 7
    _leaves_equal(restored, tree)
    TC.save_checkpoint(tree, str(tmp_path / "b"), 1)
    os.makedirs(tmp_path / "b" / "step_00000002.tmp")
    assert TC.latest_step(str(tmp_path / "b")) == 1
    assert TC.load_checkpoint(_tree(1), str(tmp_path / "b"))[1] == 1
    mgr = TC.CheckpointManager(str(tmp_path / "c"), keep=2)
    live = _tree(10)
    for s in (10, 20, 30):
        mgr.save_async(live, s)
        live["a"].add_(1.0)        # the save holds the tree of its call
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path / "c")
                   if n.startswith("step_"))
    assert steps == [20, 30]
    got, latest = mgr.restore(_tree(0))
    assert latest == 30
    np.testing.assert_array_equal(got["a"].numpy(),
                                  _tree(10)["a"].numpy() + 1.0 + 1.0)
    with pytest.raises(FileNotFoundError):
        TC.load_checkpoint(_tree(0), str(tmp_path / "none"))


def _state(seed=0):
    cfg = reduced_config(ARCH)
    tcfg = TS.TrainConfig(grad_compression="int8_ef")
    return cfg, TS.init_train_state(cfg, tcfg,
                                    torch.Generator().manual_seed(seed))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "MANIFEST.json")) as f:
        return json.load(f)


def test_checkpoints_cross_between_packages(tmp_path):
    """A port train state (params, moments, step, err) in the reference's
    layout: the reference's save_checkpoint of the same tree writes an equal
    manifest (leaf paths such as ``params/seg0/b0/attn/wq/w`` and
    ``opt/step``); each package loads the other's checkpoint leaf for leaf,
    and the port's load unstacks the scanned segment."""
    cfg, state = _state()
    host = TS.state_to_numpy(state, cfg)
    TC.save_checkpoint(host, str(tmp_path / "port"), 3)
    JC.save_checkpoint(jax.tree.map(jnp.asarray, host),
                       str(tmp_path / "ref"), 3)
    mp, mr = (_manifest(str(tmp_path / d), 3) for d in ("port", "ref"))
    assert mp == mr
    assert "params/seg0/b0/attn/wq/w" in mp["paths"]
    assert {"opt/step", "opt/m/seg0/b0/ffn/wo/w",
            "err/embed/table"} <= set(mp["paths"])
    like = jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), host)
    for d in ("port", "ref"):
        jtree, step = JC.load_checkpoint(like, str(tmp_path / d))
        ttree, tstep = TC.load_checkpoint(host, str(tmp_path / d))
        assert step == tstep == 3
        for a, b, c in zip(jax.tree.leaves(jtree), jax.tree.leaves(ttree),
                           jax.tree.leaves(host)):
            assert np.asarray(a).dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(np.asarray(a), c)
            np.testing.assert_array_equal(b, c)
        back = TS.state_from_numpy(ttree, cfg)
        _leaves_equal(back["params"], state["params"])
        _leaves_equal(back["opt"]["m"], state["opt"]["m"])
        _leaves_equal(back["err"], state["err"])
        assert back["opt"]["step"].dtype == torch.int32
        assert all(p.requires_grad for p in TO.tree_leaves(back["params"]))
    assert len(state["params"]["seg0"]) == 2
    assert host["params"]["seg0"]["b0"]["attn"]["wq"]["w"].shape[0] == 2


def test_c13_bf16_checkpoints_load_in_the_port_only(tmp_path):
    """C13: a bf16 leaf (bf16 moments, bf16 parameters) is stored by
    ``np.savez`` under the 2-byte void type, which the reference's own
    ``load_checkpoint`` cannot cast back (``ValueError``); the port loads
    the reference's file and its own, the same bits."""
    bits = np.array([0x3F80, 0xC000, 0x0001], np.uint16)
    leaf = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    JC.save_checkpoint({"m": leaf}, str(tmp_path / "ref"), 1)
    with pytest.raises(ValueError):
        JC.load_checkpoint({"m": leaf}, str(tmp_path / "ref"))
    like = {"m": torch.zeros(3, dtype=torch.bfloat16)}
    got, _ = TC.load_checkpoint(like, str(tmp_path / "ref"))
    np.testing.assert_array_equal(got["m"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    TC.save_checkpoint(got, str(tmp_path / "port"), 1)
    again, _ = TC.load_checkpoint(like, str(tmp_path / "port"))
    assert torch.equal(again["m"].view(torch.int16),
                       got["m"].view(torch.int16))


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------

_DATA = dict(seq_len=32, global_batch=4, seed=0)


def _tcfg(mod_cfg, mod_adamw):
    return mod_cfg(optimizer=mod_adamw(lr=1e-3), warmup_steps=2,
                   total_steps=STEPS)


def _port_trainer(d, steps, ckpt_every=100):
    cfg = reduced_config(ARCH)
    return Trainer(cfg, _tcfg(TS.TrainConfig, TO.AdamWConfig),
                   TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=str(d), log_every=0),
                   data_cfg=DataConfig(vocab=cfg.vocab, **_DATA),
                   device="cpu")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's Trainer over six steps from the port's seeded
    initial state (written as a step-0 checkpoint), saving at step 3."""
    d = tmp_path_factory.mktemp("ref_trainer")
    cfg = reduced_config(ARCH)
    state = TS.init_train_state(cfg, _tcfg(TS.TrainConfig, TO.AdamWConfig),
                                torch.Generator().manual_seed(0), "cpu")
    TC.save_checkpoint(TS.state_to_numpy(state, cfg), str(d), 0)
    jcfg = jreduced(ARCH)
    tr = JTrainer(jcfg, _tcfg(JS.TrainConfig, JAdamW),
                  JTrainerConfig(steps=STEPS, ckpt_every=3,
                                 ckpt_dir=str(d), log_every=0),
                  data_cfg=JDataConfig(vocab=jcfg.vocab, **_DATA))
    final = tr.train()
    return {"dir": d, "metrics": tr.metrics_log,
            "params": jax.tree.map(np.asarray, final["params"])}


def _close(got, want, rtol=LOSS_RTOL):
    assert abs(got - want) <= rtol * abs(want), (got, want)


def test_trainer_matches_reference(tmp_path, reference_run):
    """Six steps: per-step loss and grad norm within 1e-5 relative of the
    reference's Trainer, the parameters within PARAM_ATOL, ``opt/step`` 6
    in the final checkpoint."""
    tr = _port_trainer(tmp_path / "port", STEPS)
    state = tr.train()
    assert len(tr.metrics_log) == STEPS
    for got, want in zip(tr.metrics_log, reference_run["metrics"]):
        _close(got["loss"], want["loss"])
        _close(got["grad_norm"], want["grad_norm"])
        assert np.isfinite(got["step_time"])
    got = TS.state_to_numpy(state, tr.cfg)["params"]
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(reference_run["params"])):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)
    final, step = TC.load_checkpoint(TS.state_to_numpy(state, tr.cfg),
                                     str(tmp_path / "port"))
    assert step == STEPS and int(final["opt"]["step"]) == STEPS


def test_resume_is_bit_exact(tmp_path):
    """train(3) then a fresh Trainer's resumed train(6) equals a straight
    train(6) bit for bit (batch_at(step) replays the data; the checkpoint
    carries the moments and the step)."""
    straight = _port_trainer(tmp_path / "a", STEPS).train()
    first = _port_trainer(tmp_path / "b", 3)
    first.train()
    resumed = _port_trainer(tmp_path / "b", STEPS)
    state = resumed.train()
    assert len(resumed.metrics_log) == STEPS - 3
    for key in ("params", "err"):
        if key in straight:
            _leaves_equal(state[key], straight[key])
    _leaves_equal(state["opt"]["m"], straight["opt"]["m"])
    _leaves_equal(state["opt"]["v"], straight["opt"]["v"])
    assert int(state["opt"]["step"]) == STEPS


def test_failed_step_is_retried(tmp_path, monkeypatch):
    """A step that raises is run again (``max_retries``), with the state
    it was given; one that keeps failing re-raises."""
    tr = _port_trainer(tmp_path / "a", 2)
    real, calls = tr._step, []

    def flaky(state, batch):
        calls.append(len(tr.metrics_log))
        if len(calls) == 1:
            raise RuntimeError("transient")
        return real(state, batch)

    monkeypatch.setattr("time.sleep", lambda s: None)
    tr._step = flaky
    tr.train()
    assert calls == [0, 0, 1] and len(tr.metrics_log) == 2
    bad = _port_trainer(tmp_path / "b", 1)
    bad._step = lambda state, batch: (_ for _ in ()).throw(
        RuntimeError("persistent"))
    with pytest.raises(RuntimeError, match="persistent"):
        bad.train()


def test_resume_from_reference_checkpoint(tmp_path, reference_run):
    """The port resumed from the reference's step-3 checkpoint reproduces
    the reference's losses and grad norms at steps 4-6."""
    d = tmp_path / "from_ref"
    shutil.copytree(reference_run["dir"] / "step_00000003",
                    d / "step_00000003")
    tr = _port_trainer(d, STEPS)
    tr.train()
    assert len(tr.metrics_log) == 3
    for got, want in zip(tr.metrics_log, reference_run["metrics"][3:]):
        _close(got["loss"], want["loss"])
        _close(got["grad_norm"], want["grad_norm"])


def test_microbatched_step_matches_reference():
    """One train step with microbatches=2 (and int8_ef, which on one device
    carries ``err`` unchanged): loss and grad norm within 1e-5 relative,
    updated parameters within 1e-6 absolute, ``opt/step`` exact."""
    jcfg, tcfg = jreduced(ARCH), reduced_config(ARCH)
    tparams = TS.trainable(T.init_model(tcfg,
                                         torch.Generator().manual_seed(0)))
    jparams = jax.tree.map(jnp.asarray, T.params_to_numpy(tparams, tcfg))
    cfg = TS.TrainConfig(microbatches=2, grad_compression="int8_ef",
                         warmup_steps=1, total_steps=4)
    jcfg_t = JS.TrainConfig(microbatches=2, grad_compression="int8_ef",
                            warmup_steps=1, total_steps=4)
    batch = np.random.default_rng(0).integers(
        0, tcfg.vocab, (4, 16)).astype(np.int32)
    jstate = {"params": jparams,
              "opt": init_opt_state(jparams, jcfg_t.optimizer),
              "err": jax.tree.map(jnp.zeros_like, jparams)}
    jnew, jm = jax.jit(JS.make_train_step(jcfg, jcfg_t)).lower(
        jstate, jnp.asarray(batch)).compile(compiler_options=FAST_XLA)(
        jstate, jnp.asarray(batch))
    params = TO.tree_map(lambda p: p.detach().clone().requires_grad_(True),
                         tparams)
    err = TO.tree_map(torch.zeros_like, params)
    state = {"params": params, "opt": TO.init_opt_state(params,
                                                        cfg.optimizer),
             "err": err}
    new, m = TS.make_train_step(tcfg, cfg)(state, torch.as_tensor(batch))
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            LOSS_RTOL * abs(float(jm[key]))
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    assert new["err"] is err
    got = jax.tree.leaves(T.params_to_numpy(new["params"], tcfg))
    for a, b in zip(got, jax.tree.leaves(jnew["params"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def test_launch_train_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` at the reduced
    config, microbatched with int8_ef; ``--mesh production`` is refused
    (mesh training is the next slice)."""
    tr = launch_train.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                            "--seq", "16", "--ckpt-dir", str(tmp_path),
                            "--device", "cpu", "--microbatches", "2",
                            "--grad-compression", "int8_ef"])
    assert "[train] done: 2 steps of stablelm-1.6b on cpu" in \
        capsys.readouterr().out
    assert len(tr.metrics_log) == 2
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert TC.latest_step(str(tmp_path)) == 2
    with pytest.raises(ValueError, match="mesh training"):
        launch_train.main(["--arch", ARCH, "--mesh", "production",
                           "--device", "cpu"])
