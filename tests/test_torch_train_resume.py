"""Resuming training: the port's bitwise resume (the scenario of
``tests/test_checkpoint.py::TestResume::test_bitwise_resume``), train
states crossing packages through the shared checkpoint format (a JAX run
resumed by the port, a port checkpoint restored by the JAX
``Checkpointer``), and the training launcher's ``--resume``.
"""

import shutil
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import base as jbase
from repro.data.loader import LoaderConfig as JLoaderConfig
from repro.data.loader import TokenLoader as JTokenLoader
from repro.sharding import MeshContext as JMeshContext
from repro.sharding import TRAIN_RULES as J_TRAIN_RULES
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import base
from repro_torch.data.corpus import corpus
from repro_torch.data.loader import LoaderConfig, TokenLoader
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.sharding import single_device_context
from repro_torch.training import checkpoint as port_ckpt
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train

ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=12)
STEPS, CUT, SEED = 12, 6, 7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models here are a few hundred KB, and
    torch's thread pool only adds synchronisation, which turns into
    seconds a step when the host's cores are shared with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def quiet(*_):
    pass


def _scenario(arch="qwen2p5_3b"):
    """test_bitwise_resume's config, corpus and loader (vocab 128)."""
    cfg = base.get_reduced_config(arch).replace(vocab_size=128)
    toks = corpus("english", 8000) % 128
    return cfg, toks, LoaderConfig(2, 16, seed=3)


def _tcfg(**kw):
    return TrainConfig(opt=AdamWConfig(**ADAMW), checkpoint_every=3,
                       log_every=0, **kw)


@pytest.mark.parametrize("arch,compress", [("qwen2p5_3b", False),
                                           ("qwen2p5_3b", True),
                                           ("deepseek_v2_236b", False)])
def test_bitwise_resume(tmp_path, arch, compress):
    """12 steps against 6 steps and a resume to 12: the same losses bit for
    bit (dense, dense with int8 compression, MoE)."""
    cfg, toks, lcfg = _scenario(arch)
    loader = TokenLoader(toks, lcfg)
    tcfg = _tcfg(compress_grads=compress)
    ctx = single_device_context()
    run = dict(seed=SEED, log=quiet, device="cpu")
    full = train(cfg, ctx, tcfg, loader, STEPS, ckpt_dir=str(tmp_path / "a"),
                 **run)
    part = train(cfg, ctx, tcfg, loader, CUT, ckpt_dir=str(tmp_path / "b"),
                 **run)
    lines = []
    resumed = train(cfg, ctx, tcfg, loader, STEPS,
                    ckpt_dir=str(tmp_path / "b"), resume=True, seed=SEED,
                    log=lines.append, device="cpu")
    assert lines == [f"resumed at step {CUT}"]
    assert part["losses"] == full["losses"][:CUT]
    assert torch.equal(torch.tensor(full["losses"][CUT:]),
                       torch.tensor(resumed["losses"]))
    for a, b in zip(jax.tree_util.tree_leaves(train_state_to_numpy(
            full["state"])), jax.tree_util.tree_leaves(train_state_to_numpy(
                resumed["state"]))):
        assert np.array_equal(a, b)
    assert ("err" in full["state"]) == compress


def jax_context():
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    return JMeshContext(mesh, J_TRAIN_RULES)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference's 12 steps, checkpointed every 6 (steps 6 and 12
    kept), run once: its losses and its step-6 checkpoint alone in a
    directory, as a run of 6 steps leaves it (the step is a pure function
    of the state and the batch, so the states are the same)."""
    root = tmp_path_factory.mktemp("jax_run")
    cfg = jbase.get_reduced_config("qwen2p5_3b").replace(vocab_size=128)
    _, toks, lcfg = _scenario()
    loader = JTokenLoader(toks, JLoaderConfig(lcfg.batch_size, lcfg.seq_len,
                                              lcfg.seed))
    tcfg = jtl.TrainConfig(opt=jopt.AdamWConfig(**ADAMW),
                           checkpoint_every=CUT, log_every=0)
    full = jtl.train(cfg, jax_context(), tcfg, loader, STEPS,
                     ckpt_dir=str(root / "full"), seed=SEED, log=quiet)
    name = f"step_{CUT:08d}"
    shutil.copytree(root / "full" / name, root / "cut" / name)
    return [float(x) for x in full["losses"]], root / "cut"


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    """The JAX run's step-6 checkpoint continues in the port to step 12:
    the losses within 1e-4 relative of the JAX run's steps 7-12."""
    want, cut_dir = jax_run
    ckpt_dir = tmp_path / "ckpt"
    shutil.copytree(cut_dir, ckpt_dir)
    cfg, toks, lcfg = _scenario()
    lines = []
    res = train(cfg, single_device_context(), _tcfg(),
                TokenLoader(toks, lcfg), STEPS, ckpt_dir=str(ckpt_dir),
                resume=True, seed=0, log=lines.append, device="cpu")
    assert lines == [f"resumed at step {CUT}"]
    assert len(res["losses"]) == STEPS - CUT
    np.testing.assert_allclose(res["losses"], want[CUT:], rtol=1e-4, atol=0)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """Six port steps saved; the JAX ``Checkpointer.restore`` fills the
    reference's train-state tree with the port's arrays, leaf for leaf."""
    cfg, toks, lcfg = _scenario()
    res = train(cfg, single_device_context(), _tcfg(compress_grads=True),
                TokenLoader(toks, lcfg), CUT, ckpt_dir=str(tmp_path),
                seed=SEED, log=quiet, device="cpu")
    jcfg = jbase.get_reduced_config("qwen2p5_3b").replace(vocab_size=128)
    template = jtl.init_train_state(
        jcfg, jax.random.key(0), jtl.TrainConfig(compress_grads=True))
    restored, meta = jckpt.Checkpointer(str(tmp_path)).restore(template)
    assert meta["step"] == CUT
    want = train_state_to_numpy(res["state"])
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(restored),
                            jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b), path
    assert int(restored["opt"]["count"]) == CUT
    assert restored["opt"]["count"].dtype == jnp.int32


def test_resume_from_an_async_checkpoint(tmp_path, monkeypatch):
    """Checkpoints written in the background while the next steps update
    the state in place: each is the state of its own step.  With every
    write slowed down, a run of 12 steps saved at every step; a copy of
    its step-10 checkpoint (an async one) resumed to 12 repeats steps 11
    and 12 bit for bit and ends in the same state."""
    write = port_ckpt.Checkpointer._write

    def slow_write(self, step, flat, extra):
        time.sleep(0.3)
        write(self, step, flat, extra)

    monkeypatch.setattr(port_ckpt.Checkpointer, "_write", slow_write)
    cfg, toks, lcfg = _scenario()
    tcfg = TrainConfig(opt=AdamWConfig(**ADAMW), checkpoint_every=1,
                       log_every=0)
    run = dict(seed=SEED, log=quiet, device="cpu")
    ctx = single_device_context()
    full = train(cfg, ctx, tcfg, TokenLoader(toks, lcfg), STEPS,
                 ckpt_dir=str(tmp_path / "a"), **run)
    name = f"step_{STEPS - 2:08d}"
    shutil.copytree(tmp_path / "a" / name, tmp_path / "b" / name)
    resumed = train(cfg, ctx, tcfg, TokenLoader(toks, lcfg), STEPS,
                    ckpt_dir=str(tmp_path / "b"), resume=True, **run)
    assert torch.equal(torch.tensor(full["losses"][-2:]),
                       torch.tensor(resumed["losses"]))
    for a, b in zip(jax.tree_util.tree_leaves(train_state_to_numpy(
            full["state"])), jax.tree_util.tree_leaves(train_state_to_numpy(
                resumed["state"]))):
        assert np.array_equal(a, b)


def _final_loss(capsys, argv):
    launch_train.main(argv)
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if ln.startswith("final loss ")]
    assert len(lines) == 1
    return lines[0], [ln for ln in out if ln.startswith("resumed at")]


def test_launcher_resumes(tmp_path, capsys):
    """--device cpu for 4 steps (checkpoints at every step, 2-4 kept),
    then the same command with --resume in a directory that holds only
    the step-2 checkpoint, as a run stopped after step 2 leaves it: it
    resumes there, prints the same final loss, and saves the same step-4
    state bit for bit."""
    argv = ["--arch", "qwen2p5_3b", "--steps", "4", "--batch", "2", "--seq",
            "16", "--device", "cpu"]
    first, _ = _final_loss(capsys, [*argv, "--ckpt-dir", str(tmp_path / "a")])
    assert jckpt.Checkpointer(str(tmp_path / "a")).all_steps() == [2, 3, 4]
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    again, resumed = _final_loss(
        capsys, [*argv, "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert resumed == ["resumed at step 2"] and again == first
    want, got = (port_ckpt.Checkpointer(str(tmp_path / d)).restore_raw(
        4)[0] for d in ("a", "b"))
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(want[k], got[k]), k
