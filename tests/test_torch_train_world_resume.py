"""Checkpoints of a world of ranks: a run resumed in the same world repeats
the uninterrupted run bit for bit; a world of 4's checkpoint resumes in a
world of 2, whose checkpoint resumes on one device, within the step
tolerance of the uninterrupted world; a checkpoint the JAX package wrote
from a run on a forced (1, 2, 2) mesh resumes in the port's world of 4;
and the training launcher under ``torch.distributed.run`` with two ranks,
then its ``--resume``.

A world's checkpoint is the JAX package's format, unsharded: each leaf is
gathered whole to rank 0, which alone writes (``training/checkpoint.py``),
and each rank of the resuming world cuts its block as it reads.  The
scenario is ``test_torch_train_resume.py``'s (vocab 128, B = 2, S = 16),
at B = 4 so that the batch splits over data.  The JAX run is this file run
as a script with 8 forced host devices (``--jax-reference OUT``).
"""

import os
import shutil
import subprocess
import sys

if __name__ == "__main__":   # the JAX reference: devices before jax loads
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np
import pytest
import torch
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

MESH4 = {"pod": 1, "data": 2, "model": 2}
MESH2 = {"pod": 1, "data": 1, "model": 2}
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=12)
STEPS, CUT, SEED = 6, 3, 7
STEP_TOL = 1e-5
WORLD_TIMEOUT_S = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scenario():
    """(config, tokens, loader config) of the scenario."""
    from repro_torch.configs import base
    from repro_torch.data.corpus import corpus
    from repro_torch.data.loader import LoaderConfig

    cfg = base.get_reduced_config("qwen2p5_3b").replace(vocab_size=128)
    return cfg, corpus("english", 8000) % 128, LoaderConfig(4, 16, seed=3)


def tcfg(**kw):
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig

    return TrainConfig(opt=AdamWConfig(**ADAMW), checkpoint_every=CUT,
                       log_every=0, **kw)


def run(mesh, steps: int, ckpt_dir: str, resume: bool, compress=False):
    """``train`` of the scenario in this rank's world (``mesh``; None: one
    device): its losses, log lines and final state's leaves."""
    from repro_torch.data.loader import TokenLoader
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import (
        TRAIN_RULES,
        single_device_context,
        world_context,
    )
    from repro_torch.training.train_loop import train

    torch.set_num_threads(1)
    cfg, toks, lcfg = scenario()
    ctx = (single_device_context() if mesh is None
           else world_context(mesh, TRAIN_RULES))
    lines = []
    res = train(cfg, ctx, tcfg(compress_grads=compress), TokenLoader(
        toks, lcfg), steps, ckpt_dir=ckpt_dir, resume=resume, seed=SEED,
        log=lines.append, device="cpu")
    return {"losses": res["losses"], "log": lines,
            "state": tree_leaves(res["state"])}


def bitwise_rank(mesh, root: str, compress: bool) -> dict:
    """The uninterrupted run, the run cut after CUT steps and its resume,
    all in this world."""
    tag = "c" if compress else "p"
    return {"full": run(mesh, STEPS, f"{root}/{tag}_full", False, compress),
            "part": run(mesh, CUT, f"{root}/{tag}_part", False, compress),
            "resumed": run(mesh, STEPS, f"{root}/{tag}_part", True,
                           compress)}


def resume_rank(mesh, ckpt_dir: str, steps: int) -> dict:
    return run(mesh, steps, ckpt_dir, True)


# --------------------------------------------------------------------------
# the JAX reference (script mode): 6 steps on a (1, 2, 2) mesh
# --------------------------------------------------------------------------

def _jax_reference(out_dir: str) -> None:
    import jax
    from jax.sharding import AxisType

    from repro.configs import base as jbase
    from repro.data.loader import LoaderConfig as JLoaderConfig
    from repro.data.loader import TokenLoader as JTokenLoader
    from repro.sharding import TRAIN_RULES, MeshContext
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jtl

    mesh = jax.make_mesh(tuple(MESH4.values()), tuple(MESH4),
                         axis_types=(AxisType.Auto,) * 3,
                         devices=jax.devices()[:4])
    cfg = jbase.get_reduced_config("qwen2p5_3b").replace(vocab_size=128)
    _, toks, lcfg = scenario()
    loader = JTokenLoader(toks, JLoaderConfig(lcfg.batch_size, lcfg.seq_len,
                                              lcfg.seed))
    res = jtl.train(cfg, MeshContext(mesh, TRAIN_RULES), jtl.TrainConfig(
        opt=jopt.AdamWConfig(**ADAMW), checkpoint_every=CUT, log_every=0),
        loader, STEPS, ckpt_dir=f"{out_dir}/ckpt", seed=SEED,
        log=lambda *_: None)
    np.save(f"{out_dir}/losses.npy", np.array(res["losses"], np.float64))


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _world(n, fn, *args, mesh):
    from repro_torch.launch.mesh import run_world

    return run_world(n, fn, *args, mesh_shape=mesh,
                     timeout_s=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """World 4's bitwise scenario (plain and compressed), then its step-3
    checkpoint resumed to step 5 in a world of 2, whose step-5 checkpoint
    resumes to step 6 on one device."""
    root = tmp_path_factory.mktemp("world_resume")
    four = {c: _world(4, bitwise_rank, str(root), c, mesh=MESH4)
            for c in (False, True)}
    step = f"step_{CUT:08d}"
    shutil.copytree(root / "p_full" / step, root / "elastic" / step)
    two = _world(2, resume_rank, str(root / "elastic"), STEPS - 1,
                 mesh=MESH2)
    one = run(None, STEPS, str(root / "elastic"), True)
    return {"four": four, "two": two, "one": one, "root": root}


@pytest.mark.parametrize("compress", [False, True])
def test_a_world_resumes_bit_for_bit(worlds, compress):
    """6 steps against 3 steps and a resume to 6 in a world of 4 (1, 2,
    2): every rank logs the resume, the losses equal bit for bit, every
    rank's final state blocks equal bit for bit."""
    for rank in worlds["four"][compress]:
        full, part, resumed = rank["full"], rank["part"], rank["resumed"]
        assert resumed["log"] == [f"resumed at step {CUT}"]
        assert part["losses"] == full["losses"][:CUT]
        assert resumed["losses"] == full["losses"][CUT:]
        assert len(full["state"]) == len(resumed["state"])
        for a, b in zip(full["state"], resumed["state"]):
            assert np.array_equal(a, b)
    losses = {tuple(r["full"]["losses"]) for r in worlds["four"][compress]}
    assert len(losses) == 1          # the global loss on every rank


def test_a_world_checkpoint_is_the_jax_format(worlds):
    """The world of 4's step-6 checkpoint: one unsharded npz that the JAX
    package's Checkpointer restores into its train-state tree, leaf for
    leaf the whole arrays, equal to the one-device run's state within the
    step tolerance."""
    from repro.configs import base as jbase
    from repro.training import checkpoint as jckpt
    from repro.training import train_loop as jtl

    import jax

    template = jtl.init_train_state(
        jbase.get_reduced_config("qwen2p5_3b").replace(vocab_size=128),
        jax.random.key(0), jtl.TrainConfig())
    restored, meta = jckpt.Checkpointer(
        str(worlds["root"] / "p_full")).restore(template)
    assert meta["step"] == STEPS
    leaves = jax.tree_util.tree_leaves(restored)
    assert [np.shape(a) for a in leaves] == \
        [np.shape(b) for b in worlds["one"]["state"]]
    for a, b in zip(leaves, worlds["one"]["state"]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=1e-4, atol=1e-4)
    assert sorted(os.listdir(worlds["root"] / "p_full"
                             / f"step_{STEPS:08d}")) == ["arrays.npz",
                                                         "meta.json"]


def test_a_world_of_4_resumes_in_2_then_on_one_device(worlds):
    """The world of 4's step-3 checkpoint continues in a world of 2 (1, 1,
    2) to step 5, and that world's checkpoint on one device to step 6:
    the losses within STEP_TOL of the world of 4's own."""
    want = worlds["four"][False][0]["full"]["losses"]
    for rank in worlds["two"]:
        assert rank["log"] == [f"resumed at step {CUT}"]
        np.testing.assert_allclose(rank["losses"], want[CUT:STEPS - 1],
                                   rtol=STEP_TOL, atol=STEP_TOL)
    one = worlds["one"]
    assert one["log"] == [f"resumed at step {STEPS - 1}"]
    np.testing.assert_allclose(one["losses"], want[STEPS - 1:],
                               rtol=STEP_TOL, atol=STEP_TOL)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh_run")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--jax-reference", str(out)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(out / "losses.npy").tolist(), out / "ckpt"


def test_a_jax_mesh_checkpoint_resumes_in_the_world(jax_run, tmp_path):
    """The JAX run on a forced (1, 2, 2) mesh, checkpointed at step 3,
    continues in the port's world of 4 to step 6: the losses within 1e-4
    relative of the JAX run's steps 4-6."""
    want, ckpt = jax_run
    step = f"step_{CUT:08d}"
    shutil.copytree(ckpt / step, tmp_path / step)
    for rank in _world(4, resume_rank, str(tmp_path), STEPS, mesh=MESH4):
        assert rank["log"] == [f"resumed at step {CUT}"]
        np.testing.assert_allclose(rank["losses"], want[CUT:], rtol=1e-4,
                                   atol=0)


@pytest.mark.parametrize("compressed", [False, True])
def test_a_rank_reads_only_its_block_of_a_stored_leaf(tmp_path, compressed):
    """``checkpoint._npz_leaf``: a leaf ``np.savez`` stored uncompressed is
    a read-only memory map of its bytes (C or Fortran order), so a rank's
    cut reads its block; a compressed archive's leaf, a 0-d leaf and an
    empty one are read whole; a missing leaf raises KeyError."""
    from repro_torch.training.checkpoint import _npz_leaf

    arrays = {"params/w": np.arange(24, dtype=np.float32).reshape(4, 6),
              "opt/count": np.array(3, np.int32),
              "f": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
              "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "arrays.npz")
    (np.savez_compressed if compressed else np.savez)(path, **arrays)
    for k, v in arrays.items():
        got = _npz_leaf(path, k)
        mapped = isinstance(got, np.memmap)
        assert mapped == (not compressed and v.ndim > 0 and v.size > 0), k
        assert got.dtype == v.dtype and np.array_equal(np.array(got), v)
    assert np.array_equal(np.array(_npz_leaf(path, "params/w")[2:, 3:]),
                          arrays["params/w"][2:, 3:])
    with pytest.raises(KeyError, match="missing leaf"):
        _npz_leaf(path, "nope")


def _launch(argv, world: int):
    """The training launcher in one process or under torch.distributed.run
    with ``world`` ranks on the CPU; its stdout lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""), OMP_NUM_THREADS="1")
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world), "-m",
             "repro_torch.launch.train", "--"] if world > 1
            else [sys.executable, "-m", "repro_torch.launch.train"])
    proc = subprocess.run(head + argv + ["--device", "cpu"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_the_launcher_trains_and_resumes_in_a_world_of_two(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
    -- --arch qwen2p5_3b --steps 4 --device cpu``: rank 0 alone prints one
    ``final loss``, within 1e-4 of one process's; its step-2 checkpoint
    alone, with ``--resume``, prints the same final loss again."""
    argv = ["--arch", "qwen2p5_3b", "--steps", "4", "--batch", "2",
            "--seq", "16"]
    one = [ln for ln in _launch(argv, 1) if ln.startswith("final loss ")]
    out = _launch([*argv, "--ckpt-dir", str(tmp_path / "a")], 2)
    two = [ln for ln in out if ln.startswith("final loss ")]
    assert len(one) == len(two) == 1
    assert abs(float(two[0].split()[-1]) - float(one[0].split()[-1])) <= 1e-4
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    again = _launch([*argv, "--ckpt-dir", str(tmp_path / "b"), "--resume"], 2)
    assert [ln for ln in again if ln.startswith("resumed at")] == \
        ["resumed at step 2"]
    assert [ln for ln in again if ln.startswith("final loss ")] == two


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_reference(sys.argv[sys.argv.index("--jax-reference") + 1])
