"""End to end: the port's ``build_index`` -> ``FMQueryServer`` against the
JAX package's, on the same corpora and request streams, plus the port's
serving launcher.

Every output is an integer, so the tolerance is exact equality.
"""

import numpy as np
import pytest

from repro.configs.bwt_index import reduced as j_reduced
from repro.core.pipeline import build_index as j_build_index
from repro.core.pipeline import prepare_tokens as j_prepare_tokens
from repro.serving.engine import FMQueryServer as JServer
from repro_torch.configs.bwt_index import reduced
from repro_torch.core.pipeline import SAConfig, build_index, prepare_tokens
from repro_torch.data.corpus import corpus
from repro_torch.launch import serve
from repro_torch.serving.engine import FMQueryServer


def _requests(toks, seed, count=60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        L = int(rng.integers(1, 20))
        st = int(rng.integers(0, len(toks) - L))
        pat = toks[st: st + L].copy()
        if i % 11 == 5:
            pat[0] = 999                     # out of alphabet: count 0
        out.append((pat, "locate" if i % 3 == 0 else "count"))
    return out


CASES = {"dna": (5000, 64, 32), "proteins": (3000, 32, 8),
         "english": (3000, 64, 4)}      # kind: (n, sample_rate, sa_rate)


def _serve(server, toks):
    """One server's answers to the shared request stream: two flushes of
    mixed count/locate requests (tickets included), then batched calls."""
    flushes = []
    for seed in (1, 2):
        tickets = [server.submit(p, kind) for p, kind in _requests(toks, seed)]
        res = server.flush()
        flushes.append([
            (t, res[t].kind, res[t].count,
             None if res[t].positions is None else res[t].positions.tolist())
            for t in tickets])
    pats = [p for p, _ in _requests(toks, 3, count=20)]
    return {"flushes": flushes,
            "stats": (server.stats.queries, server.stats.batches),
            "count": server.count(pats).tolist(),
            "locate": [a.tolist() for a in server.locate(pats, k=3)]}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's index and served answers per corpus, once."""
    out = {}
    for kind, (n, sample_rate, sa_rate) in CASES.items():
        toks = corpus(kind, n)
        index = j_build_index(toks, sample_rate=sample_rate,
                              sa_sample_rate=sa_rate)
        out[kind] = (index, _serve(JServer.from_config(index, j_reduced()),
                                   toks))
    return out


@pytest.mark.parametrize("kind", list(CASES))
@pytest.mark.parametrize("local_sort", ["compare", "radix"])
def test_build_and_serve_match_reference(reference, kind, local_sort):
    n, sample_rate, sa_rate = CASES[kind]
    toks = corpus(kind, n)
    got = build_index(toks, sample_rate=sample_rate, sa_sample_rate=sa_rate,
                      sa_config=SAConfig(local_sort=local_sort), device="cpu")
    want, want_answers = reference[kind]
    assert np.array_equal(got.sa.numpy(), np.asarray(want.sa))
    assert np.array_equal(got.bwt.numpy(), np.asarray(want.bwt))
    assert int(got.row) == int(want.row)
    assert (got.sigma, got.length, got.text_length) == (
        want.sigma, want.length, want.text_length)
    gs, ws = got.build_stats.as_dict(), want.build_stats.as_dict()
    assert gs.pop("local_sort") == local_sort
    ws.pop("local_sort")
    assert gs == ws
    server = FMQueryServer.from_config(got, reduced(), device="cpu")
    assert _serve(server, toks) == want_answers


@pytest.mark.parametrize("multiple,sigma,reserve_pad", [
    (64, None, None), (1, None, None), (64, 12, None), (1, 8, False),
])
def test_prepare_tokens_matches_reference(multiple, sigma, reserve_pad):
    toks = corpus("dna", 1000)
    s, sg = prepare_tokens(toks, multiple, sigma, reserve_pad)
    js, jsg = j_prepare_tokens(toks, multiple, sigma, reserve_pad)
    assert sg == jsg and np.array_equal(s, js)


def test_seed_builder_and_unpacked_pipeline():
    toks = corpus("dna", 2000)
    fast = build_index(toks, device="cpu", sa_sample_rate=8)
    slow = build_index(toks, device="cpu", sa_sample_rate=8, fast=False,
                       pack=False)
    want = j_build_index(toks, sa_sample_rate=8, fast=False, pack=False)
    assert slow.build_stats is None and slow.fm.bits == 0
    assert np.array_equal(slow.sa.numpy(), np.asarray(want.sa))
    assert np.array_equal(fast.sa.numpy(), slow.sa.numpy())
    pats = np.array([[1, 2, 3, -1], [4, 4, -1, -1], [2, 3, 1, 2]], np.int32)
    assert np.array_equal(slow.count(pats).numpy(),
                          np.asarray(want.count(pats)))
    assert np.array_equal(fast.count(pats).numpy(),
                          slow.count(pats).numpy())


def test_serve_launcher_runs_on_cpu(capsys):
    out = serve.main(["--n", "3000", "--batch", "8", "--batches", "2",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert "index built over 3000 tokens on cpu" in text
    assert out["total_hits"] > 0 and out["located"] > 0


@pytest.mark.parametrize("flag", [["--engine", "bitonic"],
                                  ["--engine", "samplesort"]])
def test_serve_launcher_unported_flags_raise(flag, monkeypatch):
    """Kept by name from before the mesh build was ported: ``--engine``
    is accepted and reaches the build's ``DistSAConfig`` (the mesh
    build's sort; a single-device build takes its other knobs); an
    engine that does not exist is refused."""
    from repro_torch.core import pipeline
    from repro_torch.core.dist_suffix_array import DistSAConfig

    seen = []
    real = pipeline.build_index

    def spy(*args, **kwargs):
        seen.append(kwargs["sa_config"])
        return real(*args, **kwargs)

    monkeypatch.setattr(pipeline, "build_index", spy)
    out = serve.main(["--n", "1000", "--batch", "4", "--batches", "1",
                      "--device", "cpu", *flag])
    assert seen == [DistSAConfig(engine=flag[1])]
    assert out["total_hits"] > 0
    with pytest.raises(SystemExit):                 # argparse: bad choice
        serve.main(["--n", "1000", "--device", "cpu", "--engine", "radix"])


def test_serve_launcher_in_a_world_of_two(tmp_path):
    """``torch.distributed.run`` starts the launcher as a gloo world of 2
    ranks: it builds by samplesort, saves from both (a ``"dist_fm"``
    checkpoint of 2 parts), then ``--restore`` puts it back on the world;
    only rank 0 prints, and both runs serve the single-process run's
    answers."""
    import json
    import os
    import re
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    argv = ["--n", "3000", "--batch", "8", "--batches", "2", "--device",
            "cpu", "--engine", "samplesort"]
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
              "--", *argv, "--ckpt-dir", str(tmp_path)]
    runs = {}
    for mode, extra in (("build", []), ("restore", ["--restore"])):
        proc = subprocess.run(launch + extra, capture_output=True,
                              text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[mode] = proc.stdout
    assert runs["build"].count("index built over 3000 tokens on cpu, 2 "
                               "ranks (gloo)") == 1
    assert runs["restore"].count("restored dist_fm index") == 1
    single = serve.main(argv)
    for text in runs.values():
        assert re.findall(r"total_hits=(\d+)", text) == [
            str(single["total_hits"])]
        assert re.findall(r"(\d+) positions", text) == [
            str(single["located"])]
    with open(tmp_path / "step_00000000" / "meta.json") as f:
        meta = json.load(f)
    assert (meta["kind"], meta["built_parts"]) == ("dist_fm", 2)


def test_serve_launcher_drops_a_leading_separator():
    """``torch.distributed.run -m ... -- ARGS`` hands some Python releases'
    scripts the ``--`` itself; the launcher reads the arguments after
    it."""
    argv = ["--n", "1000", "--batch", "4", "--batches", "1", "--device",
            "cpu"]
    assert serve.main(["--", *argv]) == serve.main(argv)


def test_serve_launcher_checkpoints_each_build(tmp_path, capsys):
    """--ckpt-dir saves step 0 on the first build and latest + 1 after."""
    from repro_torch.core.index_io import describe_index, latest_index_step

    argv = ["--n", "3000", "--batch", "8", "--batches", "2", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    first = serve.main(argv)
    assert latest_index_step(str(tmp_path)) == 0
    assert serve.main(argv) == first
    assert latest_index_step(str(tmp_path)) == 1
    text = capsys.readouterr().out
    assert "step 0" in text and "step 1" in text
    info = describe_index(str(tmp_path))
    assert (info.kind, info.text_length) == ("fm", 3001)


def test_serve_launcher_restores_with_manifest_n(tmp_path, capsys):
    """--restore serves the saved index, over the corpus size the manifest
    records (not --n), with the built run's answers."""
    base = ["--kind", "proteins", "--batch", "8", "--batches", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    built = serve.main(["--n", "2500", *base])
    restored = serve.main(["--n", "100", "--restore", *base])
    text = capsys.readouterr().out
    assert "using the checkpoint's size" in text
    assert "restored fm index" in text and "index built" in text
    assert restored == built and restored["n"] == 2500


def test_serve_launcher_restore_needs_ckpt_dir():
    with pytest.raises(SystemExit):
        serve.main(["--n", "1000", "--device", "cpu", "--restore"])


def test_mesh_build_not_ported():
    """The mesh build itself is ported (``tests/test_torch_dist_*.py``);
    its mesh must be the port's ``DeviceMesh`` (``launch/mesh.py``), and
    anything else is refused before a build starts."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_index(corpus("dna", 100), mesh=object(), device="cpu")
