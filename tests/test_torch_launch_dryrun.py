"""The port's dry run, perf and report (``repro_torch/launch/{dryrun,perf,
report}.py``) on the CPU: one full-width cell of each family traced on
``meta`` (its argument bytes equal to the specs' sum), perf's variant
tables against the reference's names, ``report`` over a test dry run, and
``chip_smoke.py``'s phase 13 rehearsed at a tiny size (reduced configs,
shorter sequences, the bwt_index cells at 2^12 in a gloo world of one).
The reference's launch modules are read as source, never imported: they
force 512 host devices when imported.
"""

import ast
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tiny models: threads only add contention on a
    shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", _ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


@pytest.mark.parametrize("arch,shape", [
    ("qwen2p5_3b", "train_4k"), ("deepseek_v2_236b", "decode_32k"),
    ("mamba2_1p3b", "long_500k"), ("recurrentgemma_2b", "prefill_32k")])
def test_full_width_cell_traces_on_meta(arch, shape):
    """A full-size cell of each family (dense train with 128 micro-batches,
    MLA + MoE decode over a 32k cache, SSM decode at 512k, the hybrid's
    32k prefill) runs on ``meta``; its argument bytes are the specs'."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import tree_nbytes

    rec = dryrun.run_cell(arch, shape)
    assert rec["status"] == "traced"
    _, _, args = dryrun.cell_inputs(get_config(arch), shape)
    assert rec["argument_bytes"] == {k: tree_nbytes(v.tree)
                                     for k, v in args.items()}
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(rec["argument_bytes"]
                                                 .values())
    assert mem["total_bytes"] == (mem["argument_size_in_bytes"]
                                  + mem["temp_size_in_bytes"])
    assert rec["counts"]["flops"] > 0 and rec["counts"]["bytes"] > 0
    assert 0 < rec["roofline"]["useful_flops_ratio"]
    if shape == "train_4k":
        assert (rec["n_micro"], rec["n_micro_rule"]) == (128, 128)
        # one micro-batch of 2 x 4096 traced, its counts times 128
        assert rec["counts"]["flops"] == 128 * rec["micro_batch"]["flops"] \
            + rec["update"]["flops"]


def _reference_variants() -> dict:
    """{target: variant names} of the reference's perf.py, read as
    source (the ``all_variants`` dict of each target function)."""
    tree = ast.parse((_ROOT / "src/repro/launch/perf.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and getattr(node.targets[0], "id", "") == "all_variants"):
                out[fn.name] = [k.value for k in node.value.keys]
    return out


def test_perf_variants_are_the_reference_names(tmp_path):
    """The reference's variant names, in its order; the four that change
    only the sharding rules come back as per-rank 16x16 estimates."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import perf

    ref = _reference_variants()
    assert set(ref) == set(perf.TARGETS)
    assert list(perf.QWEN_VARIANTS) + list(perf.QWEN_MESH_VARIANTS) == \
        ref["qwen_train"]
    assert list(perf.MUSICGEN_VARIANTS) == ref["musicgen_decode"]
    assert list(perf.BWT_VARIANTS) == ref["bwt_build"]
    runs = perf.qwen_train(list(perf.QWEN_MESH_VARIANTS), out_dir=tmp_path,
                           device="cpu", config_of=get_reduced_config)
    assert [(r["variant"], r["status"], r["mesh"]) for r in runs] == [
        (v, "estimated", "16x16") for v in perf.QWEN_MESH_VARIANTS]


def test_report_renders_a_dry_run(tmp_path, capsys):
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun, report

    recs = dryrun.main(["--arch", "minitron_4b", "--out", str(tmp_path)],
                       config_of=get_reduced_config)
    assert [r["status"] for r in recs] == ["traced"] * 3 + ["skipped"]
    spec_only = dryrun.main(["--arch", "mamba2_1p3b", "--shape", "train_4k",
                             "--no-compile", "--out", str(tmp_path / "s")],
                            config_of=get_reduced_config)
    assert spec_only[0]["status"] == "specs"
    capsys.readouterr()
    report.main(["--dryrun", str(tmp_path), "--perf",
                 str(tmp_path / "none")])
    out = capsys.readouterr().out
    assert out.count("| minitron_4b |") == 4 + 3     # matrix + roofline
    assert "skipped (pure full-attention arch" in out
    assert "summary: {'traced': 3, 'measured': 0, 'skipped': 1" in out
    assert report.fmt_bytes(3 * 1024**3) == "3.0GB"


def test_english_corpus_equals_the_reference():
    from repro.data.corpus import corpus as ref_corpus

    from repro_torch.data.corpus import corpus

    for n in (0, 1, 7, 4096, 30011):
        for seed in (0, 4):
            a, b = ref_corpus("english", n, seed), corpus("english", n, seed)
            assert a.dtype == b.dtype and np.array_equal(a, b), (n, seed)


@pytest.fixture
def short_shapes(monkeypatch):
    """The four shapes at shorter sequences: the rehearsal traces and
    runs every cell on the CPU."""
    from repro_torch.launch.specs import SHAPES

    for name, seq in (("train_4k", 256), ("prefill_32k", 2048),
                      ("decode_32k", 512), ("long_500k", 1024)):
        monkeypatch.setitem(SHAPES, name, dict(SHAPES[name], seq_len=seq))


def test_phase_launch_runs_on_the_cpu(short_shapes, capsys):
    """Phase 13 on the CPU: every LM cell traced or skipped for the
    reference's reason, both index cells measured with their kernels'
    reported bytes, the subset of production mesh cells traced for one
    rank in meta worlds, perf's measured variants and its rule-set
    variants' per-rank estimates, report's tables, and the meta world
    estimates of phases 14 (b) and 15 (b)."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.configs.bwt_index import reduced

    cs = _chip_smoke()
    rec, launches = cs.phase_launch(
        device="cpu", config_of=get_reduced_config, icfg=reduced(), jobs=1,
        max_decode_batch=2, world_config="get_reduced_config")
    assert rec["lm_traced"] == 32
    mesh = rec["mesh_cells"]
    assert sorted(mesh) == sorted("__".join(c)
                                  for c in cs.LAUNCH_MESH_SUBSET)
    assert all(v["status"] == "traced" and v["collective_bytes"] > 0
               for v in mesh.values())
    assert {k: v["chips"] for k, v in mesh.items()
            if k.startswith("qwen2p5_3b")} == {
        "qwen2p5_3b__train_4k__16x16": 256,
        "qwen2p5_3b__train_4k__2x16x16": 512}
    assert set(rec["world_peak_estimates"]) == {"lm_world_train",
                                                "lm_world_full"}
    assert sum(c["status"] == "skipped" for c in rec["lm_cells"].values()) \
        == 8
    assert rec["dryrun_index_build"]["kernel_bytes"]["char_histogram"] > 0
    assert rec["dryrun_index_serve"]["kernel_bytes"]["rank_select"] > 0
    assert rec["dryrun_index_build"]["roofline"]["collective_bytes_per_"
                                                 "device"] > 0
    perf = rec["perf"]
    assert {k for k, v in perf.items() if v["status"] == "measured"} == {
        "qwen_train/baseline", "qwen_train/dots_remat",
        "musicgen_decode/baseline", "musicgen_decode/fp8_cache",
        "bwt_build/baseline", "bwt_build/rounds10",
        "bwt_build/rounds10_cap125", "bwt_build/bitonic"}
    assert perf["qwen_train/micro1"]["status"] == "estimated"
    for v in ("fsdp_v2", "fsdp_v2_dots", "fsdp_v3", "fsdp_v3_dots"):
        assert perf[f"qwen_train/{v}"]["status"] == "estimated"
        assert perf[f"qwen_train/{v}"]["mesh"]["collective_bytes"] > 0
    assert "mesh" in perf["qwen_train/baseline"]
    assert all(perf[f"bwt_build/{v}"]["sa_equals_baseline"]
               for v in ("rounds10", "bitonic"))
    assert set(launches) == {"dryrun_index_build", "dryrun_index_serve",
                             "perf_bwt_build"}
    assert all(sum(v.values()) == 0 for v in launches.values())   # CPU
    out = capsys.readouterr().out
    assert "## Perf variants" in out and "| qwen_train | baseline |" in out
    assert "## Production mesh cells, per rank" in out
    assert "| qwen2p5_3b | train_4k | 2x16x16 | 0 |" in out


def test_check_launch_cell_refuses_broken_readings():
    cs = _chip_smoke()
    cell = {"measured_s": 1.0, "bound_s": 0.5, "bound_by": "bytes",
            "peak_bytes": 110, "estimate": {"memory": {"total_bytes": 100}}}
    cs.check_launch_cell(cell, "ok")
    with pytest.raises(AssertionError, match="under its bytes bound"):
        cs.check_launch_cell(dict(cell, measured_s=0.4), "fast")
    with pytest.raises(AssertionError, match="exceeds its estimate"):
        cs.check_launch_cell(dict(cell, peak_bytes=111), "peak")
