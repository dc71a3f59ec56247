"""Package rules of the port: it imports neither JAX nor the JAX package,
its entry points refuse to run without a GPU unless the caller asks for the
CPU, and its kernel wrappers take the plain version only for CPU tensors.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import pipeline
from repro_torch.data.corpus import corpus
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.launch import serve
from repro_torch.serving.engine import FMQueryServer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"ops.py", "fm_index.py", "pipeline.py", "engine.py",
            "chip_smoke.py", "torch_quickstart.py", "torch_index_corpus.py",
            "torch_serve_queries.py", "torch_train_lm.py"} <= names
    assert {p.name for p in (ROOT / "src" / "repro_torch" / "kernels" /
                             "csrc").glob("*.cu")} == {
        f"{k}.cu" for k in _build.SOURCES}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_need_gpu_unless_cpu_given(no_gpu):
    toks = corpus("dna", 500)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.build_index(toks)
    index = pipeline.build_index(toks, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FMQueryServer(index)
    assert FMQueryServer(index, device="cpu").count([toks[:5]])[0] >= 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--n", "500", "--batch", "2", "--batches", "1"])


def test_kernel_wrappers_cpu_plain_cuda_checked(monkeypatch):
    """CPU tensors never reach a kernel library; the CUDA-path argument
    check refuses anything that is not a contiguous int32 CUDA tensor."""
    def no_library(name):
        raise AssertionError(f"kernel library {name} requested")

    monkeypatch.setattr(_build, "library", no_library)
    before = dict(_build.LAUNCHES)
    q = torch.zeros(4, dtype=torch.int32)
    blocks = torch.from_numpy(np.arange(256, dtype=np.int32).reshape(4, 64))
    assert ops.rank_select(blocks, q, q + 5, q + 64).tolist() == [1, 1, 1, 1]
    assert _build.LAUNCHES == before
    assert _build.on_cpu(q, blocks)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda("rank_select", q)
    _build.reset_launches()
    assert set(_build.LAUNCHES.values()) == {0}
