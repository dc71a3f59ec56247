"""The port's examples (``examples/torch_*.py``) on the CPU at their small
defaults, each run in process through its ``main`` and held to the
reference example beside it (``examples/*.py``, imported in process from
its path): the index lines (the BANANA BWT and row, the query counts, the
dedup and contamination figures, the model size) must be the same text,
with wall times and the device count masked.  The reference's training
loop is stubbed: only its lines before the training are compared (the
two packages draw different weights).
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name: str):
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(fn, *args) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def _masked(lines) -> list:
    """Wall times and device counts out of the lines."""
    out = []
    for ln in lines:
        ln = re.sub(r"\d+\.\ds\b", "<s>", ln)
        out.append(re.sub(r"on \d+ device\(s\)", "on <n> device(s)", ln))
    return out


def _reference(name: str, monkeypatch, argv=(), **stubs) -> list:
    mod = _load(name)
    for attr, value in stubs.items():
        monkeypatch.setattr(mod, attr, value)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    if hasattr(mod, "main"):
        return _lines(mod.main)
    return _lines(lambda: (mod.banana(), mod.first_index(),
                           print("quickstart OK")))


def test_quickstart_lines_equal_reference(monkeypatch):
    got = _lines(_load("torch_quickstart").main, ["--device", "cpu"])
    assert got[0].startswith("bwt(BANANA$) = ANNB$AA   I = 4")
    assert got == _reference("quickstart", monkeypatch)


def test_index_corpus_lines_equal_reference(monkeypatch):
    got = _lines(_load("torch_index_corpus").main, ["--device", "cpu"])
    assert got[-1] == "index_corpus OK"
    assert got[2] == "contamination: sequences [0] leak into corpus"
    assert _masked(got) == _masked(_reference("index_corpus", monkeypatch))


def test_train_lm_lines_equal_reference(monkeypatch):
    got = _lines(_load("torch_train_lm").main,
                 ["--device", "cpu", "--steps", "2"])
    assert got[-1] == "train_lm OK"
    assert re.fullmatch(r"loss: \d+\.\d{3} -> \d+\.\d{3} over 2 steps",
                        got[-2])
    # the reference trains no step here: its lines up to the dedup figure
    ref = _reference("train_lm", monkeypatch, ["--steps", "2"],
                     train=lambda *a, **k: {"losses": [2.0] * 10 + [1.0] * 10})
    assert got[:2] == ref[:2]
    assert got[0].startswith("model: ") and got[1].startswith("dedup: ")


def test_serve_queries_prints_its_lines():
    got = _lines(_load("torch_serve_queries").main, ["--device", "cpu"])
    assert re.fullmatch(r"FM serving: batch=256 p50=\d+\.\dms -> \d+ "
                        r"queries/s", got[0])
    assert re.fullmatch(r"fm-server: \d+ queries in \d+ batches, .*", got[1])
    assert re.fullmatch(r"LM decode: 4x24 tokens, \d+ tok/s", got[2])
    assert got[3:] == ["serve_queries OK"]


def test_index_corpus_english_on_the_cpu():
    got = _lines(_load("torch_index_corpus").main,
                 ["--device", "cpu", "--kind", "english"])
    assert got[0].startswith("built english index over 66048 tokens")
    assert got[-1] == "index_corpus OK"
