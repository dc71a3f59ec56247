"""The bwt_index config's own workload on the single-device path: english
text built at the config's declared sigma 257 (the byte alphabet and the
sentinel; the data's own alphabet is about 124), held against the JAX
package in process.

Declaring 257 takes the build off the data's path: the q-gram init packs
3 characters of 9 bits into a word (q = 6, where the data's alphabet packs
4 of 7), the Occ checkpoints grow to 258 columns, and every query kernel
takes the unpacked layout.  Inputs: english at n = 5000 and 2^13 + 17,
and an english text of n = 5055 with a planted repeat of 600 tokens, at
the config's sample rates (64 / 32), the planted text also at 16 / 4.
The JAX side compiles once per shape of text and index (a few seconds
each): n = 5000 and 5055 both pad to 5056 at r = 64, and 5055 pads to
5056 at r = 16 too, so the three share the suffix array's shapes; the
served answers are held to the reference's server on those indexes
(the n = 2^13 + 17 index: its build, files and restores).

Every output is an integer (or a float from the same integers), so the
tolerance is exact equality.
"""

import functools
import json
import zipfile

import numpy as np
import pytest
import torch

from repro.configs.bwt_index import CONFIG as J_CONFIG
from repro.core import keypack as jkp
from repro.core.index_io import save_index as j_save_index
from repro.core.pipeline import build_index as j_build_index
from repro.serving.engine import FMQueryServer as JFMQueryServer
from repro_torch.configs.bwt_index import CONFIG
from repro_torch.core import keypack
from repro_torch.core.fm_index import fm_mismatch
from repro_torch.core.index_io import restore_index, save_index
from repro_torch.core.pipeline import build_index
from repro_torch.data.corpus import corpus
from repro_torch.serving.engine import FMQueryServer
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)

SIGMA = CONFIG.sigma                 # 257 declared; 258 with the pad slot
PLANT = (500, 3000, 600)             # copy text[500:1100] over [3000:3600]
# (text, sample_rate, sa_sample_rate)
CASES = [("english_5000", 64, 32), ("english_8209", 64, 32),
         ("planted_5055", 64, 32), ("planted_5055", 16, 4)]
SERVED = [c for c in CASES if c[0] != "english_8209"]
IDS = [f"{t}-r{r}-s{s}" for t, r, s in CASES]
PER_BUCKET = 12                      # requests of each kind per bucket


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _text(name: str) -> np.ndarray:
    kind, n = name.split("_")
    if kind == "english":
        return corpus("english", int(n))
    toks = corpus("english", int(n), seed=1)
    src, dst, length = PLANT
    toks[dst: dst + length] = toks[src: src + length]
    return toks


@functools.lru_cache(maxsize=None)
def _built(name: str, r: int, s: int):
    toks = _text(name)
    kw = dict(sigma=SIGMA, sample_rate=r, sa_sample_rate=s)
    return toks, build_index(toks, device="cpu", **kw), \
        j_build_index(toks, **kw)


def _requests(toks: np.ndarray, seed: int) -> list:
    """PER_BUCKET substrings of the text for each of the config's length
    buckets (lengths up to the bucket, above the one below it; 3 at the
    least), the planted copy's start, and absent patterns."""
    rng = np.random.default_rng(seed)
    out, lo = [], 3
    for hi in CONFIG.serve_length_buckets:
        for L in rng.integers(lo, hi + 1, PER_BUCKET):
            st = int(rng.integers(0, len(toks) - L))
            out.append(toks[st: st + L].copy())
        lo = hi + 1
    out.append(toks[PLANT[0]: PLANT[0] + 64].copy())
    out += [rng.integers(1, SIGMA, L).astype(np.int32) for L in (5, 20, 60)]
    return out


def test_qgram_params_at_the_declared_alphabet():
    """q = 6: three 9-bit characters a word, two words a key; the pad
    fills 27 bits."""
    assert keypack.qgram_params(SIGMA + 1) == jkp.qgram_params(SIGMA + 1) \
        == (6, 3, 9)
    assert keypack.qgram_pad(3, 9) == jkp.qgram_pad(3, 9) == (1 << 27) - 1
    assert keypack.qgram_rounds_skipped(6) == jkp.qgram_rounds_skipped(6)


@pytest.mark.parametrize("name,r,s", CASES, ids=IDS)
def test_build_equals_reference(name, r, s):
    toks, port, ref = _built(name, r, s)
    assert port.sigma == ref.sigma == SIGMA + 1
    assert port.fm.bits == 0                    # the unpacked layout
    assert np.array_equal(port.sa.numpy(), np.asarray(ref.sa))
    assert np.array_equal(port.bwt.numpy(), np.asarray(ref.bwt))
    assert int(port.row) == int(ref.row)
    assert fm_mismatch(port.fm, ref.fm) == []
    assert port.length == ref.length and \
        port.text_length == ref.text_length == len(toks) + 1
    got, want = port.build_stats.as_dict(), vars(ref.build_stats)
    assert got == want
    assert got["q"] == got["h0"] == 6


@pytest.mark.parametrize("name,r,s", SERVED,
                         ids=[f"{t}-r{r}-s{s}" for t, r, s in SERVED])
def test_served_answers_equal_reference(name, r, s):
    """Counts and sorted locates (k = 16) through each package's
    ``FMQueryServer.from_config`` over the buckets 8 to 64."""
    toks, port, ref = _built(name, r, s)
    reqs = _requests(toks, r + s)
    served = FMQueryServer.from_config(port, CONFIG, device="cpu")
    j_served = JFMQueryServer.from_config(ref, J_CONFIG)
    counts = served.count(reqs)
    assert np.array_equal(counts, j_served.count(reqs))
    assert (counts[:-3] >= 1).all() and (counts[-3:] == 0).all()
    if name.startswith("planted"):
        assert counts[-4] >= 2
    buckets = {served._bucket_len(len(q)) for q in reqs}
    assert buckets == set(CONFIG.serve_length_buckets)
    got, want = served.locate(reqs), j_served.locate(reqs)
    for q, c, a, b in zip(reqs, counts, got, want):
        assert len(a) == min(int(c), CONFIG.locate_k)
        assert np.array_equal(np.sort(a), np.sort(np.asarray(b)))
        for p in a:
            assert np.array_equal(toks[p: p + len(q)], q)


def _strip_layout(directory) -> None:
    """The checkpoint without the single-device layout (the reference's
    ``dist_fm`` kind), which a restore derives again."""
    step = directory / "step_00000000"
    with np.load(str(step / "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files
                if k not in ("c_array", "occ_samples", "fused")}
    np.savez(str(step / "arrays.npz"), **flat)
    meta = json.loads((step / "meta.json").read_text())
    meta["kind"] = "dist_fm"
    meta["arrays"] = sorted(flat)
    (step / "meta.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("name,r,s", CASES, ids=IDS)
def test_restores_and_files_equal_reference(name, r, s, tmp_path):
    """Both packages write the same files, member for member byte for
    byte; the stored-layout restore and the derived-layout one (Occ
    checkpoints at 258 columns built again) equal the reference's build
    and answer as the built index does."""
    toks, port, ref = _built(name, r, s)
    save_index(str(tmp_path / "port"), port)
    j_save_index(str(tmp_path / "jax"), ref)
    a, b = (tmp_path / side / "step_00000000" for side in ("port", "jax"))
    assert (a / "meta.json").read_text() == (b / "meta.json").read_text()
    with zipfile.ZipFile(a / "arrays.npz") as za, \
            zipfile.ZipFile(b / "arrays.npz") as zb:
        assert sorted(za.namelist()) == sorted(zb.namelist())
        for member in za.namelist():
            assert za.read(member) == zb.read(member), member

    reqs = _requests(toks, 7)
    want = FMQueryServer.from_config(port, CONFIG, device="cpu")
    want_counts, want_pos = want.count(reqs), want.locate(reqs)
    _strip_layout(tmp_path / "jax")
    for layout, d in (("stored", tmp_path / "port"),
                      ("derived", tmp_path / "jax")):
        got = restore_index(str(d), device="cpu")
        assert fm_mismatch(got.fm, ref.fm) == [], layout
        served = FMQueryServer.from_config(got, CONFIG, device="cpu")
        assert np.array_equal(served.count(reqs), want_counts), layout
        for x, y in zip(served.locate(reqs), want_pos):
            assert np.array_equal(x, y), layout
