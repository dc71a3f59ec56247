"""The port's distributed index checkpoints (``repro_torch/core/index_io.py``
with a mesh) against the JAX package's: the ``index_io`` scenario of
``tests/dist_driver.py`` in gloo worlds, and checkpoints carried across
packages.

The JAX side runs once per module: this file run as a script with forced
host devices (``--jax-reference DIR``) builds the text on one device,
shards that index over meshes of 8, 4, 2 and 1 devices, and saves each
index.  The port
builds the text in gloo worlds of 8, 4 and 2 ranks and in a world of one
(this process), saves it from each, and restores JAX and port
checkpoints, single-device and saved from 8 or 4 ranks, onto the world's
mesh.  Checked:

* a save from P ranks is the JAX save from P devices on disk: the same
  ``meta.json`` text (``built_parts`` = P) and npz members;
* every restore, on 8, 4, 2 or 1 ranks or with ``mesh=None``, and the
  JAX package's restore of the port's checkpoints, answer the requests
  as the saved index does;
* a length that does not divide ``parts * sample_rate`` raises
  ``ValueError`` on every rank.

Every output is an integer, so the tolerance is exact equality.
"""

import json
import os
import subprocess
import sys

if __name__ == "__main__":   # the JAX reference: devices before jax loads
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np
import pytest

AXIS = "parts"
R = 8                     # Occ sample rate
N = 8 * 8 * R             # padded length 512: divides parts * R, parts <= 8
SAVE_PARTS = (8, 4, 2, 1)
WORLD_TIMEOUT_S = 120
K = 64
# name: (tokens in [1, sigma_hi), sa_sample_rate, compress_sa)
LAYOUTS = {
    "dna4": (5, 4, None),         # 4-bit packed rows, packed SA values
    "unpacked": (20, 4, False),   # sigma > 16, raw SA values
    "no_sa": (5, 0, None),        # no SA sample: count only
}
SHORT_TOKENS = 99         # padded to 104 = 13 * R: no mesh of 2-8 divides


def corpus(name: str):
    """(tokens, patterns int32[12, 6] PAD-padded) of a layout: substrings
    of the text and one out-of-alphabet symbol."""
    sigma_hi = LAYOUTS[name][0]
    rng = np.random.default_rng([3, sigma_hi, len(name)])
    toks = rng.integers(1, sigma_hi, N - 1).astype(np.int32)
    pats = np.full((12, 6), -1, np.int32)
    for b in range(12):
        L = int(rng.integers(1, 7))
        st = int(rng.integers(0, len(toks) - L))
        pats[b, :L] = toks[st: st + L]
    pats[3, 0] = 99
    return toks, pats


def answers(index, pats, srate: int) -> dict:
    """Counts and, with an SA sample, the first K sorted positions."""
    out = {"count": np.asarray(index.count(pats))}
    if srate:
        pos, cnt = index.locate(pats, K)
        out.update(pos=np.asarray(pos), cnt=np.asarray(cnt))
    return out


def build_kw(name: str) -> dict:
    _, srate, compress = LAYOUTS[name]
    return dict(sample_rate=R, sa_sample_rate=srate, compress_sa=compress)


def ckpt(root: str, side: str, name: str, parts) -> str:
    """The checkpoint directory of ``side`` ("jax" / "port") for a layout
    saved from ``parts`` ranks ("fm": a single-device index)."""
    return os.path.join(root, f"{side}_{name}_{parts}")


# --------------------------------------------------------------------------
# the JAX reference (script mode)
# --------------------------------------------------------------------------

def _jax_reference(root: str) -> None:
    """The JAX saves of every layout: from one device, and from meshes of
    P devices sharding that build's BWT and SA (the suffix array of a
    text is unique, so this is the mesh build's index, made without
    compiling the distributed sort); the single-device answers."""
    import jax
    import jax.numpy as jnp

    from repro.core.dist_fm import build_dist_fm_index
    from repro.core.index_io import save_index
    from repro.core.pipeline import SequenceIndex, build_index

    saved = {}
    for name in LAYOUTS:
        toks, pats = corpus(name)
        kw = build_kw(name)
        one = build_index(toks, None, **kw)
        assert one.length == N          # no pad: every mesh's text
        save_index(ckpt(root, "jax", name, "fm"), one)
        for k, v in answers(one, pats, kw["sa_sample_rate"]).items():
            saved[f"{name}/{k}"] = v
        srate = kw.pop("sa_sample_rate")
        for P in SAVE_PARTS:
            mesh = jax.make_mesh((P,), (AXIS,), devices=jax.devices()[:P])
            fm = build_dist_fm_index(
                jnp.asarray(one.bwt), one.row, mesh, sigma=one.sigma,
                sa=one.sa if srate else None,
                **kw, **(dict(sa_sample_rate=srate) if srate else {}))
            save_index(ckpt(root, "jax", name, P), SequenceIndex(
                fm, one.sa, fm.bwt, one.row, one.sigma, one.length,
                one.text_length, mesh=mesh))
    np.savez(os.path.join(root, "answers.npz"), **saved)


# --------------------------------------------------------------------------
# the port
# --------------------------------------------------------------------------

# the checkpoints every world restores: the JAX saves from 8 and from 4
# devices and from one, the port's from 8 ranks (the first world) and from
# one device
RESTORED = (("jax", 8), ("jax", 4), ("jax", "fm"), ("port", 8), ("port", "fm"))


def port_rank(mesh, root: str) -> dict:
    """One rank: each layout built on the mesh and saved (its step), its
    answers; each ``RESTORED`` checkpoint restored onto the mesh, with
    its answers; the short checkpoint's restore, or its error."""
    from repro_torch.core.index_io import restore_index, save_index
    from repro_torch.core.pipeline import build_index

    parts = mesh.size()
    out = {}
    for name in LAYOUTS:
        toks, pats = corpus(name)
        srate = LAYOUTS[name][1]
        idx = build_index(toks, mesh, device="cpu", **build_kw(name))
        out[f"{name}/step"] = save_index(ckpt(root, "port", name, parts),
                                         idx, step=3)
        out[f"{name}/built"] = answers(idx, pats, srate)
        for side, P in RESTORED:
            rest = restore_index(ckpt(root, side, name, P), mesh,
                                 device="cpu")
            assert rest.mesh is mesh and rest.fm.parts == parts
            out[f"{name}/{side}_{P}"] = answers(rest, pats, srate)
    try:
        restore_index(ckpt(root, "port", "short", "fm"), mesh, device="cpu")
        out["short"] = "restored"
    except ValueError as e:
        out["short"] = str(e)
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(root, the JAX answers, each world's rank results by P)."""
    from repro_torch.core.index_io import save_index
    from repro_torch.core.pipeline import build_index
    from repro_torch.launch.mesh import run_world, single_rank_world

    root = str(tmp_path_factory.mktemp("dist_io"))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, __file__, "--jax-reference",
                           root], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(os.path.join(root, "answers.npz")) as z:
        ref = {k: z[k] for k in z.files}
    for name in LAYOUTS:
        save_index(ckpt(root, "port", name, "fm"),
                   build_index(corpus(name)[0], device="cpu",
                               **build_kw(name)))
    save_index(ckpt(root, "port", "short", "fm"),
               build_index(np.ones(SHORT_TOKENS, np.int32), device="cpu",
                           sample_rate=R))
    ranks = {P: run_world(P, port_rank, root, timeout_s=WORLD_TIMEOUT_S)
             for P in SAVE_PARTS if P > 1}
    with single_rank_world("cpu") as mesh:
        ranks[1] = [port_rank(mesh, root)]
    return root, ref, ranks


def _want(ref: dict, name: str) -> dict:
    """The JAX single-device index's answers (every build of a layout
    answers the same: one padded text)."""
    return {k: ref[f"{name}/{k}"] for k in ("count", "pos", "cnt")
            if f"{name}/{k}" in ref}


def _same(got: dict, want: dict, what) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        assert np.array_equal(got[k], want[k]), (what, k)


@pytest.mark.parametrize("P", SAVE_PARTS)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_same_files_as_the_jax_save(saved, name, P):
    """The save from P ranks and the JAX save from P devices: the same
    manifest text (``built_parts`` = P, kind ``"dist_fm"``, no derived
    layout) and npz members (names, dtypes, shapes, values)."""
    root, ref, ranks = saved
    port = os.path.join(ckpt(root, "port", name, P), "step_00000003")
    jax = os.path.join(ckpt(root, "jax", name, P), "step_00000000")
    with open(os.path.join(port, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jax, "meta.json")) as f:
        jmeta = json.load(f)
    assert meta.pop("step") == 3 and jmeta.pop("step") == 0
    assert json.dumps(meta) == json.dumps(jmeta)
    assert meta["built_parts"] == P and meta["kind"] == "dist_fm"
    assert not {"c_array", "occ_samples", "fused"} & set(meta["arrays"])
    with np.load(os.path.join(port, "arrays.npz")) as a, \
            np.load(os.path.join(jax, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == meta["arrays"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
    assert all(r[f"{name}/step"] == 3 for r in ranks[P])


@pytest.mark.parametrize("P", SAVE_PARTS)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_every_checkpoint_restores_on_a_mesh(saved, name, P):
    """On every rank of a world of P: the mesh build and the restore of
    each ``RESTORED`` checkpoint (JAX and port, single-device and saved
    from 8 or 4 ranks) answer as the saved index."""
    root, ref, ranks = saved
    want = _want(ref, name)
    for r in ranks[P]:
        _same(r[f"{name}/built"], want, (P, "built"))
        for side, Q in RESTORED:
            _same(r[f"{name}/{side}_{Q}"], want, (P, side, Q))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_every_checkpoint_restores_without_a_mesh(saved, name):
    """``mesh=None``: every checkpoint of the layout restores on one
    device (the distributed ones by deriving the single-device layout)."""
    from repro_torch.core.index_io import restore_index

    root, ref, _ = saved
    toks, pats = corpus(name)
    for side in ("jax", "port"):
        for P in (*SAVE_PARTS, "fm"):
            rest = restore_index(ckpt(root, side, name, P), device="cpu")
            assert rest.mesh is None
            _same(answers(rest, pats, LAYOUTS[name][1]), _want(ref, name),
                  (side, P))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_port_checkpoints_restore_in_jax(saved, name):
    from repro.core.index_io import restore_index as j_restore_index

    root, ref, _ = saved
    _, pats = corpus(name)
    for P in SAVE_PARTS:
        rest = j_restore_index(ckpt(root, "port", name, P))
        _same(answers(rest, pats, LAYOUTS[name][1]), _want(ref, name), P)


@pytest.mark.parametrize("P", SAVE_PARTS)
def test_a_length_that_does_not_divide_raises(saved, P):
    """The 104-symbol checkpoint (13 blocks of R) on a mesh of P: every
    rank raises where 104 does not divide P * R; one rank restores it."""
    for r in saved[2][P]:
        if P == 1:
            assert r["short"] == "restored"
        else:
            assert r["short"] == (f"n=104 must be divisible by "
                                  f"parts*sample_rate={P}*{R}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-reference"]:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "src"))
        _jax_reference(sys.argv[2])
