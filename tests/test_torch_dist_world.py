"""The port's index mesh, its world of local ranks
(``repro_torch/launch/mesh.py``) and the collectives of
``repro_torch/core/dist_sort.py`` on the CPU (gloo): each collective
against numpy (``gather`` only to rank 0), counted once per call; a rank that raises or hangs fails
its world with the rank's traceback and leaves no process behind.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import dist_sort as ds
from repro_torch.launch.mesh import make_index_mesh, run_world

TIMEOUT_S = 60


def collectives_rank(mesh) -> dict:
    info = ds.shard_info(mesh, 4 * mesh.size())
    me = ds._me(info)
    P = info.parts
    x = torch.arange(4, dtype=torch.int32) + 10 * me
    ds.reset_collectives()
    out = {
        "all_gather": ds.all_gather(info, x),
        "gather": ds.gather(info, x),
        "ppermute": ds.ppermute(info, x, [(i, (i + 1) % P)
                                          for i in range(P)]),
        "all_to_all": ds.all_to_all(info, torch.stack(
            [x + 100 * d for d in range(P)])),
        "psum": ds.psum(info, x),
        "pmax": ds.pmax(info, torch.tensor(me == 1)),
        "x": x,
        "transport": ds.transport(info, "cpu"),
        "dims": mesh.mesh_dim_names,
    }
    out["counts"] = dict(ds.COLLECTIVES)
    return out


@pytest.mark.parametrize("P", [1, 3])
def test_collectives_against_numpy(P):
    ranks = run_world(P, collectives_rank, timeout_s=TIMEOUT_S)
    xs = np.stack([r["x"] for r in ranks])
    for me, r in enumerate(ranks):
        assert np.array_equal(r["all_gather"], xs)
        if me == 0:
            assert np.array_equal(r["gather"], xs)
        else:
            assert r["gather"] is None
        assert np.array_equal(r["ppermute"], xs[(me - 1) % P])
        assert np.array_equal(r["all_to_all"], xs + 100 * me)
        assert np.array_equal(r["psum"], xs.sum(0))
        assert bool(r["pmax"]) == (P > 1) and r["pmax"].dtype == np.bool_
        assert r["transport"] == "gloo, direct"
        assert r["dims"] == ("parts",)
        assert r["counts"] == {"all_gather": 1, "gather": 1, "ppermute": 1,
                               "all_to_all": 1, "psum": 1, "pmax": 1}


def not_a_permutation_rank(mesh):
    info = ds.shard_info(mesh, 2)
    ds.ppermute(info, torch.zeros(1, dtype=torch.int32), [(0, 1), (1, 1)])


def test_ppermute_refuses_a_non_permutation():
    with pytest.raises(RuntimeError, match="needs a permutation of 2 ranks"):
        run_world(2, not_a_permutation_rank, timeout_s=TIMEOUT_S)


def raising_rank(mesh, bad: int):
    info = ds.shard_info(mesh, mesh.size())
    if ds._me(info) == bad:
        raise ValueError(f"rank {bad} gives up")
    # the others wait in a collective the failed rank never joins
    ds.psum(info, torch.ones(1))


def test_a_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_world(3, raising_rank, 1, timeout_s=TIMEOUT_S)
    assert "rank 1 raised" in str(err.value)
    assert "ValueError: rank 1 gives up" in str(err.value)
    assert time.monotonic() - t0 < TIMEOUT_S / 2


def hanging_rank(mesh):
    if mesh.get_local_rank("parts") == 0:
        time.sleep(600)


def test_a_world_past_its_timeout_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within 5"):
        run_world(2, hanging_rank, timeout_s=5)
    assert time.monotonic() - t0 < 30


def test_a_world_needs_a_rank():
    with pytest.raises(ValueError, match="at least one rank"):
        run_world(0, collectives_rank)


def test_mesh_device_types():
    with pytest.raises(ValueError, match="mesh device type"):
        make_index_mesh("tpu")


def test_a_mesh_is_a_device_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        ds.mesh_parts(object())
