"""The SSM and hybrid reduced configs (mamba2_1p3b, recurrentgemma_2b)
trained in a world of ranks against the JAX package's jitted train step
on the same mesh, ``(1, 2, 2)`` and ``(2, 2, 2)`` under ``TRAIN_RULES``
(the machinery is ``test_torch_train_world.py``'s).  Their world paths'
backward: Mamba-2's packed ``in_proj`` / conv columns gathered whole over
model and cut per component (a reduce-scatter of the gathered gradient),
its gated norm's psum of squares; RG-LRU's gate products over the split
width summed over model and cut to the rank's channels; recurrentgemma's
single kv head replicated over model beside its split q heads.
"""

import pytest
import torch

from test_torch_train_world import (
    SSM_CASES,
    check_gradient,
    check_layout,
    check_step,
    key,
    run_reference,
    run_worlds,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_worlds(run_reference(tmp_path_factory, "ssm"), SSM_CASES)


@pytest.mark.parametrize("case", SSM_CASES, ids=key)
def test_blocks_lie_where_the_jax_shards_do(world, case):
    check_layout(world, case)


@pytest.mark.parametrize("case", SSM_CASES, ids=key)
def test_gradient_blocks_match_the_mesh_reference(world, case):
    check_gradient(world, case)


@pytest.mark.parametrize("case", SSM_CASES, ids=key)
def test_train_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "plain")


@pytest.mark.parametrize("case", SSM_CASES, ids=key)
def test_compressed_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "comp")


@pytest.mark.parametrize("case", [c for c in SSM_CASES if c[0] == 4],
                         ids=key)
def test_remat_policies_give_equal_gradients_in_a_world(world, case):
    """"full", "dots" and "none" give the same gradient blocks bit for bit
    in a world."""
    for rec in world[key(case)]:
        assert rec["remat_equal"] == {"full": True, "none": True,
                                      "dots": True}
