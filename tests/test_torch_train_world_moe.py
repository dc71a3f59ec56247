"""The two MoE reduced configs trained in a world of ranks against the JAX
package's jitted train step on the same mesh (the machinery and the dense
configs are in ``test_torch_train_world.py``).

The reference's MoE is an explicit ``shard_map``: each (pod, data) shard
routes its own tokens, capacity from their count, so its gradient on a
mesh with data > 1 is not the one-device gradient; the port follows it
(``blocks._moe_world``: the token gather and slice, the experts over
model, the ``expert_ff`` dim over pod gathered on ``(2, 2, 2)``; at B = 2
there the rows split over pod alone, so the tokens are gathered over pod
and each (pod, data) shard's own cut from them), and its backward runs
through the same collectives.  The JAX side takes both configs'
gradients on the forced meshes.
"""

import pytest
import torch

from test_torch_train_world import (
    MOE_CASES,
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
    return run_worlds(run_reference(tmp_path_factory, "moe"), MOE_CASES)


@pytest.mark.parametrize("case", MOE_CASES, ids=key)
def test_blocks_lie_where_the_jax_shards_do(world, case):
    check_layout(world, case)


@pytest.mark.parametrize("case", MOE_CASES, ids=key)
def test_gradient_blocks_match_the_mesh_reference(world, case):
    check_gradient(world, case)


@pytest.mark.parametrize("case", MOE_CASES, ids=key)
def test_train_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "plain")


@pytest.mark.parametrize("case", MOE_CASES, ids=key)
def test_compressed_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "comp")


@pytest.mark.parametrize("case", [c for c in MOE_CASES if c[0] == 4],
                         ids=key)
def test_remat_policies_give_equal_gradients_in_a_world(world, case):
    for rec in world[key(case)]:
        assert rec["remat_equal"] == {"full": True, "none": True,
                                      "dots": True}
