"""The two MoE reduced configs in a world of ranks against the JAX package
on the same mesh (the machinery and the dense configs are in
``test_torch_lm_world.py``).

The reference's MoE is an explicit ``shard_map``: each (pod, data) shard
routes its own tokens, each expert's capacity sized from their count, so
its result on a mesh with data > 1 is not the one-device result.  The port
follows it (``blocks._moe_world``) and is held against the mesh run: at
B = 4 on ``(1, 2, 2)`` and ``(2, 2, 2)`` (where ``expert_ff`` is split over
pod and gathered) under both rule sets, and at B = 3 on ``(1, 2, 2)``,
whose 24 prefill tokens split over data = 2 but whose 3 decode tokens do
not: the reference's shard_map refuses that step, and so does the port.
After the decode each rank's attention cache blocks (deepseek's MLA
latent, llama4's k / v, split by sequence over model) are the reference's
cache shards within MOE_TOL.
"""

import numpy as np
import pytest
import torch

from test_torch_lm_world import (
    B,
    MOE,
    MOE_CASES,
    MOE_TOL,
    check_cache,
    check_decode,
    check_forward,
    check_params,
    check_replicated_bits,
    check_tokens,
    key,
    build,
    run_reference,
    run_worlds,
    tokens,
)
from torch_session_cache import one_thread  # noqa: F401 (fixture)

STEPPED = [c for c in MOE_CASES if c[3] == B]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "moe")


@pytest.fixture(scope="module")
def world(reference):
    return run_worlds(reference, MOE_CASES)


@pytest.mark.parametrize("case", MOE_CASES, ids=key)
def test_param_blocks_are_the_jax_shards(world, case):
    check_params(world, case)


@pytest.mark.parametrize("case", MOE_CASES, ids=key)
def test_forward_logits_match_the_mesh_reference(world, reference, case):
    check_forward(world, reference, case)


@pytest.mark.parametrize("case", STEPPED, ids=key)
def test_decode_logits_match_the_mesh_reference(world, reference, case):
    check_decode(world, reference, case)


@pytest.mark.parametrize("case", STEPPED, ids=key)
def test_generate_tokens_match_the_mesh_reference(world, reference, case):
    check_tokens(world, reference, case)


@pytest.mark.parametrize("case", STEPPED, ids=key)
def test_cache_blocks_are_the_reference_layout(world, reference, case):
    """deepseek_v2_236b's latent (ckv / k_rope) and llama4's k / v split
    by sequence over model, as the reference's cache specs lay them."""
    check_cache(world, reference, case)


@pytest.mark.parametrize("case", MOE_CASES, ids=key)
def test_replicated_blocks_are_the_same_bits(world, case):
    check_replicated_bits(world, case)


@pytest.mark.parametrize("case", [c for c in MOE_CASES if c[3] == 3],
                         ids=key)
def test_a_decode_batch_the_data_axis_does_not_divide_raises(
        world, reference, case):
    """Three decode tokens over data = 2: the reference's shard_map raises,
    and the port raises rather than pad."""
    k = key(case)
    assert f"{k}/decode_error" in reference
    for rec in world[k]:
        assert "batch axes" in rec["decode_error"]


@pytest.mark.parametrize("arch", MOE)
def test_the_mesh_reference_is_not_the_one_device_result(reference, arch):
    """Capacity from the local token count drops other tokens than one
    device does: the mesh's logits differ from the one-device forward by
    more than the tolerance, which is why the port is held against the
    mesh run."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.sharding import single_device_context

    cfg = base.get_reduced_config(arch)
    full = build(tf.model_specs(cfg),
                 lambda path: reference[f"{arch}/params/{path}"])
    one = tf.forward(params_from_numpy(full, "cpu"),
                     {"tokens": torch.from_numpy(tokens(cfg, B))}, cfg,
                     single_device_context()).detach().numpy()
    mesh = reference[f"{key((4, 'train', arch, B))}/forward"]
    assert np.abs(mesh - one).max() > 10 * MOE_TOL
