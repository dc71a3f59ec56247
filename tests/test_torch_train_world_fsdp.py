"""Training in a world of ranks under the reference's ``fsdp_v2`` /
``fsdp_v3`` rule sets (``src/repro/launch/perf.py`` ``qwen_train``: the
batch over every axis, ZeRO-3 over data, no tensor parallelism; v3 keeps
the vocab over model), for qwen2p5_3b and mamba2_1p3b on ``(1, 2, 2)``
and ``(2, 2, 2)``, against the JAX package's jitted train step on the
same mesh (the machinery is ``test_torch_train_world.py``'s).  Under v3
the rows of a rank are not replicated over the vocab's axis, so the
embedding table is gathered before the lookup and the lm_head before the
logits; at B = 4 on ``(2, 2, 2)`` the batch falls back to the pod axis.
"""

import pytest
import torch

from test_torch_train_world import (
    B,
    FSDP_CASES,
    MESHES,
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
    return run_worlds(run_reference(tmp_path_factory, "fsdp"), FSDP_CASES)


@pytest.mark.parametrize("case", FSDP_CASES, ids=key)
def test_blocks_lie_where_the_jax_shards_do(world, case):
    check_layout(world, case)


@pytest.mark.parametrize("case", FSDP_CASES, ids=key)
def test_gradient_blocks_match_the_mesh_reference(world, case):
    check_gradient(world, case)


@pytest.mark.parametrize("case", FSDP_CASES, ids=key)
def test_train_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "plain")


@pytest.mark.parametrize("case", FSDP_CASES, ids=key)
def test_compressed_step_matches_the_mesh_reference(world, case):
    check_step(world, case, "comp")


def test_the_fsdp_rule_sets_keep_or_split_the_vocab(world):
    """Under fsdp_v2 the embedding (vocab 512) is whole on every rank;
    under fsdp_v3 it stays split over model."""
    for rules, rows in (("fsdp_v2", {(0, 512)}),
                        ("fsdp_v3", {(0, 256), (256, 512)})):
        for n in MESHES:
            got = {rec["embed_rows"] for rec in world[key((
                n, rules, "qwen2p5_3b", B))]}
            assert got == rows, (n, rules, got)
