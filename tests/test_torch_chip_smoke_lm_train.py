"""chip_smoke.py's phase 15 (LM training in worlds of ranks) rehearsed on
the CPU at a tiny size.  No GPU.  (Moved from
``test_torch_chip_smoke.py``, whose one worker ran them all.)
"""

import pytest
import torch
from torch_session_cache import load_chip_smoke


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# one module per process: the functions handed to spawned ranks must be the
# ones the ranks import by the name chip_smoke
chip_smoke = load_chip_smoke()


def test_phase_lm_train_runs_on_the_cpu():
    """Phase 15 on the CPU: (a) phase 14 (a)'s worlds with their train
    steps (a dense config also compressed, an MoE config in 4 and 8
    ranks), the 'card' (the CPU here) against the CPU exactly; (b) the
    world of (1, 2, 2) training a 2-layer reduced qwen2p5_3b for 3 steps
    against one rank, its checkpoint of step 2 restored and step 3 taken
    again bit for bit, with the collectives of a step by kind and pass;
    no index kernel launches in any rank."""
    spec = dict(chip_smoke.LM_TRAIN_WORLD, config="get_reduced_config",
                layers=2, seq=16)
    rec, launches = chip_smoke.phase_lm_train(
        "cpu", archs=["qwen2p5_3b", "deepseek_v2_236b"], spec=spec)
    four, eight = rec["reduced"]["4_ranks"], rec["reduced"]["8_ranks"]
    assert set(four) == {"mesh", "qwen2p5_3b", "qwen2p5_3b_compressed",
                         "deepseek_v2_236b"}
    assert set(eight) == {"mesh", "deepseek_v2_236b"}
    for r in (four["qwen2p5_3b"], four["qwen2p5_3b_compressed"],
              four["deepseek_v2_236b"], eight["deepseek_v2_236b"]):
        assert r["grad_err"] == r["state_err"] == r["loss_fn_err"] == 0
    assert four["qwen2p5_3b_compressed"]["ties"] >= 0
    full = rec["full"]
    assert full["resumed_bitwise"] and len(full["losses"]) == 3
    assert full["loss_max_err"] <= chip_smoke.LM_TOL * 10
    per = full["collectives_per_step"]
    assert per["all_gather/forward"] == per["all_gather/remat"] == \
        per["reduce_scatter/backward"] > 0
    assert per["psum/forward"] == per["psum/backward"] > 0
    assert per["psum/grads"] > 0 and per["psum/norm"] == 2
    assert full["checkpoint_bytes"] > 0
    assert set(launches.values()) <= {0}
