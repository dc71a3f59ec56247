"""chip_smoke.py's LM serving phases rehearsed on the CPU: phase 11 (a
config on the "card" against the CPU, a mismatch failing it, tokens that
may differ only at a tie, the full-width parts cut down), the single-query
parity, and phase 14's worlds.  No GPU.  (Moved from
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


def test_phase_lm_runs_on_the_cpu():
    """Phase 11 (a) at its size on the CPU for two reduced configs (GQA at
    S = 2048 through the chunked path, and MoE + MLA), no full-width part:
    the CPU against itself agrees and no index kernel launches."""
    rec, launches = chip_smoke.phase_lm(
        device="cpu", archs=["qwen2p5_3b", "deepseek_v2_236b"], full=False)
    qwen, ds = (rec["reduced_configs"][a] for a in ("qwen2p5_3b",
                                                    "deepseek_v2_236b"))
    assert qwen["forward_S2048_err"] == 0 and qwen["decode_err"] == 0
    assert ds["tol"] == chip_smoke.LM_MOE_TOL and "forward_S2048_err" not in ds
    assert qwen["generate_rows_differ"] == ds["generate_rows_differ"] == 0
    assert set(launches.values()) == {0}


def test_phase_lm_fails_on_a_mismatch(monkeypatch):
    """Weights that differ on the 'card' fail the phase."""
    carry = chip_smoke.on_device

    def skewed(params, device):
        out = carry(params, device)
        out["lm_head"] = out["lm_head"] * 1.01
        return out

    monkeypatch.setattr(chip_smoke, "on_device", skewed)
    with pytest.raises(AssertionError, match="differs from the CPU"):
        chip_smoke.phase_lm(device="cpu", archs=["minitron_4b"], full=False)


def test_generated_tokens_may_differ_only_at_a_tie():
    import numpy as np

    want = np.array([[1, 2, 3, 4]], np.int32)
    logits = torch.zeros(1, 3, 8)
    logits[0, 1, 3] = 1.0          # step 1 -> token 3, a clear winner
    logits[0, 2, 4] = logits[0, 2, 5] = 1.0   # step 2: a tie of 4 and 5
    got = want.copy()
    got[0, 3] = 5
    assert chip_smoke.tokens_agree(got, want, logits, 1, 1e-4, "t") == 1
    got[0, 2:] = [6, 7]
    with pytest.raises(AssertionError, match="top-2"):
        chip_smoke.tokens_agree(got, want, logits, 1, 1e-4, "t")


def test_single_query_parity_runs_on_the_cpu():
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus

    toks = corpus("proteins", 1 << 13)
    index = build_index(toks, device="cpu")
    rec, launches = chip_smoke.api_parity(toks, index, index)
    assert rec["rank_kernel"] == "rank_select" and rec["rpgi_n"] == 4097
    assert set(launches.values()) == {0}


@pytest.mark.parametrize("arch,layers,check", [("minitron_4b", None, 8),
                                               ("deepseek_v2_236b", 2, 0),
                                               ("mamba2_1p3b", None, 0)])
def test_lm_full_part_runs_on_the_cpu(monkeypatch, arch, layers, check):
    """A full-width part's logic at a reduced width on the CPU: bf16
    weights, generate, the timed forward and decode against forward."""
    from repro_torch.configs import base

    monkeypatch.setattr(base, "get_config", base.get_reduced_config)
    rec = chip_smoke.lm_full(arch, arch, layers, (2, 8, 4), (1, 16), check,
                             "cpu")
    assert rec["generate"]["steps"] == 11 and rec["generate"]["new"] == 4
    assert rec["forward"]["seq"] == 16
    assert ("reduced" in rec) == (layers is not None)
    assert ("capacity" in rec["forward"]) == (arch == "deepseek_v2_236b")
    if check:
        assert rec["decode_vs_forward"]["positions"] == check


def test_phase_lm_world_runs_on_the_cpu():
    """Phase 14 (a) on the CPU for a dense and an MoE config: each world
    (4 ranks, and 8 for the MoE config) on the 'card' (the CPU here)
    against the same world on the CPU agrees exactly; no index kernel
    launches in any rank."""
    rec, launches, _ = chip_smoke.phase_lm_world(
        device="cpu", archs=["qwen2p5_3b", "deepseek_v2_236b"], full=False)
    four, eight = rec["reduced"]["4_ranks"], rec["reduced"]["8_ranks"]
    assert four["transport"] == eight["transport"] == "gloo, direct"
    assert four["mesh"] == {"pod": 1, "data": 2, "model": 2}
    assert "qwen2p5_3b" not in eight
    for r in (four["qwen2p5_3b"], four["deepseek_v2_236b"],
              eight["deepseek_v2_236b"]):
        assert r["forward_err"] == r["decode_err"] == 0
        assert r["generate_rows_differ"] == 0
    assert four["deepseek_v2_236b"]["tol"] == chip_smoke.LM_MOE_TOL
    assert four["collectives_rank0"]["psum"] > 0
    assert set(launches.values()) <= {0}


def test_lm_world_full_parts_run_on_the_cpu():
    """Phase 14 (b) / (c)'s logic on reduced configs: the single-rank runs,
    then both parts in one world of (1, 1, 2), each rank holding half the
    heads (and experts) and half the positions of every attention cache,
    its forward and its decode logits along the single run's tokens
    against the single run's, and its greedy tokens equal; (c)'s MLA
    decodes over its latent cache split by sequence, one all_gather of
    the folded q heads and one of the partials a layer."""
    parts = (("minitron_4b", "minitron_4b", None, "float32", (2, 16),
              (2, 4, 4)),
             ("deepseek_v2_236b", "deepseek_v2_236b", 2, "bfloat16",
              (2, 16), (2, 4, 4)))
    rec, launches = chip_smoke.lm_world_full("cpu", parts,
                                             "get_reduced_config")
    m, d = rec["minitron_4b"], rec["deepseek_v2_236b"]
    assert rec["mesh"] == {"pod": 1, "data": 1, "model": 2}
    assert m["generate_rows_differ"] == 0
    assert m["forward_max_err"] <= chip_smoke.LM_TOL * (1 + m["max_abs_logit"])
    assert m["decode_max_err"] <= chip_smoke.LM_TOL * (
        1 + m["decode_max_abs_logit"])
    assert [r["local_heads"] for r in m["ranks"]] == [2, 2]
    gen = m["ranks"][0]["generate"]
    assert gen["steps"] == 7 and gen["collectives_per_step"]["psum"] > 0
    assert [r["local_experts"] for r in d["ranks"]] == [4, 4]
    assert d["forward_max_err"] <= chip_smoke.LM_BF16_TOL * d["max_abs_logit"]
    assert 0 < d["decode_max_abs_logit"]
    assert d["decode_max_err"] <= (chip_smoke.LM_BF16_TOL
                                   * d["decode_max_abs_logit"])
    assert d["generate_rows_differ"] <= 2
    # every MLA layer (one of the two reduced layers is MLA + MoE, the
    # other MLA + the dense FFN) gathers twice a step on top of the psums
    per = d["ranks"][0]["generate"]["collectives_per_step"]
    assert per["all_gather"] >= 2 * 2
    assert set(launches.values()) <= {0}
