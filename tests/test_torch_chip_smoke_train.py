"""chip_smoke.py's phase 12 (LM training) rehearsed on the CPU at tiny
sizes: its parts run and agree, a state that differs on the "card" fails
it, and the operation count of its bound equals what
``torch.utils.flop_counter`` counts over a train step.  No GPU.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

_ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
sys.modules.setdefault("chip_smoke", chip_smoke)
if str(_ROOT) not in sys.path:
    sys.path.append(str(_ROOT))
_SPEC.loader.exec_module(chip_smoke)


@pytest.fixture
def one_thread():
    """One intra-op thread for the training rehearsals (tiny models: the
    thread pool only adds synchronisation on a shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_phase_train_runs_on_the_cpu(one_thread):
    """Phase 12 on the CPU at tiny sizes: (a) for a dense and an MoE
    config (the CPU against itself agrees exactly under every remat
    policy), (b) bitwise resume, (c)-(d) on reduced configs with a planted
    screen; no index kernel launches in training."""
    from repro_torch.configs.base import get_reduced_config

    rec, launches = chip_smoke.phase_train(
        device="cpu", archs=["qwen2p5_3b", "deepseek_v2_236b"],
        resume_archs=("deepseek_v2_236b",),
        repeat_probes=(("deepseek_v2_236b", {"top_k": 6}),),
        full_parts=(("qwen2p5_3b", 2, 32, 2, False, True),
                    ("mamba2_1p3b", 2, 32, 2, True, False)),
        screen_args=dict(log2n=14, plant_log2n=11, window=64, stride=256,
                         sample_rate=64),
        config_of=get_reduced_config, launcher=False)
    assert rec["float32_matmul_precision"] == "highest"
    assert not rec["cudnn_allow_tf32"]
    for a in ("qwen2p5_3b", "deepseek_v2_236b"):
        r = rec["reduced_configs"][a]
        assert r["state_err"] == r["loss_err_dots"] == 0
        assert r["remat_states_equal"]
    assert rec["resume"]["deepseek_v2_236b"]["bitwise"]
    assert rec["repeat"]["deepseek_v2_236b_top_k6"]["deterministic"][
        "bitwise"]
    assert rec["screen"]["copies_flagged"] == (True, True)
    assert rec["screen"]["drop_share"] == 0.25
    qwen, mamba = rec["qwen2p5_3b"], rec["mamba2_1p3b"]
    # train's 2, the determinism turns' 4 and two dots steps (the profiled
    # step runs on the card only)
    assert qwen["steps_taken"] == 2 + 4 + 2 and "dots" in qwen
    assert mamba["compress_grads"] and "dots" not in mamba
    assert all(sum(v.values()) == 0 for v in launches.values())


def test_phase_train_fails_on_a_mismatch(monkeypatch, one_thread):
    """A state that differs on the 'card' fails the phase."""
    carry = chip_smoke.copy_to

    def skewed(tree, device):
        out = carry(tree, device)
        if device == "cpu" and "params" in out and len(skewed.calls) == 1:
            out["params"]["lm_head"].mul_(1.01)
        skewed.calls.append(device)
        return out

    skewed.calls = []
    monkeypatch.setattr(chip_smoke, "copy_to", skewed)
    with pytest.raises(AssertionError, match="differs from the CPU"):
        chip_smoke.phase_train(device="cpu", archs=["minitron_4b"],
                               resume_archs=(), repeat_probes=(), full=False,
                               launcher=False)


@pytest.mark.parametrize("arch", ["qwen2p5_3b", "mamba2_1p3b"])
def test_train_flops_is_the_step_count(arch, one_thread):
    """The bound's operation count equals the matmul operations
    torch.utils.flop_counter counts over one train step (remat "full")."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.sharding import single_device_context
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    cfg = get_reduced_config(arch)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             TrainConfig(), torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32)
    step = make_train_step(cfg, single_device_context(), TrainConfig())
    with FlopCounterMode(display=False) as count:
        step(state, {"tokens": toks, "labels": toks})
    assert count.get_total_flops() == chip_smoke.train_flops(cfg, 2, 64)
