"""The FLOP and byte counters against hand counts at WavLM-large's
shapes."""

import pytest

from portbench import run, yardstick

ENC = run.load_json(run.BENCH / "configs" / "wavlm-large-byol.json")[
    "encoder"]


def test_frames_of_the_crops():
    assert yardstick.frames(ENC, 80000)[-1] == 249
    assert yardstick.frames(ENC, 160000)[-1] == 499
    assert yardstick.frames(ENC, 480000)[-1] == 1499


def test_encoder_flop_by_hand_at_5_s():
    t, c, f = 249, 1024, 4096
    conv = [15999, 7999, 3999, 1999, 999, 499, 249]
    ks = [10, 3, 3, 3, 3, 2, 2]
    front = 2 * conv[0] * 512 * 10 + sum(
        2 * conv[i] * 512 * 512 * ks[i] for i in range(1, 7))
    layer = 8 * t * c * c + 4 * t * t * c + 2 * t * 16 * 64 * 8 \
        + 4 * t * c * f
    rest = 2 * t * 512 * 1024 + 2 * t * 1024 * 64 * 128 + 24 * layer
    got = yardstick.encoder_forward_flop(ENC, 80000, 24)
    assert got["conv0"] + got["rest"] == pytest.approx(front + rest,
                                                       rel=1e-12)
    # about 185 GFLOP a 5 s clip, the figure the port's notes use
    assert 170e9 < front + rest < 200e9
    assert yardstick.train_flop(got) == pytest.approx(
        2 * got["conv0"] + 3 * got["rest"])


def test_kernel_bounds_at_the_training_shapes():
    n = 36 * 249
    # kernel B: 4·N·C·F operations at 989 TFLOP/s, 152 us
    flop = 4.0 * n * 1024 * 4096
    assert yardstick.ffn_least(n, 1024, 4096, "serve") == pytest.approx(
        flop / 989e12)
    assert yardstick.ffn_least(n, 1024, 4096, "train") == pytest.approx(
        3 * flop / 989e12, rel=1e-9)
    # kernel A at B=36, T=249: bound by its bytes, about 21 us
    a = yardstick.attention_least(36, 16, 249, 64, "fwd", True)
    assert 18e-6 < a < 26e-6
    full = yardstick.attention_least(36, 16, 249, 64, "train", True)
    assert full > a


def test_groups_sort_the_kernel_names():
    assert yardstick.group_of("void nrse::wgmma_gemm<EpiGelu>") == \
        yardstick.FFN
    assert yardstick.group_of("block_attention_fwd_wgmma_kernel") == \
        "kernel A (block attention)"
    assert yardstick.group_of("flash_attention_bwd_dq_wgmma_kernel") in \
        yardstick.ATTENTION
    assert yardstick.group_of("something_else") == "other"
