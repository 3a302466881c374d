"""The launch plans of K8 (grouped positional conv) and K2's layer-0 kernel
(conv0 + LayerNorm + GELU): what ``pos_conv_plan`` and ``conv_frontend_plan``
hand the CUDA launchers. Each plan fits a block's limits on an H100 (227 KB
of shared memory, 1024 threads) and its grid covers every output frame.
The kernels check the same plan when launched; ``chip_smoke.py`` holds the
built kernels' shared bytes and resident blocks to it on the card.
"""

import pytest
import torch

from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as k_conv
from interspeech_ser_tpu_torch.ops.kernels import pos_conv as k_pos

SMEM_LIMIT = 232448
DTYPES = [torch.float32, torch.bfloat16]


def _t_out(T, K):
    return T + 2 * (K // 2) - K + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [2, 128, 256])
@pytest.mark.parametrize("C", k_pos.GROUP_WIDTHS)
def test_pos_conv_plan_fits_and_covers(C, K, dtype):
    plan = k_pos.pos_conv_plan(C, K, dtype)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.threads <= 1024
    assert plan.frames % 64 == 0 and plan.blocks_per_sm >= 1
    if dtype == torch.bfloat16:  # warpgroups of 64 frames; the slab and the tap ring
        assert plan.threads == 128 * (plan.frames // 64) and 3 <= plan.stages <= 4
        chunks = (C + 15) // 16 * 2
        taps = 4 if C <= 48 else (2 if C <= 80 else 1)
        assert plan.smem_bytes == 16 * chunks * (plan.frames + K - 1 + plan.stages * taps * C)
    else:  # 8 x 8 micro-tiles, two blocks an SM
        assert plan.threads == (plan.frames // 8) * (C // 8) <= 256 and plan.stages == 2
        assert 2 * (plan.smem_bytes + 1024) <= 233472
    for B, T in ((1, 1), (1, plan.frames - 1), (3, plan.frames), (16, 499), (2, 1000)):
        tiles, groups, rows = plan.grid(B, T, 16)
        t_out = _t_out(T, K)
        assert (groups, rows) == (16, B)
        assert tiles * plan.frames >= t_out > (tiles - 1) * plan.frames


def test_pos_conv_plan_main_path():
    """At K = 128 (every encoder of the zoo) bf16 takes 256 frames in 4
    warpgroups with a ring of 4 tap matrices; f32 128 or 256 frames."""
    for C in k_pos.GROUP_WIDTHS:
        bf = k_pos.pos_conv_plan(C, 128, torch.bfloat16)
        assert (bf.frames, bf.stages, bf.threads) == (256, 4, 512)
        f32 = k_pos.pos_conv_plan(C, 128, torch.float32)
        assert f32.frames == (256 if C <= 64 else 128)
    # K = 256 at C = 120: the slab of 511 rows leaves room for 3 steps only
    assert k_pos.pos_conv_plan(120, 256, torch.bfloat16).stages == 3
    assert [k_pos.bf16_taps_per_step(C) for C in k_pos.GROUP_WIDTHS] == [4, 2, 2, 1]


@pytest.mark.parametrize("args", [(56, 128, torch.float32), (64, 257, torch.float32), (64, 0, torch.bfloat16),
                                  (64, 128, torch.float16)])
def test_pos_conv_plan_refuses(args):
    with pytest.raises(ValueError):
        k_pos.pos_conv_plan(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ksize", [10, 16])
@pytest.mark.parametrize("B,T0", [(8, 31999), (32, 31999), (1, 1), (1, 7), (3, 1001), (2, 3199)])
def test_conv_frontend_plan_fits_and_covers(B, T0, ksize, dtype):
    plan = k_conv.conv_frontend_plan(B, T0, dtype, ksize)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.threads <= 1024
    assert plan.blocks <= k_conv.H100_SMS * plan.blocks_per_sm
    assert plan.blocks * plan.frames >= B * T0 > (plan.blocks - 1) * plan.frames
    if dtype == torch.float32:  # a lane owns 8 channels of a frame, steps of 4 frames
        assert plan.threads * 8 == k_conv.CHANNELS and plan.frames % k_conv.L0_STEP == 0
        assert plan.blocks_per_sm == (6 if ksize <= 10 else 4)
    else:  # 16 warps, each a run of 16-frame tiles; the 128-KB GELU table
        assert plan.threads == 512 and plan.frames % (2 * 16 * 16) == 0 and plan.blocks_per_sm == 1
        assert plan.smem_bytes == 2 * 65536 + 8 * 64 * 32 + 4 * 3 * 512


def test_conv_frontend_plan_main_path():
    """wav [8, 160000], 255,992 output frames: f32 791 blocks (6 an SM on 132
    SMs) of 324 frames; bf16 125 blocks whose 16 warps own 8 tiles of 16
    frames each (16,000 tiles: none idle)."""
    f32 = k_conv.conv_frontend_plan(8, 31999, torch.float32)
    bf = k_conv.conv_frontend_plan(8, 31999, torch.bfloat16)
    assert (f32.blocks, f32.frames) == (791, 324)
    assert (bf.blocks, bf.frames) == (125, 2048)


@pytest.mark.parametrize("args", [(8, 100, torch.float16), (8, 100, torch.float32, 17), (0, 100, torch.float32),
                                  (8, 0, torch.bfloat16)])
def test_conv_frontend_plan_refuses(args):
    with pytest.raises(ValueError):
        k_conv.conv_frontend_plan(*args)
