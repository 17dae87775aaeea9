"""The port's analytic roofline model (``launch.roofline_model``) against
the JAX package's: every FLOP and byte count equal, exactly, for every
``configs.ARCH_IDS`` × ``INPUT_SHAPES`` pair; the H100 peaks table that
``chip_smoke.py`` reads; and ``conv_tile_rows``, whose port gives the row
block of ``csrc/conv_fused.cu`` where JAX sizes a VMEM tile: both rules
keep whole pairs of image rows in a block, which is what is held."""
import dataclasses
import os
import sys

import pytest

from repro import configs as jconfigs
from repro.launch import roofline_model as jroof
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import roofline_model as roof

PAIRS = [(a, s) for a in configs.ARCH_IDS for s in configs.INPUT_SHAPES]


def test_every_pair_is_covered():
    assert len(PAIRS) == 40
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tuple(configs.INPUT_SHAPES) == tuple(jconfigs.INPUT_SHAPES)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_counts_equal_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    sh, jsh_ = configs.INPUT_SHAPES[shape], jconfigs.INPUT_SHAPES[shape]
    b, s = sh.global_batch, sh.seq_len
    assert roof.step_flops(cfg, sh) == jroof.step_flops(jcfg, jsh_)
    assert roof._n_attn_layers(cfg) == jroof._n_attn_layers(jcfg)
    assert roof._ssd_flops_fwd(cfg, b, s) == jroof._ssd_flops_fwd(jcfg, b, s)
    for causal in (True, False):
        for window in (None, 4096, s):
            assert roof._attn_pairs(b, s, causal=causal, window=window) == \
                jroof._attn_pairs(b, s, causal=causal, window=window)
    assert roof.attn_flops_fwd(cfg, 12345.0) == \
        jroof.attn_flops_fwd(jcfg, 12345.0)
    for ga in sorted({1, 2, dryrun.GRAD_ACCUM["train_4k"][arch]}):
        assert roof.step_bytes(cfg, sh, grad_accum=ga) == \
            jroof.step_bytes(jcfg, jsh_, grad_accum=ga)
        assert dataclasses.asdict(roof.analytic_roofline(
            cfg, sh, grad_accum=ga)) == dataclasses.asdict(
            jroof.analytic_roofline(jcfg, jsh_, grad_accum=ga))


def test_peaks_table_and_chip_smoke_read_it():
    """The H100 SXM peaks, each from the data sheet or the white paper,
    and ``chip_smoke.py``'s bounds reading this one table."""
    t = roof.H100_SXM
    assert t["hbm_bytes_per_s"] == 3.35e12
    assert t["fp32_flops"] == 67e12
    assert t["bf16_flops"] == 989e12
    assert t["int32_ops"] == 132 * 64 * 1.98e9
    assert t["nvlink_bytes_per_s"] == 450e9
    assert roof.THREEFRY_INT_OPS == 74
    assert roof.peak_flops("fp32") == 67e12
    assert roof.peak_flops("bf16") == 989e12
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    assert chip_smoke.HBM_BYTES_PER_S is t["hbm_bytes_per_s"]
    assert chip_smoke.FP32_FLOPS is t["fp32_flops"]
    assert chip_smoke.INT32_OPS is t["int32_ops"]
    assert chip_smoke.THREEFRY_INT_OPS is roof.THREEFRY_INT_OPS
    ms, by = chip_smoke.bound(3.35e9, 1.0)
    assert (round(ms, 9), by) == (1.0, "bytes")


@pytest.mark.parametrize("w_img", [2, 4, 6, 8, 14, 16, 28, 112, 128, 224,
                                   300])
@pytest.mark.parametrize("cp", [4, 32, 64])
def test_conv_tile_rows_keep_whole_row_pairs(w_img, cp):
    """Both rules give a multiple of 2·w_img (no 2×2 pool window straddles
    two blocks); the port's block is the largest such that fits the CUDA
    tile (32·TM rows, TM = 14 past 32 channels, else 8), or one pair when a
    pair is wider than the tile."""
    qp = 25
    rows = roof.conv_tile_rows(w_img, qp, cp)
    jrows = jroof.conv_tile_rows(w_img, qp, cp)
    assert rows % (2 * w_img) == 0 and jrows % (2 * w_img) == 0
    bm = 32 * (14 if cp > 32 else 8)
    if 2 * w_img <= bm:
        assert rows <= bm < rows + 2 * w_img
    else:
        assert rows == 2 * w_img
