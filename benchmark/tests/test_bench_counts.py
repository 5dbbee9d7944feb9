import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec
from benchmark.counts import cells, flops, peaks, stems
from benchmark.reference.add import Arch


def test_k1_counts_at_cityscapes_size():
    # 2 * ((27*64 + 576*64) * 513*1025 + 576*128 * 257*513)
    assert stems.flops(1025, 2049) == 60_026_023_296
    # image 1025*2049*3*4, s0 513*1025*64*4, s1 257*513*128*4, the weights and BN terms
    assert stems.nbytes(1025, 2049) == 1025 * 2049 * 12 + 513 * 1025 * 256 + 257 * 513 * 512 + 4 * 112_320 + 2048
    assert round(stems.nbytes(1025, 2049) / 1e6) == 228  # 227.3 MB of activations, and the weights and BN terms
    assert abs(stems.bound_s(1025, 2049) - 60_026_023_296 / 495e12) < 1e-12


def test_flop_counter_counts_one_conv():
    x = torch.empty(1, 64, 32, 48, device="meta")
    w = torch.empty(128, 64, 3, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        F.conv2d(x, w, padding=1)
    assert fc.get_total_flops() == 2 * 64 * 128 * 9 * 32 * 48


def test_block_counts_by_hand():
    # sep_conv_3x3 + dil_conv_5x5 at C=40: dw taps 2*2*9*40, products 2*2*40*40 + 2*25*40*40, one add
    assert cells.block_flops(["sep_conv_3x3", "dil_conv_5x5"], 40) == (2 * 2 * 9 * 40 + 40, 2 * 2 * 1600 + 2 * 25 * 1600)
    b = cells.block_bound_s(["sep_conv_3x3", "dil_conv_5x5"], 2, 40, 129, 257)
    assert b == max(129 * 257 * (2 * 2 * 1600 + 2 * 25 * 1600) / peaks.TF32_FLOPS, 3 * 129 * 257 * 40 * 4 / peaks.BYTES_PER_S)


def test_segment_flops_of_the_cells():
    cfg = spec.cell("add_c2.xla.exit70")["config"]
    seg = flops.segment_flops(cfg, (1025, 2049))
    assert set(seg) == {"decide_0", "head_0", "final"}
    # the all-exit forward (two heads, no EDM) is the ~465 GFLOP the program's own count gives
    assert 460e9 < seg["decide_0"] + seg["head_0"] + seg["final"] < 470e9
    arch = Arch(cfg)
    assert cells.cells_bound_s(arch, range(12), (1025, 2049)) > cells.cells_bound_s(arch, range(6), (1025, 2049)) > 0
