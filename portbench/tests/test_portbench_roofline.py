"""Each kernel's operations and bytes for one launch, against numbers
worked out by hand from the kernel's function."""

import pytest

from portbench import roofline
from portbench.roofline import peaks


def test_matmul_int8_resnet_stage1_1x1():
    # b128, 56 x 56: M = 128 * 56 * 56; 256 -> 64 channels; bias, int8 out
    key = (401408, 256, 64, True, 0, 1)
    ops, nbytes, peak = roofline.kernel("matmul_int8").cost(key)
    assert ops == 2 * 401408 * 64 * 256 == 13_153_337_344
    # a, b, scale row and bias (float32), the int8 output
    assert nbytes == 102_760_448 + 16_384 + 512 + 25_690_112
    assert peak == "int8"
    # bound by bytes: 128.5 MB at 3.35 TB/s is 38.3 us, 13.2 TOP 6.6 us
    assert roofline.bound_s(ops, nbytes, peak) == pytest.approx(
        128_467_456 / 3.35e12)


def test_matmul_int8_float_output_and_int8_residual():
    ops, nbytes, _ = roofline.kernel("matmul_int8").cost(
        (10, 20, 30, False, 1, 4))
    assert ops == 2 * 10 * 20 * 30
    assert nbytes == 10 * 20 + 20 * 30 + 4 * 30 + 10 * 30 * 1 + 10 * 30 * 4


def test_conv3x3_int8_resnet_stage1():
    key = (128, 56, 56, 64, 64, True, 0, 1)
    ops, nbytes, peak = roofline.kernel("conv3x3_int8").cost(key)
    assert ops == 2 * 401408 * 64 * 576 == 29_595_009_024
    assert nbytes == 25_690_112 + 36_864 + 512 + 25_690_112
    assert peak == "int8"
    # bound by bytes, just: 51.4 MB take 15.35 us, 29.6 TOP 14.95 us
    assert roofline.bound_s(ops, nbytes, peak) == pytest.approx(
        51_417_600 / 3.35e12)


def test_flash_causal_with_lengths():
    # B 2, H 4 over Hkv 2, S 8, D 64, bf16; rows of lengths 3 and 8
    key = (2, 4, 2, 8, 8, 64, 2, True, (3, 8))
    ops, nbytes, peak = roofline.kernel("flash_attention").cost(key)
    assert ops == 4 * 4 * 64 * (6 + 36) == 43_008
    assert nbytes == (2 * 2 * 4 * 8 * 64 + 2 * 2 * 2 * 8 * 64) * 2 + 2 * 4 * 16
    assert peak == "bf16"


def test_flash_causal_full_and_float32():
    key = (16, 16, 8, 512, 512, 128, 2, True, None)
    ops, _, _ = roofline.kernel("flash_attention").cost(key)
    assert ops == 4 * 16 * 128 * 16 * (512 * 513 // 2)
    f32 = (16, 16, 8, 512, 512, 128, 4, False, None)
    ops32, _, peak = roofline.kernel("flash_attention").cost(f32)
    assert peak == "tf32" and ops32 == 3 * 4 * 16 * 128 * 16 * 512 * 512
    assert roofline.kernel("flash_attention").pairs(4, 6, True) == 10


@pytest.mark.parametrize("M, want_bytes", [
    (16, 8_388_608 + 524_288 + 65_536 + 524_288),
    (16384, 8_388_608 + 524_288 + 67_108_864 + 536_870_912)])
def test_matmul_w4_decode_and_admission(M, want_bytes):
    key = (M, 2048, 8192, 128, 2, 4)
    ops, nbytes, peak = roofline.kernel("matmul_w4").cost(key)
    assert ops == 2 * M * 8192 * 2048
    assert nbytes == want_bytes and peak == "bf16"


def test_matmul_w4_float32_routes():
    m = roofline.kernel("matmul_w4")
    assert m.cost((8, 256, 64, 128, 4, 4))[0] == 2 * 2 * 8 * 64 * 256
    assert m.cost((8, 256, 64, 128, 4, 4))[2] == "tf32"
    assert m.cost((8, 96, 64, 48, 4, 4))[2] == "fp32"


def test_peaks_are_the_published_ones():
    assert peaks.PEAK_OPS == {"int8": 1979e12, "bf16": 989e12,
                              "tf32": 495e12, "fp32": 67e12}
    assert peaks.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("name, kernel", [
    ("void ak::igemm_s8<false, 1, 128>(ak::Params)", "matmul_int8"),
    ("void ak::igemm_s8<true, 2, 64>(ak::Params)", "conv3x3_int8"),
    ("void flash_wgmma<128, 2>(FlashArgs)", "flash_attention"),
    ("void w4_small<16, true, false, false>(Args)", "matmul_w4"),
    ("void w4_wgmma_tf32(Args, CUtensorMap)", "matmul_w4")])
def test_trace_names(name, kernel):
    assert roofline.family_of(name) == (kernel, "main")
    assert roofline.family_of("sum_splits(float const*, float*)") == \
        ("matmul_w4", "aux")
    assert roofline.family_of("void at::native::vectorized_elementwise") is None
