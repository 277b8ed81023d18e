"""chip_smoke.py's cost and bound arithmetic, on the CPU.

``chip_smoke.py`` reports beside each kernel the least time the card could
take for its work. These tests hold the counts of work and the bounds of
the 3xTF32 kernels (the flash forward, dq and dk/dv, ``attention_core`` and
``fused_attention``) at the faces shapes, within 1 %, and the way a checked row's bound is
chosen and summed. Nothing here needs a card: the arithmetic uses the
H100 SXM's published peaks and its 132 SMs at 1.98 GHz.
"""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

REL = 0.01
#: an H100 SXM's SM count and highest SM clock (Hz)
H100 = dict(sms=132, sm_hz=1.98e9)


def test_flash_forward_at_dh_128_is_bound_by_the_tensor_cores():
    # the faces decode's VQ mid block: (B, H, N, dh) = (32, 1, 4096, 128)
    products, exps = chip_smoke.flash_fwd_work(32, 1, 4096, 128)
    assert products == pytest.approx(2.749e11, rel=REL)
    tc_ms, exp_ms, _ = chip_smoke.design_bounds(products, exps, **H100)
    assert tc_ms == pytest.approx(1.67, rel=REL)
    assert tc_ms > exp_ms


def test_flash_forward_at_dh_8_is_bound_by_the_exponentials():
    # five UNet sites at the faces 64x64 level: B * H = 256, N 4096, dh 8
    products, exps = chip_smoke.flash_fwd_work(32, 8, 4096, 8)
    assert exps == pytest.approx(4.295e9, rel=REL)
    tc_ms, exp_ms, _ = chip_smoke.design_bounds(products, exps, **H100)
    assert exp_ms == pytest.approx(1.03, rel=REL)
    assert tc_ms == pytest.approx(0.83, rel=REL)


def test_flash_dq_at_the_faces_64x64_level():
    # the faces micro-step's 64x64 UNet level: (B, H, N, dh) = (8, 8, 4096, 8)
    products, exps = chip_smoke.flash_bwd_work("flash_attention_dq",
                                               8, 8, 4096, 8)
    assert products == pytest.approx(5.154e10, rel=REL)
    assert exps == pytest.approx(1.074e9, rel=REL)
    tc_ms, exp_ms, _ = chip_smoke.design_bounds(products, exps, **H100)
    assert tc_ms == pytest.approx(0.312, rel=REL)
    assert exp_ms == pytest.approx(0.257, rel=REL)


def test_flash_dkdv_at_the_faces_64x64_level():
    products, exps = chip_smoke.flash_bwd_work("flash_attention_dkdv",
                                               8, 8, 4096, 8)
    assert products == pytest.approx(6.872e10, rel=REL)
    assert exps == 8 * 8 * 4096 ** 2
    tc_ms, exp_ms, _ = chip_smoke.design_bounds(products, exps, **H100)
    assert tc_ms == pytest.approx(0.417, rel=REL)
    assert tc_ms > exp_ms


@pytest.mark.parametrize("name,products", [("flash_attention_dq", 3),
                                           ("flash_attention_dkdv", 4)])
def test_flash_backward_products_are_the_fp32_costs_products(name, products):
    # the fp32 bound's operations are the design's products plus one
    # exponential a score, at the faces 32x32 level
    work, exps = chip_smoke.flash_bwd_work(name, 8, 8, 1024, 16)
    _, ops = chip_smoke.flash_cost(name, 8, 8, 1024, 16)
    assert work == 2 * products * 64 * 1024 ** 2 * 16
    assert ops == work + exps


def test_fused_attention_cost_at_the_faces_64x64_level():
    nbytes, ops = chip_smoke.fused_cost(32, 4096, 64, 20, 16, 8, 8)
    assert ops == pytest.approx(2.905e9, rel=REL)
    assert nbytes == pytest.approx(67.19e6, rel=REL)
    products, simt, exps = chip_smoke.fused_work(32, 4096, 64, 20, 16, 8, 8)
    # the same operations, split between the tensor cores and the CUDA cores
    assert products + simt == ops
    assert exps == 32 * 8 * 4096 * 20


@pytest.mark.parametrize("row,want", [
    (dict(bytes_ms=1.0, ops_ms=3.0), 3.0),
    (dict(bytes_ms=1.0, ops_ms=9.0, tc_ms=2.0, exp_ms=0.5), 2.0),
    (dict(bytes_ms=4.0, ops_ms=9.0, tc_ms=2.0, exp_ms=0.5, simt_ms=1.0), 4.0),
    (dict(bytes_ms=0.2, ops_ms=9.0, tc_ms=0.3, exp_ms=0.5, simt_ms=1.0), 1.0)])
def test_bound_takes_the_design_of_the_3xtf32_kernels(row, want):
    assert chip_smoke.bound(row) == want


def test_summed_rows_keep_both_bounds():
    rows = [dict(ms=5.0, plain_ms=9.0, library_ms=4.0, err=1e-6, count=2,
                 bytes_ms=0.1, ops_ms=3.0, tc_ms=1.0, exp_ms=0.4),
            dict(ms=1.0, plain_ms=2.0, library_ms=1.5, err=2e-6, count=1,
                 bytes_ms=0.5, ops_ms=1.0, tc_ms=0.2, exp_ms=0.1)]
    out = chip_smoke.summed("flash_attention_fwd", rows)
    assert out["bound_ms"] == pytest.approx(2 * 1.0 + 0.5)
    assert out["fp32_bound_ms"] == pytest.approx(2 * 3.0 + 1.0)
    assert out["tc_ms"] == pytest.approx(2.2)
    assert out["exp_ms"] == pytest.approx(0.9)
    assert out["binds"] == "tensor cores"
    assert out["bound_by"] == "operations"
    assert out["ms"] == pytest.approx(11.0)
    assert out["max_abs_err"] == 2e-6


#: the flagship's serving shapes of attention_core (B, H, N, M, dh): the
#: UNet's self-attention at 16², 8², 4², 2² and the VQ decoder's mid block
SERVING_ATTENTION = [(160, 8, 256, 256, 8), (160, 8, 64, 64, 16),
                     (160, 8, 16, 16, 32), (160, 8, 4, 4, 32),
                     (160, 1, 256, 256, 128)]


@pytest.mark.parametrize("shape", SERVING_ATTENTION)
def test_attention_core_design_work_at_the_serving_shapes(shape):
    b, h, n, m, dh = shape
    products, exps = chip_smoke.attn_core_work(*shape)
    assert products == 4 * b * h * n * m * dh
    assert exps == b * h * n * m
    nbytes, ops = chip_smoke.attn_cost(*shape)
    assert nbytes == 4 * b * h * dh * (2 * n + 2 * m)
    # the fp32 bound's operations are the design's products plus the softmax
    assert ops == products + 4 * exps


def test_attention_core_at_the_vq_mid_block_is_bound_by_the_tensor_cores():
    products, exps = chip_smoke.attn_core_work(160, 1, 256, 256, 128)
    assert products == pytest.approx(5.37e9, rel=REL)
    tc_ms, exp_ms, _ = chip_smoke.design_bounds(products, exps, **H100)
    assert tc_ms == pytest.approx(0.0325, rel=REL)
    nbytes, _ = chip_smoke.attn_cost(160, 1, 256, 256, 128)
    assert nbytes == pytest.approx(83.9e6, rel=REL)
    assert tc_ms > nbytes / chip_smoke.PEAK_BYTES * 1e3 > exp_ms


def test_gn_silu_bwd3_at_the_vq_decoder_is_bound_by_bytes():
    """The third-order GN-SiLU kernel at the decoder's (128, 64, 64, 64):
    x, g and two cotangents read, two outputs written, 4 bytes each; its
    fp32 operations stay under the bytes' time."""
    n = 128 * 64 * 64 * 64
    nbytes, ops = chip_smoke.gn_bwd3_cost((128, 64, 64, 64))
    assert nbytes == 4 * (6 * n + 2 * 64)
    bytes_ms = nbytes / chip_smoke.PEAK_BYTES * 1e3
    assert bytes_ms == pytest.approx(0.2404, rel=REL)
    assert ops / chip_smoke.PEAK_FP32 * 1e3 < bytes_ms
