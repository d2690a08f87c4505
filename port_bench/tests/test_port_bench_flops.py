"""The analytic counts and the kernels' bounds against hand counts."""
import pytest

from port_bench import bounds, flops

R50 = {"depth": 50, "fpn_channels": 256, "num_anchors": 9, "head_layers": 4}


def test_resnet50_at_224_is_4_09_gmacs():
    assert flops.backbone_macs(50, 224, 224) == pytest.approx(4.09e9, rel=0.01)


def test_resnet101_at_224_is_7_8_gmacs():
    assert flops.backbone_macs(101, 224, 224) == pytest.approx(7.8e9, rel=0.01)


def test_retinanet_r50_at_608x832_is_about_105_gmacs():
    assert flops.forward_macs(R50, 20, 608, 832) == pytest.approx(105e9, rel=0.01)


def test_hand_count_of_the_stem_and_a_head_conv():
    convs = {c.name: c for c in flops.convs(R50, 20, 608, 832)}
    assert convs["backbone.conv1"].macs == 304 * 416 * 64 * 3 * 49
    assert convs["classification_head.output@P3"].macs == 76 * 104 * 180 * 256 * 9
    assert convs["fpn.p7"].hw_out == (5, 7) and convs["fpn.p6"].hw_out == (10, 13)
    assert convs["backbone.layer4_0.conv2"].hw_out == (19, 26)


def test_the_int8_path_has_100_quantized_convs():
    convs = list(flops.convs(R50, 20, 608, 832))
    assert sum(c.int8 for c in convs) == 100
    modes = [c.k == 3 and c.cin % 16 == 0 for c in convs if c.int8]
    assert sum(modes) == 61          # conv mode; the other 39 are 1x1 GEMMs


def test_train_step_counts_student_backward_and_teacher():
    cfg = dict(R50, depth=101)
    fwd20 = flops.forward_macs(cfg, 20, 608, 832)
    fwd15 = flops.forward_macs(cfg, 15, 608, 832)
    stem = 304 * 416 * 64 * 3 * 49
    assert flops.train_step_macs(cfg, 20, 15, 608, 832) == 3 * fwd20 - stem + fwd15
    assert 2 * flops.train_step_macs(cfg, 20, 15, 608, 832) == pytest.approx(1.13e12, rel=0.01)


def test_stem_bound_is_the_smoke_tests_0_0774_ms():
    assert bounds.stem_bound_s(32, 608, 832) * 1e3 == pytest.approx(0.0774, abs=5e-5)


def test_int8_bounds_by_hand():
    # 63232 x 2304 x 256 (the int8 tool's GEMM): bound by its bytes, the
    # smoke test's 0.0531 ms
    m, k, n = 63232, 2304, 256
    assert bounds.int8_gemm_bound_s(m, k, n) == pytest.approx(
        (m * k + n * k + m * n * 2 + 8 * n) / 3.35e12)
    assert bounds.int8_gemm_bound_s(m, k, n) * 1e3 == pytest.approx(0.0533, abs=3e-4)
    # a large square GEMM: bound by its operations
    m = k = n = 8192
    assert bounds.int8_gemm_bound_s(m, k, n) == pytest.approx(2.0 * m * k * n / 1979e12)


def test_predict_least_time_and_its_mfu_check():
    """A cross-check with a measured rate: ~210 GFLOP an image at 462 images/s is an
    MFU of ~0.098."""
    least = flops.predict_least_s(R50, 20, 608, 832, 32, False, 989e12, 1979e12)
    assert least / (32 / 462.0) == pytest.approx(0.098, abs=0.003)
    assert flops.predict_least_s(R50, 20, 608, 832, 32, True, 989e12, 1979e12) < least
