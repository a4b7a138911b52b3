"""The operation and byte counts reproduce the bounds the port's records
give (PERF.md's table of kernels)."""

import pytest

from gpbench import counts


@pytest.mark.parametrize("cost, ms", [
    (counts.kron(1, [32] * 5, 4), 0.0801),  # K2 at 32⁵, float32
    (counts.kron(8, [32] * 4, 4), 0.0200),  # X3 on (I₈ ⊗ 32⁴)
    (counts.stencil(9, 32 ** 4, 81, 4), 0.1240),  # K5 at 32⁴, B = 9, 81 offsets
], ids=["k2_32x5", "x3_i8_32x4", "k5_32x4_b9"])
def test_bounds(cost, ms):
    assert cost.seconds * 1e3 == pytest.approx(ms, abs=5e-5)


def test_bytes_bound_kron():
    c = counts.kron(9, [32] * 4, 4)
    assert c.bytes / counts.PEAK_BYTES_S > c.flops / counts.PEAK_FLOPS[c.grade]


def test_gram_is_operation_bound():
    c = counts.gram(9, 40_000, 2, 4)
    assert c.seconds == pytest.approx(c.flops / counts.PEAK_FLOPS["fp32"])
