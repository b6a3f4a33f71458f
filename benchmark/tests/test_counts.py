"""The frozen operation counts against hand-worked values."""

from benchmark import counts


def test_rbf_forward_flagship_at_1000_lanes():
    # B R K (3F + 6 + 2O) + 8 B R F at B=1000, R=16, K=512, F=8, O=10
    ops = counts.rbf_forward_ops(1000, 16, 512, 8, 10)
    assert ops == 1000 * 16 * 512 * 50 + 8 * 1000 * 16 * 8 == 410_624_000
    assert round(ops / 1e9, 2) == 0.41


def test_admm_per_row_and_sweep():
    assert counts.admm_ops_per_row_sweep(8) == 2744
    assert counts.admm_ops(1, 600) == 2744 * 600
    # a family of 2,642,368 goals at 600 sweeps: 4.35 TFLOP, 65 ms bound
    fam = counts.admm_ops(2_642_368, 600)
    assert round(fam / 1e12, 2) == 4.35
    assert abs(counts.roofline_seconds(fam, counts.admm_bytes(2_642_368))
               - 0.06502) < 1e-4


def test_control_step_is_mostly_the_forward():
    step = counts.control_step_flops(1000, 16, 512, 8, 10, 512)
    fwd = counts.rbf_forward_ops(1000, 16, 512, 8, 10)
    assert fwd < step < 1.1 * fwd
