"""The frozen algorithm counts against hand-reckoned cases, and the
roofline reader on a synthetic profile."""
import types

import pytest
import torch

from portbench import spec


def test_ssd_scan_counts():
    c = spec.kernel_costs("ssd_scan")
    s = c.shape_of(torch.zeros(1, 2, 1, 2), torch.zeros(1, 2, 1),
                   torch.zeros(1), torch.zeros(1, 2, 3), torch.zeros(1, 2, 3),
                   torch.zeros(1), 2)
    assert s == {"Bt": 1, "T": 2, "H": 1, "P": 2, "N": 3}
    # 2 steps x (5·P·N + 3·P) = 2 x 36; reads x 4 + dt 2 + A 1 + B, C 12 +
    # D 1 = 20 floats, writes y 4 + state 6 floats
    assert c.fwd(s) == (72, 4 * (20 + 10))
    # twice the operations; the inputs and dy read, the inputs' grads
    # written
    assert c.bwd(s) == (144, 4 * (20 + 20 + 4))


def test_dist_ce_counts():
    c = spec.kernel_costs("dist_ce")
    s = c.shape_of(torch.zeros(2, 3, dtype=torch.bfloat16),
                   torch.zeros(2, 3))
    assert s == {"R": 2, "V": 3, "s_bytes": 2, "t_bytes": 4}
    assert c.fwd(s) == (60, 6 * (2 + 4) + 3 * 4 * 2)
    assert c.bwd(s) == (48, 6 * (2 + 2 + 4) + 4 * 4 * 2)


def test_topk_wire_counts():
    c = spec.kernel_costs("topk_wire")
    s = c.shape_of(torch.zeros(2, 5), 2)
    assert s == {"R": 2, "V": 5, "k": 2}
    assert c.fwd(s) == (40, 4 * (10 + 2 * 2 * 2 + 2))
    with pytest.raises(ValueError):
        c.bwd(s)


def _profile(seconds, launches, calls):
    return {"t0": 0.0, "t1": 1.0, "launches": launches, "shapes": calls,
            "device": [("void topk_wire_kernel(float const*)", 0.0,
                        seconds)], "spans": []}


def test_roofline_reader_is_the_bound_over_the_device_time():
    read = spec.metric_reader("topk_wire_roofline")
    peaks = {"flops_per_s": 1e3, "bytes_per_s": 1e3}
    shape = {"R": 2, "V": 5, "k": 2}  # 40 ops, 80 bytes: 0.08 s at 1e3
    r = types.SimpleNamespace(
        peaks=peaks, costs={"topk_wire": spec.kernel_costs("topk_wire")},
        profile=_profile(0.32, {"topk_wire": 2}, {"topk_wire": [
            (shape, False), (shape, False)]}))
    assert read(r) == pytest.approx(100 * 2 * 0.08 / 0.32)
    # a kernel the round did not launch reads nothing, never 0
    r.profile = _profile(0.0, {"topk_wire": 0}, {"topk_wire": []})
    assert read(r) is None
