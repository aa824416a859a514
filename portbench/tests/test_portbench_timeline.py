"""The device's idle share and the idle gaps' labels on a synthetic
timeline."""
import types

import pytest

from portbench import spec, timeline


def _profile():
    device = [("gemm", 0.0, 2.0), ("gemm", 1.0, 3.0),   # overlap: 0-3 busy
              ("Memcpy HtoD", 6.0, 7.0), ("ssd_scan_fwd_scan_kernel", 9.0,
                                           9.5)]
    spans = [("runtime/step", 0.0, 10.0), ("wire/decode", 3.0, 6.0),
             ("publish/encode", 7.0, 8.5)]
    return {"t0": 0.0, "t1": 10.0, "device": device, "spans": spans,
            "launches": {}, "shapes": {}}


def test_busy_and_idle_share():
    p = _profile()
    assert timeline.device_busy(p) == pytest.approx(3.0 + 1.0 + 0.5)
    read = spec.metric_reader("device_idle_pct")
    assert read(types.SimpleNamespace(profile=p)) == pytest.approx(55.0)


def test_gaps_longest_first_labelled_by_the_innermost_open_span():
    p = _profile()
    gaps = timeline.gaps([(s, e) for _, s, e in p["device"]], 0.0, 10.0)
    assert gaps == [(3.0, 6.0), (7.0, 9.0), (9.5, 10.0)]
    b = timeline.breakdown(p)
    assert b["idle_gaps"] == [["wire/decode", 3.0],
                              ["publish/encode", 2.0],
                              ["runtime/step", 0.5]]
    assert b["device_ops"][0] == ["gemm", 4.0]
    assert timeline.label((20.0, 21.0), p["spans"]) == "host"


def test_merge_and_clip():
    assert timeline.merge([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == \
        [(0, 2.5), (3, 4)]
    assert timeline.busy([(-1.0, 1.0), (9.0, 12.0)], 0.0, 10.0) == 2.0


def test_kernel_family_matches_demangled_names():
    p = {"device": [("void ssd_scan_prep_kernel<64>(float*)", 0.0, 1.0),
                    ("ssd_scan_bwd_kernel", 1.0, 3.0),
                    ("my_ssd_scan_kernel", 3.0, 4.0)]}
    assert timeline.family_seconds(p, "ssd_scan_") == 3.0
    assert timeline.family_seconds(p, "dist_ce_") is None
