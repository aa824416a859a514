"""wire_decode_ms: the program tracer's ``wire/decode`` spans
(core/runtime.py ``_decode_window``: decode, numpy densify, copy to the
card; host time) summed over the traced window, per publish round. Moves
fleet_samples_per_s."""


def read(r):
    total = sum(e - s for n, s, e in r.spans if n == "wire/decode")
    return 1e3 * total / r.rounds if r.rounds and total > 0 else None
