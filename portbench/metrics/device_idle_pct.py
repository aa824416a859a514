"""device_idle_pct: the profiled round's share of time in which no
kernel, copy or fill ran on the card, from torch.profiler's timeline.
Layer: the device. Moves fleet_samples_per_s."""


def read(r):
    from portbench.timeline import device_busy

    p = r.profile
    if p is None or p["t1"] <= p["t0"]:
        return None
    return 100.0 * (1.0 - device_busy(p) / (p["t1"] - p["t0"]))
