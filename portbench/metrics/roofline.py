"""<kernel>_roofline: a kernel's share of its roofline over the
profiled round. Its device time is every kernel of its family on the
card's timeline (forward and backward summed); the least time its
launches could take is, launch by launch, the larger of the algorithm's
operations over the 16-bit tensor-core peak and its bytes over HBM
bandwidth, counted by the frozen costs/<kernel>.py from the shapes the
program called it with and the number of launches its counters saw.
Moves fleet_samples_per_s."""


def read(r, kernel):
    from portbench.timeline import family_seconds

    p, mod = r.profile, r.costs.get(kernel)
    if p is None or mod is None:
        return None
    seconds = family_seconds(p, mod.PREFIX)
    calls = p["shapes"].get(kernel) or []
    if seconds is None or not calls:
        return None

    def bound(cost):
        flops, nbytes = cost
        return max(flops / r.peaks["flops_per_s"],
                   nbytes / r.peaks["bytes_per_s"])

    fwd_name, bwd_name = mod.COUNTERS
    n_fwd = p["launches"].get(fwd_name, 0)
    total = n_fwd * sum(bound(mod.fwd(s)) for s, _ in calls) / len(calls)
    if bwd_name is not None:
        trained = [s for s, train in calls if train]
        n_bwd = p["launches"].get(bwd_name, 0)
        if n_bwd and trained:
            total += n_bwd * sum(bound(mod.bwd(s)) for s in trained) \
                / len(trained)
    return 100.0 * total / seconds if total > 0 else None
