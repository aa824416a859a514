"""local_step_ms: the mean host-clock time of the traced window's steps
that do not publish, each ended by torch.cuda.synchronize(). Layer: the
trainer (core/runtime.py ``step``). Moves fleet_samples_per_s."""


def read(r):
    s = [st["seconds"] for st in r.steps if not st["publish"]]
    return 1e3 * sum(s) / len(s) if s else None
