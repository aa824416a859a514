"""publish_step_ms: the mean host-clock time of the traced window's steps
that end in a publish round (core/runtime.py ``_publish_round``: teacher
forwards, encode, delivery, decode and densify), each ended by
torch.cuda.synchronize(). Moves fleet_samples_per_s."""


def read(r):
    s = [st["seconds"] for st in r.steps if st["publish"]]
    return 1e3 * sum(s) / len(s) if s else None
