"""topk_wire's algorithm counts: over R rows of V logits in float32, the
k largest values with their indices, and the row's logsumexp.

Per element: a comparison against the running k-th value, and a
subtract, an exponential and an add for the logsumexp: 4 operations.
Bytes: the logits read once; k values and k int32 indices and the
logsumexp written once a row. No backward.

Frozen with the benchmark: a later change to the kernel changes its
time, never these counts."""

ENTRY = "topk_wire"
PREFIX = "topk_wire_"
COUNTERS = ("topk_wire", None)
F32 = 4


def shape_of(logits, k, *args, **kw) -> dict:
    R, V = (int(n) for n in logits.shape)
    return {"R": R, "V": V, "k": int(k)}


def fwd(s: dict):
    R, V, k = s["R"], s["V"], s["k"]
    return 4 * R * V, F32 * (R * V + 2 * R * k + R)


def bwd(s: dict):
    raise ValueError("topk_wire has no backward")
