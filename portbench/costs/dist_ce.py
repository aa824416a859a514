"""dist_ce's algorithm counts: over R rows of V classes, the student's
and the teacher's softmax statistics, the distillation cross-entropy
-sum p_t log p_s, and both confidences (the largest probability).

Forward, per element: a max, a subtract and an exponential for each side,
their sums, and the product-sum of the cross-entropy: 10 operations.
Bytes: both rows read once (the student in its dtype, the teacher in
float32) and three floats a row written. Backward, per element: both
softmaxes again and g·(p_s − p_t): 8 operations; both rows, the saved
statistics and g read once, the student's gradient written once in its
dtype.

Frozen with the benchmark: a later change to the kernel changes its
time, never these counts."""

ENTRY = "dist_ce"
PREFIX = "dist_ce_"
COUNTERS = ("dist_ce_fwd", "dist_ce_bwd")
F32 = 4


def shape_of(s, t, *args, **kw) -> dict:
    R, V = (int(n) for n in s.shape)
    return {"R": R, "V": V, "s_bytes": s.element_size(),
            "t_bytes": t.element_size()}


def fwd(s: dict):
    R, V = s["R"], s["V"]
    return 10 * R * V, R * V * (s["s_bytes"] + s["t_bytes"]) + 3 * F32 * R


def bwd(s: dict):
    R, V = s["R"], s["V"]
    nbytes = R * V * (2 * s["s_bytes"] + s["t_bytes"]) + 4 * F32 * R
    return 8 * R * V, nbytes
