"""ssd_scan's algorithm counts: the Mamba2 scan h_t = exp(dt_t A) h_{t-1}
+ dt_t B_t x_t^T, y_t = C_t^T h_t + D x_t over (Bt, T) rows of H heads
of size P with state N, in float32.

Forward, per (row, step, head): the decay of the state (P·N), the
outer-product update (2·P·N), the readout (2·P·N) and dt·x and D·x
(3·P): 5·P·N + 3·P operations. Bytes: x, dt, A, B, C and D read once, y
and the final state written once. Backward: twice the forward's
operations; x, dt, A, B, C, D and dy read once, their gradients written
once. Work the implementation adds (chunk states saved for the backward,
recomputation, the 3×TF32 split) is not counted, so no implementation
can read above its bound.

Frozen with the benchmark: a later change to the kernel changes its
time, never these counts."""

ENTRY = "ssd_scan"  # the program's entry point in repro_torch.kernels.ops
PREFIX = "ssd_scan_"  # its device kernels' names
COUNTERS = ("ssd_scan_fwd", "ssd_scan_bwd")  # launch counters: fwd, bwd
F32 = 4


def shape_of(x, dt, A, B, C, D, *args, **kw) -> dict:
    Bt, T, H, P = (int(s) for s in x.shape)
    return {"Bt": Bt, "T": T, "H": H, "P": P, "N": int(B.shape[-1])}


def _bytes_io(s: dict) -> int:
    Bt, T, H, P, N = s["Bt"], s["T"], s["H"], s["P"], s["N"]
    return F32 * (Bt * T * H * P + Bt * T * H + H + 2 * Bt * T * N + H)


def fwd(s: dict):
    Bt, T, H, P, N = s["Bt"], s["T"], s["H"], s["P"], s["N"]
    flops = Bt * T * H * (5 * P * N + 3 * P)
    nbytes = _bytes_io(s) + F32 * (Bt * T * H * P + Bt * H * P * N)
    return flops, nbytes


def bwd(s: dict):
    Bt, T, H, P, N = s["Bt"], s["T"], s["H"], s["P"], s["N"]
    flops = 2 * Bt * T * H * (5 * P * N + 3 * P)
    # inputs and dy read, the inputs' gradients written
    nbytes = 2 * _bytes_io(s) + F32 * Bt * T * H * P
    return flops, nbytes
