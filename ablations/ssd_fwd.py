#!/usr/bin/env python3
"""Where the time of ``ssd_scan``'s forward kernels goes, on one card.

    python3 ablations/ssd_fwd.py

Builds copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with one
part of the forward taken out or swapped, each by a text patch of the
committed source, and times them beside the kernels themselves at the LM
path's shape (8, 512, 32, 64, N 128) and the hybrid path's (8, 512, 112,
64, N 64), f32, without saving the chunk states:

  * "loads not overlapped": each thread waits for its copies of the next
    chunk as soon as it has issued them (no double buffering);
  * "C.B^T per head": every (b, h) block forms C.B^T again for each chunk
    and drops it (the prep kernel still runs, so subtract "prep kernel
    alone");
  * "prep kernel alone" (no y): the first kernel, C.B^T once per (b,
    chunk) and every head's cumsum, without the scan;
  * "no state update" (wrong sums): the scan without h's update, so y's
    products and the loads alone;
  * "no C.h^T", "no M x" (wrong sums): y without the one or the other of
    its two products;
  * "M not formed" (wrong sums): C B^T taken as M after the first chunk,
    with no gate, dt_u, w_u or exp(s_t) formed;
  * "gate not exponentiated" (wrong sums): exp(s_t - s_u) taken as 1 where
    M is formed, so what the gate's IEEE expf costs;
  * "one MMA of three" (wrong sums): each product is big.big alone
    (1xTF32): what the two error-compensating MMAs cost;
  * "parallel over chunks (probe)": Mamba2's own split in place of the
    scan kernel (ablations/ssd_fwd_chunks_probe.cu): each chunk's state in
    parallel, a pass over the chunks that is elementwise on (P, N), then
    y in parallel; it writes and reads the chunks' states through device
    memory, and sums h in another order.

Each variant is timed twice, in the order kernel ... last, last ...
kernel (median of 20 CUDA-event times of 10 calls back to back, so that
the card does not wait on the host's launches); the variants that compute
the same function give their largest difference from the kernel's y. Prints
the card's name and power limit first; exits non-zero without a card, or
if a patch no longer applies to the source. The patching, nvcc and timing
helpers are tools/flash_fwd_ablation.py's and scripts/flash_bwd_ablation.py's.
tests/test_torch_kernels.py checks on the CPU that the patches apply to the
source.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from flash_fwd_ablation import BWD, patched  # noqa: E402  (src on the path)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

SHAPES = [(8, 512, 32, 64, 128), (8, 512, 112, 64, 64)]
OUT = ROOT / "build" / "ssd_fwd_ablation"
REPEAT = 10  # calls a timing
EARLY = ("      load_early(c + 1);\n      cp_async_commit();\n")
LATE = ("      load_late(c + 1);\n      cp_async_commit();\n")
CB_PER_HEAD = (
    "    {  // C B^T of this chunk again, dropped\n"
    "      const int r = warp >> 1, half = warp & 1;\n"
    "      if (warp < 8 && !(half == 1 && r < 2)) {\n"
    "        float cbv[4][4] = {};\n"
    "#pragma unroll\n"
    "        for (int ks = 0; ks < NMAX / 8; ++ks) {\n"
    "          const Split<4> a = frag_a<F::kLdC>(cs, 16 * r, 8 * ks, lane);\n"
    "#pragma unroll\n"
    "          for (int q = 0; q < 4; ++q)\n"
    "            mma3(cbv[q], a, frag_bt<F::kLdB>(bs, 32 * half + 8 * q,"
    " 8 * ks, lane));\n"
    "        }\n"
    "        float sum = 0.f;\n"
    "        for (int q = 0; q < 4; ++q)\n"
    "          sum += cbv[q][0] + cbv[q][1] + cbv[q][2] + cbv[q][3];\n"
    "        if (sum == 1.2345e30f) hs[0] = sum;\n"
    "      }\n"
    "      __syncthreads();\n"
    "    }\n")
VARIANTS = {
    "kernel": [],
    "loads not overlapped": [(EARLY, EARLY + "      cp_async_wait_all();\n"),
                             (LATE, LATE + "      cp_async_wait_all();\n")],
    "C.B^T per head": [("    // y[t][p] = sum_u M[t][u] x[u][p] + sum_n exp",
                        CB_PER_HEAD + "    // y[t][p] = sum_u M[t][u] x[u][p]"
                        " + sum_n exp")],
    "prep kernel alone": [("  ssd_scan_fwd_scan_kernel<NMAX><<<",
                           "  if (Bt < 0) ssd_scan_fwd_scan_kernel<NMAX><<<")],
    "no state update": [("    {\n      constexpr int NQ = NMAX / 32;",
                         "    if (T < 0) {\n      constexpr int NQ = NMAX / 32;")],
    "no C.h^T": [("    for (int ks = 0; ks < NMAX / 8; ++ks) {\n"
                  "      float v[4], hv[4];",
                  "    for (int ks = 0; ks < (T < 0 ? NMAX / 8 : 0); ++ks) {\n"
                  "      float v[4], hv[4];")],
    "no M x": [("    for (int ks = 0; ks < 2 * R + 2; ++ks) {",
                "    for (int ks = 0; ks < (T < 0 ? 2 * R + 2 : 0); ++ks) {")],
    "M not formed": [("      form_m(c + 1);\n", "")],
    "gate not exponentiated": [("*m * expf(ss[t] - su) * du", "*m * du")],
    "one MMA of three": [("  mma_tf32(c, a.small, b.big);\n"
                          "  mma_tf32(c, a.big, b.small);\n", "")],
}
# Mamba2's split, three kernels in place of the scan; its source is
# appended to the kernel's
PROBE = ROOT / "ablations" / "ssd_fwd_chunks_probe.cu"
VARIANTS["parallel over chunks (probe)"] = [
    ("template <int NMAX>\nint launch_fwd(",
     "template <int NMAX>\n"
     "int probe_chunks(const float* x, const float* dt, const float* D,\n"
     "                 const float* B, const float* C, const float* cb,\n"
     "                 const float* s, float* y, float* fin, float* states,\n"
     "                 float* extra, int Bt, int T, int H, int P, int N,\n"
     "                 cudaStream_t stream);\n\n"
     "template <int NMAX>\nint launch_fwd("),
    ("  ssd_scan_fwd_scan_kernel<NMAX><<<dim3(H, Bt), kFwdThreads, F::kSmem,\n"
     "                                   stream>>>(\n"
     "      x, dt, D, B, C, cb, s, y, fin, states, T, H, P, N);\n"
     "  return (int)cudaGetLastError();",
     "  return probe_chunks<NMAX>(x, dt, D, B, C, cb, s, y, fin, states,\n"
     "                            s + (size_t)Bt * nc * kL * H, Bt, T, H, P,"
     " N,\n                            stream);"),
    ("  return (long long)Bt * ((T + kL - 1) / kL) * kL * (kL + H);",
     "  return (long long)Bt * ((T + kL - 1) / kL) *\n"
     "         (kL * (kL + H) + 2LL * H * kPMax * kNMax);")]
APPEND = {"parallel over chunks (probe)": PROBE}
EXACT = ("loads not overlapped", "C.B^T per head",
         "parallel over chunks (probe)")


def build_all() -> dict:
    """One nvcc per variant, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "ssd_scan.cu").read_text()
    texts = {n: patched(source, n, p)
             + (APPEND[n].read_text() if n in APPEND else "")
             for n, p in VARIANTS.items()}
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        (OUT / f"v{i}.cu").write_text(text)
        procs[name] = (OUT / f"libv{i}.so",
                       BWD.nvcc(OUT / f"v{i}.cu", OUT / f"libv{i}.so"))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log.decode()}")
        spills = [ln.strip() for ln in log.decode().splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        if spills:
            print(f"{name}: {spills}", flush=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.ssd_scan_fwd_f32.argtypes = ([ctypes.c_void_p] * 10
                                         + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p])
        lib.ssd_scan_fwd_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_fwd_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for Bt, T, H, P, N in SHAPES:
        # chip_smoke.py's "model" inputs: A = -(1..H), dt around 0.05
        x = torch.randn(Bt, T, H, P, generator=g, device=dev)
        dt = F.softplus(torch.randn(Bt, T, H, generator=g, device=dev) * 0.5
                        - 3.0)
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
        B, C = (torch.randn(Bt, T, N, generator=g, device=dev)
                for _ in range(2))
        D = torch.ones(H, device=dev)
        outs = {n: (torch.empty_like(x),
                    torch.empty(Bt, H, P, N, device=dev)) for n in libs}
        scratch = torch.empty(
            max(lib.ssd_scan_fwd_scratch_floats(Bt, T, H)
                for lib in libs.values()), device=dev)

        def fwd(n):
            y, fin = outs[n]
            err = libs[n].ssd_scan_fwd_f32(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), y.data_ptr(), fin.data_ptr(),
                None, scratch.data_ptr(), Bt, T, H, P, N, stream)
            if err:
                raise SystemExit(f"{n}: launch failed: cudaError {err}")

        def calls(n):  # back to back, so the card does not wait on the host
            for _ in range(REPEAT):
                fwd(n)

        names = list(libs)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(BWD.time_ms(lambda: calls(n)) / REPEAT)
        for n in names:
            diff = (f", max|y - kernel's y| "
                    f"{float((outs[n][0] - outs['kernel'][0]).abs().max()):.3g}"
                    if n in EXACT else "")
            print(f"({Bt}, {T}, {H}, {P}, N {N}) f32, {n}: "
                  f"{ms[n][0]:.4f} / {ms[n][1]:.4f} ms{diff}", flush=True)
        del x, dt, B, C, outs, scratch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
