#!/usr/bin/env python3
"""Where the time of ``ssd_scan``'s backward kernels goes, on one card.

    python3 ablations/ssd_bwd.py

Builds copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with one
part of the backward taken out or swapped, each by a text patch of the
committed source, and times them beside the kernels themselves at the LM
path's shape (8, 512, 32, 64, N 128) and the hybrid path's (8, 512, 112,
64, N 64), f32, without a final state's gradient (as on the paths):

  * "loads not overlapped": each thread waits for its copies as soon as
    it has issued them (no double buffering);
  * "C.B^T per head": every (b, h) block forms C.B^T again for each chunk
    from its B and C tiles and drops it (so what the prep kernel saves);
  * "prep kernel alone" (no gradients): the first kernel, C.B^T once per
    (b, chunk) and every head's cumsum, without the backward scan;
  * "one MMA of three" (wrong sums): each product is big.big alone
    (1xTF32): what the two error-compensating MMAs cost;
  * "no dh update" (wrong sums): dh is only decayed, never gains the
    chunk's (exp(s) o dy)^T C;
  * "no dB/dC state terms" (wrong sums): dB without (w o x) dh and dC
    without dy h0, so their intra-chunk products alone;
  * "six barriers a chunk": chunk c - 1's C and h0 load after chunk c's
    step 5 and its x after step 3, each behind a barrier of its own;
  * "loops fully unrolled", "unrolled twice at NMAX 128", "not unrolled
    at NMAX 64": the product loops' other unroll choices;
  * "no step 1" ... "no step 6" (wrong sums): the kernel with one of its
    six steps (dM and the gate; dx; dB; dC; the dh update; the scalar
    pass) left out.

Prints each variant's registers and spills (nvcc -Xptxas -v). Each
variant is timed twice, in the order kernel ... last, last ...
kernel (median of 20 CUDA-event times of 10 calls back to back, so that
the card does not wait on the host's launches); the variants that compute
the same function give their largest difference from the kernel's
gradients (the backward is bitwise reproducible, so an exact variant
shows 0 or the rounding of another order). Then it times the wrapper's
head sums of the dB and dC partials (two PyTorch reductions) at each
shape. Prints the card's name and power limit first; exits non-zero
without a card, or if a patch no longer applies to the source. The
patching, nvcc and timing helpers are ablations/ssd_fwd.py's.
tests/test_torch_kernels.py checks on the CPU that the patches apply to
the source.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "ablations"))

import ssd_fwd  # noqa: E402  (puts tools/ and src/ helpers in reach)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

SHAPES = ssd_fwd.SHAPES
OUT = ROOT / "build" / "ssd_bwd_ablation"
REPEAT = 10  # calls a timing
LOADS = ("if (c > 0) load_dy(c - 1)", "if (c > 0) load_cb(c - 1)",
         "if (c > 0) load_x(c - 1)", "if (c > 0) load_b(c - 1)",
         "load_ch(c)")
CB_PER_HEAD = (
    "    {  // C B^T of this chunk again, from B and C, dropped\n"
    "      if (warp < 10) {\n"
    "        const int R = warp < 1 ? 0 : warp < 3 ? 1 : warp < 6 ? 2 : 3;\n"
    "        const int Cb = warp - R * (R + 1) / 2;\n"
    "        float cbv[2][4] = {};\n"
    "#pragma unroll\n"
    "        for (int ks = 0; ks < NMAX / 8; ++ks) {\n"
    "          float a[4], bv[4];\n"
    "          ldmatrix_a<NMAX, true>(a, cs, 16 * R, 8 * ks, lane);\n"
    "          ldmatrix_a<NMAX, true>(bv, bs, 16 * Cb, 8 * ks, lane, true);\n"
    "          const Split<4> sa = split(a);\n"
    "          const float b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};\n"
    "          mma3(cbv[0], sa, split(b0));\n"
    "          mma3(cbv[1], sa, split(b1));\n"
    "        }\n"
    "        float sum = 0.f;\n"
    "        for (int q = 0; q < 2; ++q)\n"
    "          sum += cbv[q][0] + cbv[q][1] + cbv[q][2] + cbv[q][3];\n"
    "        if (sum == 1.2345e30f) red[warp] = sum;\n"
    "      }\n"
    "    }\n")
AFTER_C = ("    cp_async_wait<1>();  // chunk c's C and h0 are in\n"
           "    __syncthreads();     // every read of s1 is done\n")
VARIANTS = {
    "kernel": [],
    "loads not overlapped": [
        (f"    {n};\n    cp_async_commit();\n",
         f"    {n};\n    cp_async_commit();\n    cp_async_wait_all();\n")
        for n in LOADS],
    "C.B^T per head": [(AFTER_C, AFTER_C + CB_PER_HEAD)],
    "prep kernel alone": [("  ssd_scan_bwd_kernel<NMAX><<<",
                           "  if (Bt < 0) ssd_scan_bwd_kernel<NMAX><<<")],
    "one MMA of three": [("  mma_tf32(c, a.small, b.big);\n"
                          "  mma_tf32(c, a.big, b.small);\n", "")],
    "no dh update": [
        ("      for (int ks = 0; ks < kL / 8; ++ks) {\n        float a[4];\n"
         "        frag_at<kPMax, true>(a, dyc, p0, 8 * ks, lane);",
         "      for (int ks = 0; ks < (T < 0 ? kL / 8 : 0); ++ks) {\n"
         "        float a[4];\n"
         "        frag_at<kPMax, true>(a, dyc, p0, 8 * ks, lane);")],
    "no dB/dC state terms": [
        ("      for (int ks = 0; ks < kPMax / 8; ++ks) {\n"
         "        float a[4];\n"
         f"        ldmatrix_a<kPMax, true>(a, {t}, {r}, 8 * ks, lane);",
         "      for (int ks = 0; ks < (T < 0 ? kPMax / 8 : 0); ++ks) {\n"
         "        float a[4];\n"
         f"        ldmatrix_a<kPMax, true>(a, {t}, {r}, 8 * ks, lane);")
        for t, r in (("xs", "u0"), ("dyc", "r0"))],
}
SWITCH = "    switch (warp >> 2) {{\n      case 0: {}(Int<0>()); break;"
VARIANTS.update({
    "six barriers a chunk": [
        ("  load_b(nc - 1);\n  cp_async_commit();\n",
         "  load_b(nc - 1);\n  cp_async_commit();\n"
         "  load_ch(nc - 1);\n  cp_async_commit();\n"),
        ("    cp_async_wait<1>();  // chunk c's dy, s, dt, C B^T and x are in\n"
         "    __syncthreads();     // and chunk c + 1's steps 2-5 are done\n"
         "    load_ch(c);\n    cp_async_commit();\n",
         "    cp_async_wait<2>();\n    __syncthreads();\n"),
        ("    // 4. dC[t][n] = ",
         "    __syncthreads();\n    if (c > 0) load_x(c - 1);\n"
         "    cp_async_commit();\n    // 4. dC[t][n] = "),
        ("    __syncthreads();  // every read of x, B and the old dh is done\n"
         "    if (c > 0) load_x(c - 1);\n    cp_async_commit();\n",
         "    __syncthreads();\n"),
        ("      if (lane == 0) red[warp] = dth;\n    }\n  }\n",
         "      if (lane == 0) red[warp] = dth;\n    }\n    __syncthreads();\n"
         "    if (c > 0) load_ch(c - 1);\n    cp_async_commit();\n  }\n")],
    "loops fully unrolled": [("kUnroll = NMAX == 128 ? 1 : 2;",
                              "kUnroll = 64;")],
    "unrolled twice at NMAX 128": [("kUnroll = NMAX == 128 ? 1 : 2;",
                                    "kUnroll = 2;")],
    "not unrolled at NMAX 64": [("kUnroll = NMAX == 128 ? 1 : 2;",
                                 "kUnroll = 1;")],
    "no step 1": [("    if (warp < 10) {\n",
                   "    if (T < 0 && warp < 10) {\n")],
    **{f"no step {i}": [(SWITCH.format(part), "    if (T < 0)"
                         + SWITCH.format(part)[4:])]
       for i, part in ((2, "dx_part"), (3, "db_part"), (4, "dc_part"))},
    "no step 5": [("    {\n      const int p0 = 16 * (warp >> 2), n0 =",
                   "    if (T < 0) {\n"
                   "      const int p0 = 16 * (warp >> 2), n0 =")],
    "no step 6": [("    } else if (warp == 15 && c + 1 < nc) {",
                   "    } else if (T < 0 && warp == 15 && c + 1 < nc) {"),
                  ("  if (warp == 15) scalars(0);",
                   "  if (T < 0 && warp == 15) scalars(0);")],
})
EXACT = ("loads not overlapped", "C.B^T per head", "six barriers a chunk",
         "loops fully unrolled", "unrolled twice at NMAX 128",
         "not unrolled at NMAX 64")
patched = ssd_fwd.patched


def build_all() -> dict:
    """One nvcc per variant, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "ssd_scan.cu").read_text()
    texts = {n: patched(source, n, p) for n, p in VARIANTS.items()}
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        (OUT / f"v{i}.cu").write_text(text)
        procs[name] = (OUT / f"libv{i}.so",
                       ssd_fwd.BWD.nvcc(OUT / f"v{i}.cu", OUT / f"libv{i}.so"))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log.decode()}")
        fn = ""
        for ln in log.decode().splitlines():
            if "Compiling entry function" in ln:
                fn = ("NMAX 128" if "Li128E" in ln else "NMAX 64") \
                    if "ssd_scan_bwd_kernel" in ln else ""
            elif fn and ("registers" in ln or "spill stores" in ln):
                print(f"{name}, {fn}: {ln.split(':', 1)[-1].strip()}",
                      flush=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.ssd_scan_fwd_f32.argtypes = ([ctypes.c_void_p] * 10
                                         + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p])
        lib.ssd_scan_bwd_f32.argtypes = ([ctypes.c_void_p] * 16
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
    g = torch.Generator(device=dev).manual_seed(4)
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
        dy = torch.randn(Bt, T, H, P, generator=g, device=dev)
        nc = -(-T // 64)
        ref = libs["kernel"]
        scratch = torch.empty(ref.ssd_scan_fwd_scratch_floats(Bt, T, H),
                              device=dev)
        y, fin = torch.empty_like(x), torch.empty(Bt, H, P, N, device=dev)
        states = torch.empty(Bt, H, nc, P, N, device=dev)
        err = ref.ssd_scan_fwd_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), fin.data_ptr(),
            states.data_ptr(), scratch.data_ptr(), Bt, T, H, P, N, stream)
        if err:
            raise SystemExit(f"forward launch failed: cudaError {err}")
        outs = {n: (torch.empty_like(x), torch.empty_like(dt),
                    torch.empty(Bt, H, device=dev),
                    torch.empty(Bt, H, T, N, device=dev),
                    torch.empty(Bt, H, T, N, device=dev),
                    torch.empty(Bt, H, device=dev)) for n in libs}

        def bwd(n):
            o = outs[n]
            err = libs[n].ssd_scan_bwd_f32(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), states.data_ptr(), dy.data_ptr(),
                None, *(t.data_ptr() for t in o), scratch.data_ptr(), Bt, T,
                H, P, N, stream)
            if err:
                raise SystemExit(f"{n}: launch failed: cudaError {err}")

        def calls(n):  # back to back, so the card does not wait on the host
            for _ in range(REPEAT):
                bwd(n)

        names = list(libs)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(ssd_fwd.BWD.time_ms(lambda: calls(n)) / REPEAT)
        for n in names:
            diff = ""
            if n in EXACT:
                d = max(float((a - b).abs().max())
                        for a, b in zip(outs[n], outs["kernel"]))
                diff = f", max|grad - kernel's| {d:.3g}"
            print(f"({Bt}, {T}, {H}, {P}, N {N}) f32, {n}: "
                  f"{ms[n][0]:.4f} / {ms[n][1]:.4f} ms{diff}", flush=True)
        dB_part, dC_part = outs["kernel"][3], outs["kernel"][4]
        sums = ssd_fwd.BWD.time_ms(
            lambda: [(dB_part.sum(1), dC_part.sum(1))
                     for _ in range(REPEAT)]) / REPEAT
        print(f"({Bt}, {T}, {H}, {P}, N {N}) f32, the wrapper's head sums of "
              f"dB and dC (PyTorch): {sums:.4f} ms", flush=True)
        del x, dt, B, C, dy, outs, scratch, states
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
