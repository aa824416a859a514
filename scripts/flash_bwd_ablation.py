#!/usr/bin/env python3
"""Where the time of ``flash_attention``'s backward kernel goes, on one card.

    python3 scripts/flash_bwd_ablation.py

Builds copies of ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
one part of the fused backward taken out or swapped, each by a text patch
of the committed source, and times them beside the kernel itself at the
hybrid path's shape (8, 512, 32, 112) and at T = 4096, causal, f32:

  * "no dQ atomics": dQ is computed but never added into dq_acc;
  * "one MMA of three": each product is big.big alone (1xTF32, wrong
    sums: what the two error-compensating MMAs cost);
  * "q, dO staged once": the query tiles are loaded only on the block's
    first pass (wrong sums: what staging them costs);
  * "8 warps a block": half the warps, each with up to twice the
    registers (what the kernel's occupancy buys);
  * "split by cvt.rna": both parts of the 3xTF32 split by
    cvt.rna.tf32.f32 in place of the integer rounding.

It also times a loop of independent ``mma.sync`` m16n8k8 TF32 products,
the ceiling of this kernel's tensor-core route on the card. Each variant
is timed twice, in the order kernel ... last, last ... kernel (median of
20 CUDA-event times each), with the kernel's forward output as input.
Prints the card's name and power limit first; exits non-zero without a
card, or if a patch no longer applies to the source.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

SHAPES = [(8, 512, 32, 112), (1, 4096, 32, 112)]
OUT = ROOT / "build" / "ablation"
LOAD_QDO = (
    "      load_tile<T, kBT, DMAX, LD, NTH>(q, qs, b, t0, Tq, H, h, d);\n"
    "      load_tile<T, kBT, DMAX, LD, NTH>(dout, dos, b, t0, Tq, H, h, d);")
VARIANTS = {
    "kernel": [],
    "no dQ atomics": [("          if (c < d)\n            red_add4(",
                       "          if (c < d && w[0] == 1234.5f)\n"
                       "            red_add4(")],
    "one MMA of three": [("  mma_tf32(c, a.small, b.big);\n"
                          "  mma_tf32(c, a.big, b.small);\n", "")],
    "q, dO staged once": [
        (LOAD_QDO, "      if (g == 0 && t0 == (qlo / kBT) * kBT) {\n"
                   + LOAD_QDO + "\n      }")],
    "8 warps a block": [("constexpr int kBwdWarps = 16;",
                         "constexpr int kBwdWarps = 8;")],
    "split by cvt.rna": [
        ("    f.big[j] = (__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u;\n"
         "    f.small[j] = __float_as_uint(x[j] - __uint_as_float(f.big[j]));",
         '    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(f.big[j]) : "f"(x[j]));\n'
         "    const float rest = x[j] - __uint_as_float(f.big[j]);\n"
         '    asm("cvt.rna.tf32.f32 %0, %1;"'
         ' : "=r"(f.small[j]) : "f"(rest));')],
}
MMA_LOOP = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_loop(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; i++) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  b[0] = a[1]; b[1] = a[2];
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  float s = 0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop_launch(float* out, int blocks, int threads, int iters) {
  mma_loop<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def nvcc(src: Path, lib: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def build_all() -> dict:
    """One nvcc per variant and one for the loop, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "flash_attention.cu").read_text()
    texts = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: patch no longer applies: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        (OUT / f"v{i}.cu").write_text(text)
        procs[name] = nvcc(OUT / f"v{i}.cu", OUT / f"libv{i}.so")
    (OUT / "mma_loop.cu").write_text(MMA_LOOP)
    procs["mma loop"] = nvcc(OUT / "mma_loop.cu", OUT / "libmma_loop.so")
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log.decode()}")
        lib = ctypes.CDLL(str(OUT / (f"libv{i}.so" if name != "mma loop"
                                     else "libmma_loop.so")))
        if name == "mma loop":
            lib.mma_loop_launch.argtypes = ([ctypes.c_void_p]
                                            + [ctypes.c_int] * 3)
        else:
            lib.flash_attention_bwd.argtypes = ([ctypes.c_int]
                                                + [ctypes.c_void_p] * 10
                                                + [ctypes.c_int] * 8
                                                + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_all()
    dev = torch.device("cuda", 0)
    out = torch.empty(132 * 512, device=dev)
    loop = libs.pop("mma loop")
    for blocks, threads in [(132, 256), (264, 256)]:
        iters = 4000
        run = lambda: loop.mma_loop_launch(out.data_ptr(), blocks, threads,
                                           iters)
        ms = time_ms(run, iters=5, warmup=1)
        flop = blocks * threads // 32 * iters * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 tf32, {blocks} blocks of {threads} "
              f"threads: {flop / ms / 1e9:.1f} TFLOP/s", flush=True)
    g = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B, T, H, d in SHAPES:
        q, k, v, do = (torch.randn(B, T, H, d, generator=g, device=dev)
                       for _ in range(4))
        o, lse = FA.flash_attention_fwd_kernel(q, k, v, causal=True)

        def bwd(lib):
            dq = torch.zeros_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            Dv = torch.empty((B, H, T), device=dev)
            err = lib.flash_attention_bwd(
                0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), Dv.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, T, T, H, H, d, 1, 0, stream)
            if err:
                raise SystemExit(f"launch failed: cudaError {err}")

        names = list(libs)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(time_ms(lambda: bwd(libs[n])))
        for n in names:
            print(f"({B}, {T}, {H}, {d}) causal f32, {n}: "
                  f"{ms[n][0]:.3f} / {ms[n][1]:.3f} ms", flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
