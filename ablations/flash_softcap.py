#!/usr/bin/env python3
"""``flash_attention`` with and without its logit softcap on one card, and
against an older build of the same kernels.

    python3 ablations/flash_softcap.py [OLDER_CHECKOUT]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of this
checkout and, given the root of an older checkout (unpacked with ``git
archive`` into an ignored directory such as ``build/parent``), its
``flash_attention.cu``, one nvcc each, one after the other, and prints
each nvcc's wall time and the kernels' registers and spills. Then, at the
LM path's shape (B 8, T 512, H = KV = 32, d 112, causal) and at the tp
path's minitron-4b (B 2, T 512, H 24, KV 8, d 128, causal), f32, it times
the raw launches (the C interface, with the buffers a wrapper call makes
made once) of the forward and of the backward (D, then the fused dK/dV/dQ
kernel) by CUDA events (`chip_smoke.time_ms`, 20 calls a turn): the older
kernels, this
checkout's with no cap, and this checkout's at c = 50 (q scaled by
chip_smoke's SOFTCAP_Q_SCALE, as the checks have it), in two turns, the
second in the reverse order, and the median of the two; with no cap it
says whether the new kernels' o, lse and dK equal the older ones' bit for
bit. The card's name and power limit come first.
"""
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

OUT = ROOT / "build" / "flash_softcap"
SHAPES = {"lm path": (8, 512, 32, 32, 112), "minitron-4b": (2, 512, 24, 8, 128)}
CAP = 50.0
ITERS = 20


def nvcc(src: Path, lib: Path) -> float:
    """Build ``src`` into ``lib``; the wall seconds, registers printed."""
    t = time.perf_counter()
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    secs = time.perf_counter() - t
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}"
                         f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill"
                                   not in line):
            print(f"  {line.strip()}", flush=True)
    return secs


def older_library(lib_path: Path):
    """The older build's C interface, which takes no cap."""
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attention_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p])
    lib.flash_attention_bwd.argtypes = ([ctypes.c_int]
                                        + [ctypes.c_void_p] * 10
                                        + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p])
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    built = build.build_cuda(["flash_attention"])
    secs = time.perf_counter() - t
    log = (build.BUILD_DIR / "flash_attention.log")
    for line in (log.read_text() if log.exists() else "").splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill"
                                   not in line):
            print(f"  {line.strip()}", flush=True)
    print(f"nvcc flash_attention.cu (this checkout): "
          f"{f'{secs:.1f} s' if built else 'built before'}", flush=True)
    old = None
    if len(sys.argv) > 1:
        src = (Path(sys.argv[1]) / "src" / "repro_torch" / "kernels" / "csrc"
               / "flash_attention.cu")
        print("nvcc, the older checkout:", flush=True)
        secs = nvcc(src, OUT / "libflash_attention_old.so")
        print(f"nvcc flash_attention.cu ({sys.argv[1]}): {secs:.1f} s",
              flush=True)
        old = older_library(OUT / "libflash_attention_old.so")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(5)
    libs = {"new": (FA._lib(), (0.0,)), "new capped": (FA._lib(), (CAP,))}
    if old is not None:
        libs = {"older": (old, ()), **libs}
    for label, (B, T, H, KV, d) in SHAPES.items():
        q, do = (torch.randn(B, T, H, d, generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(B, T, KV, d, generator=g, device=dev)
                for _ in range(2))
        qc = q * CS.SOFTCAP_Q_SCALE
        outs = {}
        runs = {}
        for name, (lib, cap) in libs.items():
            # the same buffers a wrapper call makes, made once: the raw
            # launches alone are timed
            qq = qc if cap and cap[0] else q
            o, lse = torch.empty_like(q), torch.empty((B, H, T), device=dev)
            dq = torch.zeros_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            scratch = torch.empty_like(lse)
            outs[name] = (o, lse, dk)

            def fwd(lib=lib, cap=cap, qq=qq, o=o, lse=lse):
                err = lib.flash_attention_fwd(
                    0, qq.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), B, T, T, H, KV, d, 1, 0,
                    *cap, stream)
                assert not err, err

            def bwd(lib=lib, cap=cap, qq=qq, o=o, lse=lse, dq=dq, dk=dk,
                    dv=dv, scratch=scratch):
                err = lib.flash_attention_bwd(
                    0, qq.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                    scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, T, T, H, KV, d, 1, 0, *cap, stream)
                assert not err, err

            fwd()
            bwd()
            runs[f"{name} fwd"], runs[f"{name} bwd"] = fwd, bwd
        torch.cuda.synchronize()
        if old is not None:
            same = [torch.equal(a, b) for a, b in zip(outs["older"],
                                                       outs["new"])]
            print(f"{label}: no cap, new == older bit for bit: o {same[0]}, "
                  f"lse {same[1]}, dk {same[2]}", flush=True)
        names = list(runs)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(CS.time_ms(runs[n], iters=ITERS))
        for n in names:
            print(f"{label} (B, T, H, KV, d) = {(B, T, H, KV, d)} causal f32,"
                  f" {n}: {statistics.median(ms[n]):.4f} ms "
                  f"(turns {', '.join(f'{x:.4f}' for x in ms[n])})",
                  flush=True)
        del q, k, v, do, qc, outs, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
