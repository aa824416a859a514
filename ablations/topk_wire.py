#!/usr/bin/env python3
"""Where the time of the ``topk_wire`` kernel goes, on one card.

    python3 ablations/topk_wire.py

Builds copies of ``src/repro_torch/kernels/csrc/topk_wire.cu`` with one
part taken out or swapped, each by a text patch of the committed source,
and times them beside the kernel itself at the LM path's publish shape
(12,288 x 50,280, k = 8) and the hybrid path's (12,288 x 32,000, k = 8):

  * "no lse" (lse wrong): the exps and their sum left out; the running
    max stays, so every value is still read and compared;
  * "no selection" (no top-k): no float4 is offered to the warp's list,
    not even voted on; the lse stays;
  * "loads only" (both wrong): both left out, so the loads, the running
    max and the final merge: the pace of the bytes alone;
  * "scalar loads": four 4-byte loads for each float4, in place of one
    16-byte load;
  * "unrolled twice", "unrolled 8 times": 2 or 8 float4 loads in flight a
    lane, in place of 4;
  * "8 rows a block": 8 warps a block, in place of 4.

So it says which of the bytes, the exps and the list sets the pace. Prints
each variant's registers and spills (nvcc -Xptxas -v). Each variant is
timed twice, in the order kernel ... last, last ... kernel (median of 20
CUDA-event times of 10 calls back to back, so that the card does not wait
on the host's launches), with the rate it reads the input at; the variants
that compute the same function say whether their values and indices are
the kernel's and give their largest lse difference from it (another
unroll groups the rescales of the sum otherwise). Prints the card's name
and power limit first; exits non-zero without a card, or if a patch no
longer applies to the source. The patching, nvcc and timing helpers are
ablations/ssd_fwd.py's. tests/test_torch_kernels.py checks on the CPU that
the patches apply to the source.
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

from repro_torch.kernels import build  # noqa: E402

SHAPES = [(12288, 50280, 8), (12288, 32000, 8)]
OUT = ROOT / "build" / "topk_wire_ablation"
REPEAT = 10  # calls a timing
NO_LSE = [("    part += (expf(q[u].x - mn) + expf(q[u].y - mn)) +\n"
           "            (expf(q[u].z - mn) + expf(q[u].w - mn));\n",
           "    part += 0.0f;\n"),
          ("  s = s * (double)expf(m - mn) + (double)part;\n", "")]
NO_SELECTION = [("    if (__any_sync(kFull, hot)) {\n"
                 "      const int c = c0 + 128 * u;\n",
                 "    if (false) {\n      const int c = c0 + 128 * u;\n")]
VARIANTS = {
    "kernel": [],
    "no lse": NO_LSE,
    "no selection": NO_SELECTION,
    "loads only": NO_LSE + NO_SELECTION,
    "scalar loads": [
        ("load4(const float4* p) { return __ldcs(p); }",
         "load4(const float4* p) {\n"
         "  const float* f = reinterpret_cast<const float*>(p);\n"
         "  return make_float4(__ldcs(f), __ldcs(f + 1), __ldcs(f + 2),\n"
         "                     __ldcs(f + 3));\n}")],
    "unrolled twice": [("constexpr int kUnroll = 4;",
                        "constexpr int kUnroll = 2;")],
    "unrolled 8 times": [("constexpr int kUnroll = 4;",
                          "constexpr int kUnroll = 8;")],
    "8 rows a block": [("constexpr int kWarps = 4;",
                        "constexpr int kWarps = 8;")],
}
EXACT = ("scalar loads", "unrolled twice", "unrolled 8 times",
         "8 rows a block")
patched = ssd_fwd.patched


def build_all() -> dict:
    """One nvcc per variant, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "topk_wire.cu").read_text()
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
                fn = "rank kernel" if "rank_kernel" in ln else "kernel"
            elif fn == "kernel" and ("registers" in ln or "spill stores" in ln):
                print(f"{name}: {ln.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.topk_wire_f32.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
        lib.topk_wire_f32.restype = ctypes.c_int
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
    g = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B, V, k in SHAPES:
        x = torch.randn(B, V, generator=g, device=dev) * 3  # chip_smoke's
        outs = {n: (torch.empty(B, k, device=dev),
                    torch.empty(B, k, dtype=torch.int32, device=dev),
                    torch.empty(B, device=dev)) for n in libs}

        def calls(n):  # back to back, so the card does not wait on the host
            v, i, lse = outs[n]
            for _ in range(REPEAT):
                err = libs[n].topk_wire_f32(x.data_ptr(), v.data_ptr(),
                                            i.data_ptr(), lse.data_ptr(), B,
                                            V, k, stream)
                if err:
                    raise SystemExit(f"{n}: launch failed: cudaError {err}")

        names = list(libs)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(ssd_fwd.BWD.time_ms(lambda: calls(n)) / REPEAT)
        ref = outs["kernel"]
        for n in names:
            diff = ""
            if n in EXACT:
                same = torch.equal(outs[n][0], ref[0]) and \
                    torch.equal(outs[n][1], ref[1])
                d = float((outs[n][2] - ref[2]).abs().max())
                diff = (f", values and indices {'the' if same else 'NOT the'}"
                        f" kernel's, max|lse - kernel's| {d:.3g}")
            rate = B * V * 4 / (min(ms[n]) * 1e-3) / 1e12
            print(f"({B}, {V}) k={k}, {n}: {ms[n][0]:.4f} / {ms[n][1]:.4f} "
                  f"ms, reads {rate:.2f} TB/s{diff}", flush=True)
        del x, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
