#!/usr/bin/env python3
"""Where the time of ``flash_attention``'s forward kernel goes, on one card.

    python3 tools/flash_fwd_ablation.py

Builds copies of ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
one part of the forward
taken out or swapped, each by a text patch of the committed source, and
times them beside the kernel itself at the hybrid path's shape (8, 512, 32,
112) and at T = 4096, causal, f32:

  * "loads not overlapped": each thread waits for its copies of the next
    key tile as soon as it has issued them (no double buffering);
  * "P through shared memory": each 16 x 8 slice of P is written to a
    per-warp scratch and read back as an A fragment, in place of being
    taken from the registers of s;
  * "q not split" (wrong sums): q's fragments enter the MMAs unsplit, so
    their split instructions are gone: at most what splitting q once a
    block, not once a key tile, could save;
  * "first tile first": the query tiles launched in order, not the last
    (under a causal mask the longest) first;
  * "warp skipping": a warp skips the key tiles that no row of it
    reaches (unless a row of it has no key in its band);
  * "n-tiles beyond d skipped": P.V leaves out the head-dim n-tiles at or
    beyond d (2 of 16 at d = 112), each product under a runtime condition;
  * "16-key tiles", and with it "2 blocks an SM" (at most 128 registers a
    thread at d <= 128, where the block's shared memory allows two);
  * "every tile masked": the band mask is evaluated on every score, also
    in the tiles that lie inside every row's band;
  * "one MMA of three" (wrong sums): each product is big.big alone
    (1xTF32): what the two error-compensating MMAs cost.

Each variant is timed twice, in the order kernel ... last, last ...
kernel (median of 20 CUDA-event times each); the variants that compute the
same function give their largest difference from the kernel's o. Prints
the card's name and power limit first; exits non-zero without a card, or
if a patch no longer applies to the source. scripts/flash_bwd_ablation.py
does the same for the backward, and times the ceiling of the route, a loop
of ``mma.sync`` TF32 products; this script takes its nvcc and timing
helpers from there. tests/test_torch_kernels.py checks on the CPU that
both scripts' patches apply to the source.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import flash_bwd_ablation as BWD  # noqa: E402  (puts src on the path)
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

SHAPES = BWD.SHAPES
OUT = ROOT / "build" / "fwd_ablation"
NO_OVERLAP = [("    cp_async_commit();\n    const float* ks = kvs",
               "    cp_async_commit();\n    cp_async_wait_all();\n"
               "    const float* ks = kvs")]
VARIANTS = {
    "kernel": [],
    "loads not overlapped": NO_OVERLAP,
    "P through shared memory": [
        ("      const float pv[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};\n"
         "      const Split<4> ap = split(pv);\n",
         "      float* ps = kvs + 4 * BS * LD + warp * 16 * 12;\n"
         "      __syncwarp();\n"
         "      *reinterpret_cast<float2*>(ps + gr * 12 + gc) =\n"
         "          make_float2(sc[j][0], sc[j][1]);\n"
         "      *reinterpret_cast<float2*>(ps + (gr + 8) * 12 + gc) =\n"
         "          make_float2(sc[j][2], sc[j][3]);\n"
         "      __syncwarp();\n"
         "      const Split<4> ap = frag_a<12>(ps, 0, 0, lane);\n"),
        ("frag_b_pairs<LD>(vs, 8 * n, 8 * j, lane)",
         "frag_b<LD>(vs, 8 * n, 8 * j, lane)"),
        ("      sizeof(float) * (size_t)(kFwdBT + 4 * kFwdBS) * (DMAX + 4);",
         "      sizeof(float) * ((size_t)(kFwdBT + 4 * kFwdBS) * (DMAX + 4) +"
         " kFwdBT * 12);")],
    "q not split": [
        ("      const Split<4> aq = frag_a<LD>(qs, m0, i0, lane);\n",
         "      Split<4> aq;\n"
         "      const float* pq = qs + (m0 + gr) * LD + i0 + (lane & 3);\n"
         "      const float xq[4] = {pq[0], pq[8 * LD], pq[4],"
         " pq[8 * LD + 4]};\n"
         "      for (int e = 0; e < 4; ++e) {\n"
         "        aq.big[e] = __float_as_uint(xq[e]);\n"
         "        aq.small[e] = 0u;\n"
         "      }\n")],
    "first tile first": [
        ("  const int t0 = (gridDim.x - 1 - blockIdx.x) * BT, h = blockIdx.y,",
         "  const int t0 = blockIdx.x * BT, h = blockIdx.y,")],
    "warp skipping": [
        ("    const float* vs = ks + BS * LD;\n",
         "    const float* vs = ks + BS * LD;\n"
         "    if (tw >= Tq || (last < first_keyless_row(S, window) &&\n"
         "                     ((causal && s0 > last) ||\n"
         "                      (window > 0 && s0 + BS - 1 <= tw - window))))\n"
         "      continue;\n")],
    "n-tiles beyond d skipped": [
        ("        mma3(acc[n], ap, frag_b_pairs<LD>(vs, 8 * n, 8 * j, lane));",
         "        if (n < (d + 7) / 8)\n          mma3(acc[n], ap,"
         " frag_b_pairs<LD>(vs, 8 * n, 8 * j, lane));")],
    "16-key tiles": [
        ("  static constexpr int kFwdBS = DMAX > 128 ? 16 : 64;",
         "  static constexpr int kFwdBS = 16;")],
    "16-key tiles, 2 blocks an SM": [
        ("  static constexpr int kFwdBS = DMAX > 128 ? 16 : 64;",
         "  static constexpr int kFwdBS = 16;"),
        ("__launch_bounds__(32 * kFwdWarps, 1)\nflash_attention_fwd_kernel",
         "__launch_bounds__(32 * kFwdWarps, DMAX > 128 ? 1 : 2)\n"
         "flash_attention_fwd_kernel")],
    "every tile masked": [("    if (inner) {", "    if (false) {")],
    "one MMA of three": [("  mma_tf32(c, a.small, b.big);\n"
                          "  mma_tf32(c, a.big, b.small);\n", "")],
}
EXACT = ("loads not overlapped", "P through shared memory",
         "first tile first", "warp skipping", "n-tiles beyond d skipped",
         "16-key tiles", "16-key tiles, 2 blocks an SM", "every tile masked")


def patched(source: str, name: str, patches: list) -> str:
    """source with each (old, new) of a variant applied in turn; each old
    text must occur exactly once where it is applied."""
    for old, new in patches:
        if source.count(old) != 1:
            raise SystemExit(f"{name}: patch no longer applies: {old!r}")
        source = source.replace(old, new)
    return source


def build_all() -> dict:
    """One nvcc per variant, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "flash_attention.cu").read_text()
    texts = {n: patched(source, n, p) for n, p in VARIANTS.items()}
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
        lib.flash_attention_fwd.argtypes = ([ctypes.c_int]
                                            + [ctypes.c_void_p] * 5
                                            + [ctypes.c_int] * 8
                                            + [ctypes.c_float,
                                               ctypes.c_void_p])
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
    for B, T, H, d in SHAPES:
        q, k, v = (torch.randn(B, T, H, d, generator=g, device=dev)
                   for _ in range(3))
        outs = {n: (torch.empty_like(q), torch.empty((B, H, T), device=dev))
                for n in libs}

        def fwd(n):
            o, lse = outs[n]
            err = libs[n].flash_attention_fwd(
                0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, T, T, H, H, d, 1, 0, 0.0, stream)
            if err:
                raise SystemExit(f"{n}: launch failed: cudaError {err}")

        names = list(libs)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(BWD.time_ms(lambda: fwd(n)))
        for n in names:
            diff = (f", max|o - kernel's o| "
                    f"{float((outs[n][0] - outs['kernel'][0]).abs().max()):.3g}"
                    if n in EXACT else "")
            print(f"({B}, {T}, {H}, {d}) causal f32, {n}: "
                  f"{ms[n][0]:.3f} / {ms[n][1]:.3f} ms{diff}", flush=True)
        del q, k, v, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
