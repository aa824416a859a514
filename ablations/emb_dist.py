#!/usr/bin/env python3
"""``emb_dist`` on one card: the Triton kernels it replaced against the
CUDA kernels of ``src/repro_torch/kernels/csrc/emb_dist.cu``, and where
the CUDA kernels' time goes.

    python3 ablations/emb_dist.py              # everything below
    python3 ablations/emb_dist.py --only triton   # the Triton side alone

The baseline is the Triton source the package ran before the CUDA kernels,
kept verbatim in ``ablations/emb_dist_triton_baseline.py`` (outside the
package), launched through a copy of its wrapper (the same host work a
call: the contract check, two ``.contiguous()``, the output, the module
lookup under a lock, a ``torch.cuda.device`` context, Triton's launcher).
At the ResNet path's 32 x 512 rows and the pod path's 2,044 x 1,024 and
4,088 x 1,024 (f32), forward and backward, each side is timed in turns
(Triton, CUDA, CUDA, Triton) two ways:

  * device ms a launch: a CUDA graph of launches over inputs rotated
    through copies that hold at least 64 MiB, more than the 50 MB L2
    (`chip_smoke.graph_ms`), so each launch reads from device memory;
  * host ms a call: wrapper calls back to back with no synchronise
    (`chip_smoke.host_ms`), the rate the host enqueues them at.

Beside them: the library call (`chip_smoke._emb_library`) and the plain
versions by graph; each kernel's mean device time under
``torch.profiler`` over cold eager launches, a cross check of the
graph's; the host work of a CUDA wrapper call piece by piece (the bare
ctypes call with its arguments made beforehand, the output's
``torch.empty``, the stream lookup, the geometry, the contract check).

Then copies of the CUDA source with one choice changed by a text patch
(built here, one nvcc each, all started together, each variant's
registers and spills printed), held against the plain version and timed
by graph in turns (kernel ... last, last ... kernel) at the three shapes
and at the smoke's 256 x 8,192:

  * "divide each element": an IEEE division an element, as the reference
    writes it, in place of the row's reciprocal;
  * "2 warps a row", "4 warps a row": a warp holds 512 or 256 elements of
    a row in place of 1,024 (so 2 or 4 warps a row at E = 1,024, and 16
    or 32 at E = 8,192);
  * "8 rows a block": 8 warps a block where a warp holds a row, not 4;
  * at 256 x 8,192 only, one warp a row that loops over it and reads it
    again from the caches (``ablations/emb_dist_loop.cu``).

Prints the card's name and power limit first and exits non-zero without a
card; the record goes to ``chiprun_out/emb_dist_ablation.json``.
tests/test_torch_kernels.py checks on the CPU that the patches apply.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "ablations"))

import ssd_fwd  # noqa: E402  (puts tools/ and src/ helpers in reach)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import emb_dist as EMB  # noqa: E402

SHAPES = [("resnet", 32, 512), ("pod", 2044, 1024),
          ("pod mhd_train_step", 4088, 1024), ("smoke large", 256, 8192)]
OUT = ROOT / "build" / "emb_dist_ablation"
patched = ssd_fwd.patched

DIVIDE = [("__fmul_rn(x.s[c][v], is) - __fmul_rn(x.t[c][v], it);",
           "x.s[c][v] / ns - x.t[c][v] / nt;"),
          ("2.f * (__fmul_rn(x.s[c][v], ie) - __fmul_rn(x.t[c][v], ite));",
           "2.f * (x.s[c][v] / ne - x.t[c][v] / nte);"),
          ("        o[v] = gr * (x.t[c][v] * ie - x.s[c][v] * coef);",
           "        o[v] = gr * (x.t[c][v] / ne - x.s[c][v] * coef);")]


def span(n: int, warps: int) -> list:
    return [("constexpr int kWarpSpan = 1024;",
             f"constexpr int kWarpSpan = {n};"),
            ("constexpr int kMaxWarps = 8;",
             f"constexpr int kMaxWarps = {warps};")]


# name -> (patches, elements a warp holds, warps a block when a row
# takes fewer)
VARIANTS = {
    "kernel": ([], 1024, 4),
    "divide each element": (DIVIDE, 1024, 4),
    "2 warps a row": (span(512, 16), 512, 4),
    "4 warps a row": (span(256, 32), 256, 4),
    "8 rows a block": ([], 1024, 8),
}

# --- the Triton baseline and a copy of its wrapper --------------------------
_lock = threading.Lock()
_MOD = "emb_dist_triton_baseline"


def _triton_module():
    os.environ.setdefault("TRITON_CACHE_DIR", str(build.TRITON_CACHE))
    with _lock:
        mod = sys.modules.get(_MOD)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                _MOD, ROOT / "ablations" / f"{_MOD}.py")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[_MOD] = mod
            spec.loader.exec_module(mod)
        return mod


def _block(E: int):
    block = max(16, 1 << (E - 1).bit_length())
    return block, (4 if block <= 1024 else 8)


def triton_fwd(s, t):
    EMB._check(s, t)
    s, t = s.contiguous(), t.contiguous()
    B, E = s.shape
    out = torch.empty((B,), dtype=torch.float32, device=s.device)
    if B:
        mod = _triton_module()
        block, warps = _block(E)
        with torch.cuda.device(s.device):
            mod.emb_dist_fwd_kernel[(B,)](
                s, t, out, E, s.stride(0), t.stride(0), EMB.EPS,
                BLOCK_E=block, num_warps=warps)
    return out


def triton_bwd(s, t, g):
    EMB._check(s, t)
    s, t = s.contiguous(), t.contiguous()
    g = g.float().contiguous()
    B, E = s.shape
    gs = torch.empty_like(s)
    if B:
        mod = _triton_module()
        block, warps = _block(E)
        with torch.cuda.device(s.device):
            mod.emb_dist_bwd_kernel[(B,)](
                s, t, g, gs, E, s.stride(0), t.stride(0), gs.stride(0),
                EMB.EPS, BLOCK_E=block, num_warps=warps)
    return gs


# --- the CUDA variants -------------------------------------------------------

def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _bind(lib, fwd: str, bwd: str, fwd_types: list, bwd_types: list):
    f, b = getattr(lib, fwd), getattr(lib, bwd)
    f.argtypes, b.argtypes = fwd_types, bwd_types
    f.restype = b.restype = ctypes.c_int
    return f, b


def _nvcc_all(sources: dict) -> dict:
    """One nvcc per {name: .cu path}, all started together; each name's
    loaded library, the range of its kernels' registers and their spill
    stores printed."""
    procs = {n: (OUT / f"lib{i}.so", ssd_fwd.BWD.nvcc(src, OUT / f"lib{i}.so"))
             for i, (n, src) in enumerate(sources.items())}
    libs = {}
    for n, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {n}:\n{log.decode()}")
        text = log.decode()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                text))
        print(f"  ptxas {n}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes of spill stores", flush=True)
        libs[n] = ctypes.CDLL(str(path))
    return libs


def build_variants() -> tuple:
    """The patched copies of emb_dist.cu and emb_dist_loop.cu: (variant ->
    (fwd, bwd) callables, the loop's (fwd, bwd))."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "emb_dist.cu").read_text()
    texts = {}
    for name, (patches, _, _) in VARIANTS.items():
        text = patched(source, name, patches)
        texts.setdefault(text, name)
    srcs = {}
    for i, (text, name) in enumerate(texts.items()):
        (OUT / f"v{i}.cu").write_text(text)
        srcs[name] = OUT / f"v{i}.cu"
    srcs["loop"] = ROOT / "ablations" / "emb_dist_loop.cu"
    libs = _nvcc_all(srcs)
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    fns = {}
    for name, (patches, warp_span, block_warps) in VARIANTS.items():
        lib = libs[texts[patched(source, name, patches)]]
        fns[name] = _variant(_bind(
            lib, "emb_dist_fwd", "emb_dist_bwd",
            [p, p, p, ll, i, ll, ll, i, i, i, i, i, f, p],
            [p, p, p, p, ll, i, ll, ll, ll, i, i, i, i, i, f, p]),
            warp_span, block_warps)
    lf, lb = _bind(libs["loop"], "loop_fwd_f32", "loop_bwd_f32",
                   [p, p, p, ll, i, f, p], [p, p, p, p, ll, i, f, p])

    def loop_fwd(s, t):
        out = torch.empty(s.shape[0], device=s.device)
        err = lf(s.data_ptr(), t.data_ptr(), out.data_ptr(), s.shape[0],
                 s.shape[1], EMB.EPS, _stream())
        assert not err, err
        return out

    def loop_bwd(s, t, g):
        gs = torch.empty_like(s)
        err = lb(s.data_ptr(), t.data_ptr(), g.data_ptr(), gs.data_ptr(),
                 s.shape[0], s.shape[1], EMB.EPS, _stream())
        assert not err, err
        return gs

    return fns, (loop_fwd, loop_bwd)


def _variant(entries, warp_span: int, block_warps: int):
    """(fwd, bwd) of f32 rows through a variant's entries, at its geometry:
    the kernel's vector choice, ceil(E / warp_span) warps a row rounded up
    to a power of two, max(block_warps, that) warps a block."""
    fwd, bwd = entries

    def geo(s, t):
        E = s.shape[1]
        wpr = 1 << (-(-E // warp_span) - 1).bit_length()
        return (EMB._geometry(s, t).vec, wpr, 32 * max(block_warps, wpr))

    def f(s, t):
        out = torch.empty(s.shape[0], device=s.device)
        err = fwd(s.data_ptr(), t.data_ptr(), out.data_ptr(), s.shape[0],
                  s.shape[1], s.stride(0), t.stride(0), 0, 0, *geo(s, t),
                  EMB.EPS, _stream())
        assert not err, err
        return out

    def b(s, t, g):
        gs = torch.empty_like(s)
        err = bwd(s.data_ptr(), t.data_ptr(), g.data_ptr(), gs.data_ptr(),
                  s.shape[0], s.shape[1], s.stride(0), t.stride(0),
                  s.shape[1], 0, 0, *geo(s, t), EMB.EPS, _stream())
        assert not err, err
        return gs

    return f, b


# --- measurement -------------------------------------------------------------

def inputs(dev, B: int, E: int, seed: int) -> list:
    g = torch.Generator(device=dev).manual_seed(seed)
    return c.cold_copies(lambda: (torch.randn(B, E, generator=g, device=dev),
                                  torch.randn(B, E, generator=g, device=dev),
                                  torch.randn(B, generator=g, device=dev)),
                         2 * B * E * 4)


def hold(name: str, fwd, bwd, copies: list) -> None:
    """The variant against the plain version on one copy."""
    s, t, g = copies[0]
    o, o_ref = fwd(s, t), EMB.emb_dist_plain(s, t)
    gs, gs_ref = bwd(s, t, g), EMB.emb_dist_bwd_plain(s, t, g)
    torch.cuda.synchronize()
    if not (c.close(o, o_ref, c.TOL_F32, c.TOL_F32)
            and c.close(gs, gs_ref, c.TOL_F32, c.TOL_GRAD_ABS)):
        raise SystemExit(f"{name}: disagrees with the plain version "
                         f"(fwd {c.maxerr(o, o_ref):.3g}, bwd "
                         f"{c.maxerr(gs, gs_ref):.3g})")


def profiled_ms(fn, copies: list, key: str, launches: int = 20):
    """Mean device ms of the kernels whose name holds ``key`` over eager
    cold launches, by torch.profiler; None where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(launches):
            fn(*copies[i % len(copies)])
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and key in e.key]
    n = sum(e.count for e in evs)
    return sum(e.self_device_time_total for e in evs) / n / 1e3 if n \
        else None


def device_ms(fwd, bwd, copies: list) -> dict:
    return {"fwd": c.graph_ms(fwd, [x[:2] for x in copies]),
            "bwd": c.graph_ms(bwd, copies)}


def both(fwd, bwd, copies: list) -> dict:
    dev = device_ms(fwd, bwd, copies)
    return {"fwd": {"device_ms": dev["fwd"],
                    "host_ms": c.host_ms(fwd, [x[:2] for x in copies])},
            "bwd": {"device_ms": dev["bwd"],
                    "host_ms": c.host_ms(bwd, copies)}}


def in_turns(sides: dict, copies: list, measure=both) -> dict:
    """``measure`` of each side, timed in the order given and then in
    reverse; the two turns' values and their mean."""
    names = list(sides)
    turns = {n: [] for n in names}
    for n in names + names[::-1]:
        turns[n].append(measure(*sides[n], copies))
    out = {}
    for n, runs in turns.items():
        out[n] = {}
        for d in ("fwd", "bwd"):
            if isinstance(runs[0][d], dict):
                out[n][d] = {m: {"turns": [r[d][m] for r in runs],
                                 "mean": statistics.mean(r[d][m]
                                                         for r in runs)}
                             for m in runs[0][d]}
            else:
                out[n][d] = {"turns": [r[d] for r in runs],
                             "mean": statistics.mean(r[d] for r in runs)}
    return out


def per_call_us(fn, calls: int = 2000) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def host_pieces(copies: list) -> dict:
    """µs a call of each piece of a CUDA forward wrapper call, alone."""
    s, t, _ = copies[0]
    B, E = s.shape
    dev = s.device
    out = torch.empty(B, device=dev)
    geo = EMB._geometry(s, t)
    fwd = EMB._fns()[0]
    args = (s.data_ptr(), t.data_ptr(), out.data_ptr(), B, E, s.stride(0),
            t.stride(0), 0, 0, geo.vec, geo.warps_per_row, geo.threads,
            EMB.EPS, _stream())
    pieces = {
        "wrapper call": lambda: EMB.emb_dist_fwd_kernel(s, t),
        "bare ctypes call": lambda: fwd(*args),
        "torch.empty": lambda: torch.empty((B,), dtype=torch.float32,
                                           device=dev),
        "current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "the raw stream (the wrapper's)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "current_device()": torch.cuda.current_device,
        "_geometry": lambda: EMB._geometry(s, t),
        "_check": lambda: EMB._check(s, t),
        "data_ptr() x3": lambda: (s.data_ptr(), t.data_ptr(),
                                  out.data_ptr()),
    }
    res = {n: per_call_us(f) for n, f in pieces.items()}
    torch.cuda.synchronize()
    return res


def report(label: str, B: int, E: int, row: dict) -> None:
    for n, r in row["sides"].items():
        for d in ("fwd", "bwd"):
            dm, hm = r[d]["device_ms"], r[d]["host_ms"]
            bnd = row["bound_ms"][d]
            print(f"{label} {B}x{E} {d} {n}: device {dm['mean']:.4f} ms "
                  f"(turns {dm['turns'][0]:.4f} / {dm['turns'][1]:.4f}; "
                  f"bound {bnd:.5f}, {100 * bnd / dm['mean']:.1f} %), host "
                  f"{hm['mean']:.4f} ms a call (turns {hm['turns'][0]:.4f}"
                  f" / {hm['turns'][1]:.4f}); profiler "
                  f"{row['profiled_ms'][n][d]}", flush=True)
    print(f"{label}: library {row['library_ms']:.4f} ms, plain fwd / bwd "
          f"{row['plain_ms']['fwd']:.4f} / {row['plain_ms']['bwd']:.4f} ms "
          f"(by graph)", flush=True)
    if "host_pieces_us" in row:
        print(f"{label}: host µs a call: " + ", ".join(
            f"{n} {v:.2f}" for n, v in row["host_pieces_us"].items()),
            flush=True)
    for n, r in row.get("variants", {}).items():
        print(f"{label} {B}x{E} variant {n}: device fwd "
              f"{r['fwd']['mean']:.4f} ms ({r['fwd']['turns'][0]:.4f} / "
              f"{r['fwd']['turns'][1]:.4f}), bwd {r['bwd']['mean']:.4f} ms"
              f" ({r['bwd']['turns'][0]:.4f} / {r['bwd']['turns'][1]:.4f})",
              flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", choices=["triton"], default=None)
    opts = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = c.phase_device()["nvidia_smi"]
    dev = torch.device("cuda", 0)
    record = {"device": smi, "shapes": {}}
    sides = {"triton": (triton_fwd, triton_bwd)}
    variants, loop = {}, None
    if opts.only is None:
        build.build_cuda(["emb_dist"])
        sides["cuda"] = (EMB.emb_dist_fwd_kernel, EMB.emb_dist_bwd_kernel)
        variants, loop = build_variants()
    for label, B, E in SHAPES:
        copies = inputs(dev, B, E, 7)
        for n, (f, b) in sides.items():
            hold(n, f, b, copies)
        pairs = [x[:2] for x in copies]
        row = {"rows": [B, E], "copies": len(copies),
               "sides": in_turns(sides, copies),
               "bound_ms": {"fwd": c.kernel_bound(EMB.cost_fwd(B, E))[0],
                            "bwd": c.kernel_bound(EMB.cost_bwd(B, E))[0]},
               "library_ms": c.graph_ms(c._emb_library, pairs),
               "plain_ms": {"fwd": c.graph_ms(EMB.emb_dist_plain, pairs),
                            "bwd": c.graph_ms(EMB.emb_dist_bwd_plain,
                                              copies)},
               "profiled_ms": {
                   n: {"fwd": profiled_ms(f, pairs, "emb_dist_fwd"),
                       "bwd": profiled_ms(b, copies, "emb_dist_bwd")}
                   for n, (f, b) in sides.items()}}
        if variants:
            row["host_pieces_us"] = host_pieces(copies)
            todo = {n: v for n, v in variants.items()
                    if n != "8 rows a block" or E <= EMB.WARP_SPAN}
            if E > EMB.WARP_SPAN:
                todo["one warp a row, looping"] = loop
            for n, (f, b) in todo.items():
                hold(n, f, b, copies)
            row["variants"] = in_turns(todo, copies, device_ms)
        record["shapes"][label] = row
        report(label, B, E, row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "emb_dist_ablation.json").write_text(json.dumps(record, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
