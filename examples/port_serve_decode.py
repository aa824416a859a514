"""Batched serving on the PyTorch/CUDA port: prefill + greedy decode with
per-family caches (sliding-window ring buffers for gemma3, SSM state for
mamba2), all rows of the batch in one ``decode_step`` a token.

    python examples/port_serve_decode.py [arch] [--device cpu]

The twin of `examples/serve_decode.py`, run through `repro_torch` instead
of `repro`; like every entry point of the port it runs on the card and
exits with an error when there is none, unless ``--device cpu`` is given.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.zoo import build_bundle  # noqa: E402


@torch.no_grad()
def main(arch: str = "gemma3-12b", device=None):
    device = resolve_device(device)
    cfg = get_reduced(arch)
    bundle = build_bundle(cfg)
    params = {k: v.to(device) for k, v in
              bundle.init(torch.Generator().manual_seed(0)).items()}

    B, prompt_len, gen = 4, 24, 16
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, prompt_len), dtype=np.int32)).to(device)
    caches = bundle.init_cache(B, prompt_len + gen, torch.float32,
                               device=device)

    t0 = time.time()
    logits = None
    for t in range(prompt_len):  # cache warmup (prefill)
        logits, caches = bundle.decode_step(params, prompts[:, t:t + 1],
                                            caches)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    generated = []
    for _ in range(gen):
        generated.append(tok[:, 0].cpu().numpy())
        logits, caches = bundle.decode_step(params, tok, caches)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
    dt = time.time() - t0
    gen_tokens = np.stack(generated, 1)
    print(f"{cfg.name}: {B} requests, {prompt_len}+{gen} tokens "
          f"in {dt:.2f}s ({B * (prompt_len + gen) / dt:.0f} tok/s on "
          f"{device})")
    for b in range(2):
        print(f"  request {b}: {gen_tokens[b][:10].tolist()}")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("arch", nargs="?", default="gemma3-12b")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.arch, a.device)
