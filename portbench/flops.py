"""Model FLOPs, the numerator of ``step_mfu_pct``: a frozen copy of
``repro_torch.roofline.analysis.model_flops`` as of commit
2982e0a3c166b6b3c956e35f80f9ac7deeae8935, for a dense model (every
parameter active): 6·N·D for a training step over D tokens (forward and
backward), 2·N·D for an inference forward. Recomputation is not
counted."""


def model_flops(params: int, tokens: int, mode: str) -> float:
    mult = 6.0 if mode == "train" else 2.0
    return mult * params * tokens
