"""step_mfu_pct: model FLOPs over the traced window's seconds, as a share
of the card's 16-bit tensor-core peak. Model FLOPs (the frozen
``flops.model_flops``) are 6·N·tokens of every client step (its private
batch, and its public batch where it distilled) and 2·N·tokens of every
teacher forward of a publish round, N every parameter a token passes
through, the auxiliary heads included. Moves fleet_samples_per_s."""


def read(r):
    from portbench.flops import model_flops

    b, seq = r.traffic["batch"], r.traffic["data"]["seq_len"]
    horizon = r.traffic["comm"]["horizon"]
    total = 0.0
    for st in r.steps:
        for distilled in st["distill"]:
            rows = b["private"] + (b["public"] if distilled else 0)
            total += model_flops(r.params, rows * seq, "train")
        if st["publish"]:
            total += r.traffic["clients"] * model_flops(
                r.params, horizon * b["public"] * seq, "inference")
    if total <= 0 or r.window_s <= 0:
        return None
    return 100.0 * total / r.window_s / r.peaks["flops_per_s"]
