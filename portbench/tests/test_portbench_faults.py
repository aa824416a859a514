"""A whole run at a CPU size, past the harness's look for a card: the
program as it is comes out correct, and with its timed path broken
underneath, correct comes out false, once for each fault the cell can
have: a step that leaves the state unchanged, half of each batch left
out (the mean over the rest), the exchange left out, one published token
altered where it is produced, and a private batch handed out again in
place of the next."""
import time

import pytest
import torch

from portbench.tests import tiny
from portbench import harness

SEED = 2 ** 31 + 12345


def _run():
    return harness.run(tiny.tiny_cell(), SEED, 0.0, False,
                       torch.device("cpu"), time.perf_counter(), [])


def test_the_program_as_it_is_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["checks"]["feed_gap"]["value"] == 0
    assert list(res)[-1] == "checks"
    assert res["attempted"] == 3 * 4 and res["failed"] == 0


# each fault patches the program; monkeypatch undoes it


def unchanged(mp):
    from repro_torch.optim import optimizers

    adamw = optimizers.adamw

    def frozen(*args, **kw):
        opt = adamw(*args, **kw)
        return opt._replace(update=lambda g, s, p, step: (
            p, opt.update(g, s, p, step)[1]))

    mp.setattr(optimizers, "adamw", frozen)


def half_batch(mp):
    from repro_torch.core import runtime

    loss = runtime.mhd_total_loss
    rows = {"logits": 0, "embedding": 0, "aux_logits": 1}

    def cut(out, n, lead):
        return {k: v.narrow(rows[k] + lead, 0, n) if k in rows else v
                for k, v in out.items()}

    def halved(priv, labels, pub, teachers, cfg, rng=None):
        n = labels.shape[0] // 2
        return loss(cut(priv, n, 0), labels[:n], cut(pub, n, 0),
                    cut(teachers, n, 1), cfg, rng)

    mp.setattr(runtime, "mhd_total_loss", halved)


def no_exchange(mp):
    from repro_torch.comm.bus import PredictionPool

    mp.setattr(PredictionPool, "insert", lambda self, entry: None)


def token_altered(mp):
    from repro_torch.lm.adaptive_wire import AdaptiveTopKCodec

    encode = AdaptiveTopKCodec.encode

    def altered(self, src, sent_step, t0, sample_ids, outs):
        outs = dict(outs)
        for k in ("logits", "aux_logits"):
            v = outs[k].clone()
            v[..., 0, :] = v[..., 1, :]  # the first position's prediction
            outs[k] = v
        return encode(self, src, sent_step, t0, sample_ids, outs)

    mp.setattr(AdaptiveTopKCodec, "encode", altered)


def repeated_batch(mp):
    from repro_torch.data.pipeline import BatchIterator

    nxt = BatchIterator.next

    def again(self):
        if not hasattr(self, "_first"):
            self._first = nxt(self)
        return self._first

    mp.setattr(BatchIterator, "next", again)


@pytest.mark.parametrize("fault", [unchanged, half_batch, no_exchange,
                                   token_altered, repeated_batch])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
