"""The port's multi-process gossip launcher (`repro_torch.launch.gossip`)
on the CPU: one OS process per client over localhost TCP, the cases of
tests/test_socket_multiproc.py on the port.

  * a 2-process `gossip_socket` cut to 8 steps: every rank runs its steps,
    distills from its neighbor, and delivered == offered on every edge;
  * a crash (``os._exit`` at local step 5) reaped promptly naming the
    rank, then a resume from the per-rank fleet snapshots;
  * the launcher's rejections (a non-socket spec, simulated-tick
    schedules), and a child asked for the card where there is none, which
    fails the launch naming its rank (nothing falls back to the CPU);
  * the script's ``--lm-smoke``: ``lm_hetero`` (SSM, transformer, MoE) as
    3 processes.

Every launch has a hard ``timeout``, so no test can hang the suite.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_threads

test_torch_threads.share_cores()

import repro_torch.exp as PX  # noqa: E402
from repro_torch.launch import (delivery_gaps, fleet_summary,  # noqa: E402
                                launch_gossip)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def gossip_spec(clients: int, steps: int, **train):
    spec = PX.get_preset("gossip_socket")
    c = spec.clients[0]
    return dataclasses.replace(
        spec, clients=PX.ExperimentSpec.uniform_fleet(
            clients, arch=c.arch, aux_heads=c.aux_heads, width=c.width),
        train=dataclasses.replace(spec.train, steps=steps, **train))


def test_two_process_gossip_distills_and_delivers_everything():
    spec = gossip_spec(2, 8)
    results = launch_gossip(spec, timeout=90.0, device="cpu")
    assert set(results) == {0, 1}
    for rank, r in results.items():
        assert r["steps"] == 8 and r["start_step"] == 0
        assert r["device"] == "cpu" and r["spawn_s"] > 0
        assert np.isfinite(r["final_loss"]), rank
        assert r["distill_steps"] >= 1 and r["fresh_teachers"] >= 1, rank
        assert f"c{rank}/main/beta_sh" in r["eval"]
        # the CPU takes the kernels' plain versions: nothing launched
        assert set(r["kernel_launches"]) >= {"topk_wire", "dist_ce_fwd",
                                             "emb_dist_fwd"}
        assert not any(r["kernel_launches"].values())
        assert r["failed_sends"] == 0 and r["undrained_bytes"] == 0
    assert delivery_gaps(results) == {}
    fleet = fleet_summary(results)
    assert fleet["delivered_bytes"] == fleet["offered_bytes"] > 0
    assert fleet["mismatched_edges"] == 0.0


def test_crash_is_reaped_promptly_and_fleet_resumes(tmp_path):
    """A child crashing mid-run fails the launch at once with its rank
    and exit status (not the hard-timeout backstop); ``resume=True``
    restores every rank from its own snapshot slice, and the crashed rank
    restarts from its last save and distills again."""
    spec = dataclasses.replace(
        gossip_spec(3, 8, snapshot_dir=str(tmp_path), snapshot_every=3),
        init_scheme="per_client")
    timeout = 90.0
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="client 1 died"):
        launch_gossip(spec, timeout=timeout, device="cpu", die_at={1: 5})
    assert time.monotonic() - t0 < 0.5 * timeout  # reaped, not timed out

    results = launch_gossip(spec, timeout=timeout, device="cpu", resume=True)
    assert results[1]["start_step"] >= 3  # really restored, not fresh
    assert results[1]["distill_steps"] >= 1  # distills post-restore
    for rank, r in results.items():
        assert np.isfinite(r["final_loss"]), rank
        assert r["steps"] - r["start_step"] >= 1, rank


def test_launch_rejects_non_socket_spec():
    with pytest.raises(ValueError, match="socket"):
        launch_gossip(PX.get_preset("gossip"), device="cpu")


@pytest.mark.parametrize("schedule, match", [
    (dict(mode="async", rates=(1, 1, 1, 4)), "wall-clock"),
    (dict(mode="lockstep"), "wall-clock"),
    (dict(mode="scoreboard", rates=(1, 1, 1, 4)), "pace_ms"),
])
def test_launch_rejects_simulated_tick_schedules(schedule, match):
    spec = dataclasses.replace(PX.get_preset("gossip_socket"),
                               schedule=PX.ScheduleSpec(**schedule))
    with pytest.raises(ValueError, match=match):
        launch_gossip(spec, device="cpu")


def test_children_need_the_card_by_default():
    """With no device given every child runs on the card; a child that
    finds none raises, and the launch fails naming its rank."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)gossip client [01] failed "
                       r"during setup.*device='cpu'"):
        launch_gossip(gossip_spec(2, 2), timeout=60.0, start_timeout=60.0)
    assert time.monotonic() - t0 < 60.0


def test_lm_smoke_runs_on_the_cpu():
    """`scripts/port_gossip_procs.py --lm-smoke --device cpu`: lm_hetero's
    SSM, dense transformer and MoE clients as 3 processes for 12 steps;
    the script exits 0 only if every client distilled, delivery was
    lossless edge by edge and the mean frame stayed under the budget's
    ceiling."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "port_gossip_procs.py"),
         "--lm-smoke", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "lm smoke: 3 processes (lm_ssm/lm_transformer/lm_moe)" in \
        out.stdout
    assert "ok: all 3 archs distilled" in out.stdout
    for rank, arch in enumerate(("lm_ssm", "lm_transformer", "lm_moe")):
        assert f"client {rank} ({arch}): 12 steps" in out.stdout
