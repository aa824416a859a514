"""The port's training launcher (`repro_torch.launch.train`) and its train
step (`repro_torch.launch.steps`) against the JAX package's.

Covers the supervised batches a ``--seed`` draws (the reference's numpy
order: tokens, then patch embeddings or fresh decoder tokens and audio
frames), exactly; three train steps of reduced whisper-large-v3 and
reduced llama-3.2-vision-90b under sgd_momentum and adamw, the port's
``make_train_step`` against the reference's (under ``jax.jit``) from the
same params, every ``cross_gate`` at 0.5 so the cross path is live from
step 0, every step's metrics (and, under sgd_momentum, the last
params); the launcher's
supervised mode end to end on the CPU, and its default device, the card;
its ``--mode mhd`` at a small size on the CPU, printing the reference's
``mean/`` keys. The config registry: every architecture the reference
registers, ``full()`` and ``reduced()`` equal to the reference's field by
field, ``arch_ids()`` the reference's list; and the three configs copied
with this launcher (gemma3-27b, qwen2.5-32b, minitron-4b) reduced:
``lm_loss`` and every gradient against the reference from the same
params.

Tolerances: step metrics, params, losses and gradients 2e-4 relative /
2e-5 absolute, as
tests/test_torch_xattn.py (float32 CPU sums in another order, carried
through three updates); the batches exactly.
"""
import contextlib
import dataclasses
import io
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.configs import ARCHS as JARCHS
from repro.configs import arch_ids as jax_arch_ids
from repro.configs import get_reduced as jax_reduced
from repro.core.evaluation import fleet_beta_metrics
from repro.launch import steps as JSTEPS
from repro.launch import train as JTRAIN
from repro.models import transformer as JTF
from repro.models.zoo import build_bundle as jax_bundle
from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
from repro.optim.optimizers import make_optimizer as jax_optimizer
from repro_torch.checkpoint import io as TIO
from repro_torch.configs import ARCHS, arch_ids, get_reduced
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TTRAIN
from repro_torch.models import build_bundle
from repro_torch.models import transformer as TTF
from repro_torch.optim import OptimizerConfig, make_optimizer
import test_torch_threads
from test_torch_xattn import nested, shared_params

test_torch_threads.share_cores()

for _op in (torch.exp, torch.log, torch.sqrt, torch.tanh):
    _op(torch.ones(1))

RTOL, ATOL = 2e-4, 2e-5
STEPS = 3


def _args(**kw) -> types.SimpleNamespace:
    """The launcher's parsed flags with its defaults, then ``kw``."""
    p = dict(batch_size=2, seq_len=24, seed=5, reduced=True, steps=STEPS,
             lr=0.05, optimizer="sgd_momentum", device="cpu")
    p.update(kw)
    return types.SimpleNamespace(**p)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b",
                                  "qwen2.5-32b"])
def test_supervised_batches_match_the_reference_draws(arch, monkeypatch):
    """The reference's launcher, its init and step replaced by a recorder
    (nothing compiles), against `supervised_batch` from the same seed:
    every array of every step equal, dtypes included."""
    seen = []

    def record(bundle, opt):
        def step(state, batch):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return state, {"loss": jnp.zeros(())}
        return step

    monkeypatch.setattr(JSTEPS, "init_train_state", lambda *a, **k: None)
    monkeypatch.setattr(JSTEPS, "make_train_step", record)
    monkeypatch.setattr(JTRAIN, "jax", types.SimpleNamespace(
        jit=lambda f: f))
    args = _args(arch=arch)
    with contextlib.redirect_stdout(io.StringIO()):
        JTRAIN.run_supervised(args)
    cfg = get_reduced(arch)
    rng = np.random.default_rng(args.seed)
    assert len(seen) == STEPS
    for ref in seen:
        port = TTRAIN.supervised_batch(rng, cfg, args.batch_size,
                                       args.seq_len, "cpu")
        assert set(port) == set(ref)
        for k, v in ref.items():
            a = port[k].numpy()
            assert a.dtype == v.dtype and a.shape == v.shape, k
            assert np.array_equal(a, v), k
    if cfg.audio is not None:
        assert ref["audio_frames"].shape == (2, 24, cfg.audio.frame_dim)
        assert ref["tokens"].shape == (2, cfg.audio.decoder_len)


@pytest.fixture(scope="module")
def jax_steps():
    """One reference build a (config, optimizer): the jitted train step."""
    cache = {}

    def get(arch, name, lr):
        if (arch, name) not in cache:
            opt = jax_optimizer(JOptimizerConfig(name=name, init_lr=lr,
                                                 total_steps=STEPS))
            cache[arch, name] = opt, jax.jit(JSTEPS.make_train_step(
                jax_bundle(jax_reduced(arch)), opt))
        return cache[arch, name]

    return get


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("opt_name,lr", [("sgd_momentum", 0.05),
                                         ("adamw", 1e-3)])
def test_train_steps_match_the_reference(arch, opt_name, lr, jax_steps):
    """Three launcher steps on the port's `make_train_step` and on the
    reference's, from the same params (gates at 0.5) and the same seeded
    batches: loss, ce and aux_loss of every step; under sgd_momentum,
    whose update is linear in the gradient, every param after them too
    (AdamW divides each moment by its own root: an entry whose gradient is
    float32 noise in both packages moves by ±lr in either)."""
    cfg = get_reduced(arch)
    params = shared_params(cfg, seed=1)
    jopt, jstep = jax_steps(arch, opt_name, lr)
    jp = nested({k: jnp.asarray(v)
                 for k, v in TIO.params_to_jax(params).items()})
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    opt = make_optimizer(OptimizerConfig(name=opt_name, init_lr=lr,
                                         total_steps=STEPS))
    bundle = build_bundle(cfg)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    step = TSTEPS.make_train_step(bundle, opt)
    rng = np.random.default_rng(7)
    for t in range(STEPS):
        batch = TTRAIN.supervised_batch(rng, cfg, 2, 24, "cpu")
        jstate, m_j = jstep(jstate, {k: jnp.asarray(v.numpy())
                                     for k, v in batch.items()})
        state, m = step(state, batch)
        assert set(m) == set(m_j) == {"loss", "ce", "aux_loss"}
        for k in m_j:
            np.testing.assert_allclose(float(m[k]), float(m_j[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t} {k}")
    assert state["step"] == STEPS == int(jstate["step"])
    flat = JIO.flatten_with_paths(jstate["params"])
    assert set(flat) == set(state["params"])
    for k, v in state["params"].items():
        if opt_name == "sgd_momentum":
            np.testing.assert_allclose(v.numpy(), np.asarray(flat[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    gates = [v for k, v in state["params"].items() if "cross_gate" in k]
    assert all(bool((g != 0.5).all()) for g in gates)


def test_init_train_state_draws_the_bundle_init_and_defaults_to_the_card():
    """The state's params are `init_lm`'s draw from the seed, on the
    device asked for; with no device the card, which raises here."""
    cfg = get_reduced("whisper-large-v3")
    bundle = build_bundle(cfg)
    opt = make_optimizer(OptimizerConfig(name="adamw", total_steps=2))
    state = TSTEPS.init_train_state(bundle, opt, seed=3, device="cpu")
    ref = bundle.init(torch.Generator().manual_seed(3))
    assert state["step"] == 0 and set(state["opt"]) == {"m", "v"}
    for k, v in ref.items():
        assert torch.equal(state["params"][k], v), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TSTEPS.init_train_state(bundle, opt, seed=3)


def test_supervised_launcher_runs_on_the_cpu(capsys):
    """``--mode supervised`` through `main` on the CPU: the reference's
    lines, finite losses; without ``--device cpu`` it asks for the card."""
    hist = TTRAIN.run_supervised(_args(arch="whisper-large-v3", steps=2,
                                       optimizer="adamw", lr=1e-3))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step 0: loss ") and \
        out[-1].startswith("done: 2 steps in ")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert set(hist[0]) == {"loss", "ce", "aux_loss"}
    assert TTRAIN.main(["--mode", "supervised", "--arch",
                        "llama-3.2-vision-90b", "--reduced", "--steps", "1",
                        "--batch-size", "1", "--seq-len", "8", "--device",
                        "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTRAIN.main(["--mode", "supervised", "--arch", "qwen2.5-32b",
                         "--reduced", "--steps", "1"])


def test_mhd_launcher_runs_on_the_cpu(capsys):
    """``--mode mhd`` at a small size: K = 2 ResNet clients, 4 steps; it
    prints the reference's ``mean/`` keys (the reference's own
    `fleet_beta_metrics` names them) with values in [0, 1]."""
    assert TTRAIN.main(["--mode", "mhd", "--device", "cpu", "--steps", "4",
                        "--clients", "2", "--labels", "4",
                        "--samples-per-label", "10", "--batch-size", "8",
                        "--aux-heads", "1"]) == 0
    out = capsys.readouterr().out
    assert "step 0: mean client loss" in out
    printed = json.loads(out[out.index("{"):])
    hist = np.ones(4)
    want = {k for k in fleet_beta_metrics(
        [(0, np.ones((2, 4)), np.ones(4, bool), hist)], 1)
        if k.startswith("mean/")}
    assert set(printed) == want
    assert all(0.0 <= v <= 1.0 for v in printed.values())


# ---------------------------------------------------------------------------
# the config registry (--arch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JARCHS.names())
def test_every_reference_config_is_copied(name):
    """``full()`` and ``reduced()`` of every registered architecture equal
    the reference's, field by field (stages, layer specs and the nested
    configs included)."""
    assert name in ARCHS
    for kind in ("full", "reduced"):
        port, ref = ARCHS.get(name)[kind](), JARCHS.get(name)[kind]()
        assert type(port).__name__ == type(ref).__name__
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), kind


def test_arch_ids_are_the_references():
    assert arch_ids() == jax_arch_ids()
    assert set(ARCHS.names()) == set(JARCHS.names())
    assert len(arch_ids()) == 10 and "qwen2.5-32b" in arch_ids()


@pytest.mark.parametrize("arch", ["gemma3-27b", "qwen2.5-32b",
                                  "minitron-4b"])
def test_copied_configs_loss_and_grads_match_the_reference(arch):
    """The reduced config's lm_loss and the gradient of every leaf, from
    the port's draw carried into the reference's tree: gemma3-27b's 5:1
    sliding window, qk_norm and scaled tied embeddings, qwen2.5-32b's qkv
    bias, minitron-4b's squared ReLU."""
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    params = TTF.init_lm(torch.Generator().manual_seed(2), cfg, device="cpu")
    jp = nested({k: jnp.asarray(v)
                 for k, v in TIO.params_to_jax(params).items()})
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: JTF.lm_loss(p, jcfg, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens)})
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    loss, m = TTF.lm_loss(leaves, cfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL,
                               atol=ATOL)
    assert set(m) == set(m_j)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    g_j = JIO.flatten_with_paths(g_j)
    assert set(leaves) == set(g_j)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
