"""``engine/optim`` and ``engine/preemption`` of the port against the JAX package.

Schedules are evaluated at the same update counts as optax's; AdamW with
``clip_by_global_norm`` and two-step accumulation (optax ``MultiSteps``) runs
six steps of the same toy problem in both packages from the same numpy
parameters and gradients, which must end within 1e-6. The preemption guard is
tested as ``tests/test_preemption.py`` tests the JAX one, and the port's
trainer is shown to stop after the epoch in which SIGTERM arrives.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from summer_clip_torch.engine import optim
from summer_clip_torch.engine.preemption import PreemptionGuard


@pytest.mark.parametrize("kind", ["cosine", "linear"])
@pytest.mark.parametrize("accum", [1, 2])
def test_learning_rates_equal_optax_over_200_steps(kind, accum):
    """The rate each real update uses: ``schedule(0) = 0`` at the first update,
    and with ``MultiSteps`` the inner schedule advances on updates only."""
    from summer_clip_tpu.engine import optim as jopt

    base, warmup, total = 2e-3, 50, 150
    want_sched = (jopt.warmup_cosine if kind == "cosine" else jopt.warmup_linear)(base, warmup, total)
    sched = (optim.warmup_cosine if kind == "cosine" else optim.warmup_linear)(base, warmup, total)
    p = torch.zeros(3, requires_grad=True)
    tx = optim.with_grad_accum(optim.sgd({"p": p}, sched), accum)
    seen = []
    for _ in range(200):
        p.grad = torch.ones(3)
        before = tx.count
        if (getattr(tx, "calls", 0) + 1) % accum == 0:
            seen.append(tx.current_lr())
        tx.step()
        assert tx.count == before + (1 if len(seen) > before else 0)
    import jax.numpy as jnp

    want = np.asarray(want_sched(jnp.arange(len(seen))), np.float64)
    assert seen[0] == 0.0 and len(seen) == 200 // accum
    np.testing.assert_allclose(np.asarray(seen), want, rtol=1e-7, atol=1e-12)


def test_adamw_clip_and_accumulation_match_optax_after_six_steps():
    import jax.numpy as jnp
    import optax

    from summer_clip_tpu.engine import optim as jopt

    rng = np.random.default_rng(0)
    w0, b0 = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    x = rng.standard_normal((6, 8, 4)).astype(np.float32)
    y = rng.standard_normal((6, 8, 3)).astype(np.float32)
    sched_args = (1e-1, 2, 6)

    def loss_np_grads(w, b, i):   # least squares; the gradient in closed form, f32
        r = x[i] @ w + b - y[i]
        return (2 * x[i].T @ r / r.size).astype(np.float32), (2 * r.sum(0) / r.size).astype(np.float32)

    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(
        jopt.warmup_cosine(*sched_args), weight_decay=0.1)), every_k_schedule=2)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = tx.init(params)
    for i in range(6):
        gw, gb = loss_np_grads(np.asarray(params["w"]), np.asarray(params["b"]), i)
        upd, state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, state, params)
        params = optax.apply_updates(params, upd)

    pt = {"w": torch.from_numpy(w0.copy()).requires_grad_(), "b": torch.from_numpy(b0.copy()).requires_grad_()}
    ptx = optim.with_grad_accum(optim.adamw(pt, optim.warmup_cosine(*sched_args), weight_decay=0.1,
                                            grad_clip_norm=0.5), 2)
    for i in range(6):
        gw, gb = loss_np_grads(pt["w"].detach().numpy(), pt["b"].detach().numpy(), i)
        pt["w"].grad, pt["b"].grad = torch.from_numpy(gw), torch.from_numpy(gb)
        ptx.step()
    np.testing.assert_allclose(pt["w"].detach().numpy(), np.asarray(params["w"]), atol=1e-6)
    np.testing.assert_allclose(pt["b"].detach().numpy(), np.asarray(params["b"]), atol=1e-6)
    assert ptx.count == 3


def test_decay_mask_and_grouped_adamw_match_the_jax_rule():
    from summer_clip_tpu.engine import optim as jopt

    names = {"head.kernel": 0, "head.bias": 0, "ln.scale": 0, "proj.weight": 0}
    tree = {"head": {"kernel": 0, "bias": 0}, "ln": {"scale": 0}, "proj": {"weight": 0}}
    jmask = jopt.decay_mask(tree)
    want = {f"{a}.{b}": v for a, sub in jmask.items() for b, v in sub.items()}
    assert optim.decay_mask(names) == want
    params = {n: torch.ones(2, requires_grad=True) for n in names}
    tx = optim.adamw_grouped(params, 1e-2, weight_decay=0.5)
    for p in params.values():
        p.grad = torch.zeros(2)
    tx.step()   # a zero gradient: only the decay moves a parameter
    moved = {n: bool((p != 1).any()) for n, p in params.items()}
    assert moved == want


def test_trainable_only_freezes_the_rest():
    params = {"adapter_emb.fc1": torch.ones(2, requires_grad=True),
              "core.wpe": torch.ones(2, requires_grad=True)}
    kept = optim.trainable_only(params, lambda name, _: name.startswith("adapter_"))
    assert list(kept) == ["adapter_emb.fc1"] and not params["core.wpe"].requires_grad


def test_langevin_noise_comes_from_the_generator():
    def run(seed):
        p = torch.zeros(5, requires_grad=True)
        tx = optim.langevin({"p": p}, 0.1, lambda step: 0.5 ** step,
                            generator=torch.Generator().manual_seed(seed))
        for _ in range(3):
            p.grad = torch.ones(5)
            tx.step()
        return p.detach()

    a, b = run(3), run(3)
    assert torch.equal(a, b) and not torch.equal(a, run(4))
    # without noise it is SGD: three steps of -0.1
    p = torch.zeros(2, requires_grad=True)
    tx = optim.langevin({"p": p}, 0.1, lambda step: 0.0)
    for _ in range(3):
        p.grad = torch.ones(2)
        tx.step()
    torch.testing.assert_close(p.detach(), torch.full((2,), -0.3))


def test_guard_signal_latches_flag_and_escalates():
    guard = PreemptionGuard(signals=(signal.SIGTERM,))
    prev = signal.getsignal(signal.SIGTERM)
    guard.install()
    assert not guard.triggered
    os.kill(os.getpid(), signal.SIGTERM)
    for _ in range(1000):   # the handler runs at the next bytecode boundary
        if guard.triggered:
            break
    assert guard.triggered
    assert signal.getsignal(signal.SIGTERM) is prev   # a second signal escalates
    guard.restore()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_guard_context_manager_restores_and_refuses_other_threads():
    prev = signal.getsignal(signal.SIGINT)
    with PreemptionGuard(signals=(signal.SIGINT,)) as guard:
        assert signal.getsignal(signal.SIGINT) == guard._on_signal
        guard.trigger()
        assert guard.triggered
    assert signal.getsignal(signal.SIGINT) is prev
    errs = []

    def worker():
        try:
            PreemptionGuard(signals=(signal.SIGTERM,)).install()
        except ValueError as e:
            errs.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert errs, "install off the main thread must raise, not silently no-op"


def test_trainer_stops_after_the_epoch_that_sigterm_hits(tmp_path, monkeypatch):
    """``run_trainer`` guards the run: SIGTERM inside epoch 2 of 5 lets the
    epoch finish and write its checkpoint, logs ``preempted`` and stops."""
    import json

    from summer_clip_torch.core.config import ConfigNode
    from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer

    monkeypatch.chdir(tmp_path)
    saved = []

    class Trainer(BaseTrainer):
        def train_epoch(self, epoch_num, epoch_info):
            if epoch_num == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return epoch_info

        def save_epoch_model(self, epoch_num):
            saved.append(epoch_num)

    prev = signal.getsignal(signal.SIGTERM)
    trainer = run_trainer(Trainer, ConfigNode({"training": {"epochs_num": 5},
                                               "meta": {"random_state": 0, "device": "cpu"}}))
    assert saved == [1, 2] and trainer.preempted()
    assert signal.getsignal(signal.SIGTERM) is prev
    recs = [json.loads(line) for line in (tmp_path / "records.jsonl").read_text().splitlines()]
    assert {"type": "preempted", "epoch": 2}.items() <= next(
        r for r in recs if r.get("type") == "preempted").items()


@pytest.mark.parametrize("name", [None, "auto"])
def test_resolve_device_raises_without_a_card(monkeypatch, name):
    """The default device is the card: with none, a run raises and names the
    way to the CPU instead of quietly running there; "cpu" still resolves."""
    from summer_clip_torch.engine.trainer import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="meta.device=cpu"):
        resolve_device(name)
    assert resolve_device("cpu") == torch.device("cpu")


def test_clip_session_takes_the_cpu_only_when_asked(monkeypatch):
    from summer_clip_torch.apps.common import create_clip_session

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_clip_session("test-vit")
    assert create_clip_session("test-vit", device="cpu").device == torch.device("cpu")
