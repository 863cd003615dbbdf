"""The port's schedules, GAN loss and TensorBoard logging against the JAX
package's, on the CPU.

  * every learning-rate schedule of promptir_tpu/train/schedules.py equal to
    JAX's at every step of a run (pure Python in both packages);
  * `gan_loss`, LSGAN and vanilla, for real and fake targets, within 1e-6 of
    JAX's, and the same ValueError for an unknown type;
  * `MetricLogger(use_tensorboard=True)` sends a SummaryWriter what the JAX
    logger sends it, through a stand-in `torch.utils.tensorboard` module
    (the real one imports TensorFlow where it is installed); a writer that
    fails to open leaves the JSONL file alone.
"""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.train import losses as jlosses
from promptir_tpu.train import schedules as jsched
from promptir_tpu.train.metrics_logger import MetricLogger as JaxLogger
from promptir_tpu_torch.train import losses, schedules
from promptir_tpu_torch.train.metrics_logger import MetricLogger

SCHEDULES = [
    ("warmup_cosine", (2e-4, 15, 150), 200),
    ("warmup_cosine", (1e-3, 1, 3, 1e-5, 1e-6), 10),
    ("multistep_restart", (2e-4, (30, 60, 90), 0.5, (0, 50), (1.0, 0.5)), 120),
    ("multistep_restart", (1e-3, (5, 9)), 12),
    ("linear", (2e-4, 400), 400),
    ("vibrate", (2e-4, 1600), 1600),
    ("cosine_restart", (2e-4, (100, 200, 300), (1.0, 0.5, 0.25), 1e-7), 600),
    ("cosine_restart_cyclic", (2e-4, (50, 70), (1.0, 0.3), (1e-6, 1e-7)), 120),
    ("linear_warmup_decay", (10, 100), 120),
    ("linear_warmup_decay", (10, 100, False, True), 120),
    ("linear_warmup_decay", (0, 50, False, False), 60),
]


@pytest.mark.parametrize("name,args,steps", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(SCHEDULES)])
def test_schedule_equals_jax_at_every_step(name, args, steps):
    ours, ref = getattr(schedules, name)(*args), getattr(jsched, name)(*args)
    assert [ours(s) for s in range(steps)] == [ref(s) for s in range(steps)]


def test_linear_warmup_decay_refuses_both_decays():
    with pytest.raises(AssertionError):
        schedules.linear_warmup_decay(1, 2, cosine=True, linear_=True)


@pytest.mark.parametrize("gan_type", ["lsgan", "vanilla", "bce"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(gan_type, real):
    logits = np.random.default_rng(3).normal(0, 2.0, (4, 1, 8, 8)).astype(
        np.float32)
    ours = losses.gan_loss(torch.from_numpy(logits), real, gan_type).item()
    ref = float(jlosses.gan_loss(jnp.asarray(logits), real, gan_type))
    assert abs(ours - ref) <= 1e-6 * max(abs(ref), 1.0)


def test_gan_loss_is_torchs_mse_and_bce():
    t = torch.from_numpy(np.random.default_rng(4).normal(0, 3.0, (2, 16))
                         .astype(np.float32))
    for real in (True, False):
        tgt = torch.full_like(t, float(real))
        torch.testing.assert_close(losses.gan_loss(t, real, "lsgan"),
                                   torch.nn.MSELoss()(t, tgt))
        torch.testing.assert_close(losses.gan_loss(t, real, "vanilla"),
                                   torch.nn.BCEWithLogitsLoss()(t, tgt))
    for loss in (losses.gan_loss, jlosses.gan_loss):
        with pytest.raises(ValueError, match="unknown gan_type wgan"):
            loss(t if loss is losses.gan_loss else jnp.zeros((2, 2)), True,
                 "wgan")


class FakeTensorboard(types.ModuleType):
    """A stand-in `torch.utils.tensorboard` that records what its
    SummaryWriters are sent."""

    def __init__(self, fail=False):
        super().__init__("torch.utils.tensorboard")
        self.calls = []
        calls = self.calls

        class SummaryWriter:
            def __init__(self, log_dir):
                if fail:
                    raise RuntimeError("no tensorboard")
                calls.append(("open", log_dir))

            def add_scalar(self, tag, value, step):
                calls.append(("scalar", tag, value, step))

            def close(self):
                calls.append(("close",))

        self.SummaryWriter = SummaryWriter


def drive(cls, out):
    log = cls(str(out), use_tensorboard=True)
    log.log({"train_loss": 0.25, "lr": 1e-4}, step=3)
    log.log({"train_loss": 0.125}, step=4)
    log.close()
    with open(out / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


def test_metric_logger_sends_tensorboard_what_jax_sends(tmp_path, monkeypatch):
    rows = [{"step": 3, "train_loss": 0.25, "lr": 1e-4},
            {"step": 4, "train_loss": 0.125}]
    sent = {}
    for name, cls in [("jax", JaxLogger), ("torch", MetricLogger)]:
        fake = FakeTensorboard()
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
        assert drive(cls, tmp_path / name) == rows
        sent[name] = [c if c[0] != "open" else ("open",) for c in fake.calls]
        assert fake.calls[0] == ("open", str(tmp_path / name))
    assert sent["torch"] == sent["jax"] == [
        ("open",), ("scalar", "train_loss", 0.25, 3), ("scalar", "lr", 1e-4, 3),
        ("scalar", "train_loss", 0.125, 4), ("close",)]
    for fake in (FakeTensorboard(fail=True), None):  # fails to open; no module
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
        assert drive(MetricLogger, tmp_path / f"none{fake is None}") == rows
    assert MetricLogger(str(tmp_path / "off"))._tb is None
