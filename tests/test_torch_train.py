"""The port's training path against the JAX package, on the CPU.

  * the gradient bounds that tests/test_torch_train_grads.py holds the
    reduced PromptIR's and PromptXRestormer's gradients to against the JAX
    package (and other files the other models'): GRAD_TOL in float32,
    BF16_GRAD_TOL and BF16_GRAD_MEDIAN in bf16;
  * torch's AdamW against the JAX package's optax optimizer on identical
    gradients, with and without the global-norm clip;
  * the warmup-cosine schedule value for value, the synthetic data and the
    loader's batches bit for bit;
  * the Trainer: the loss falls, a resume continues bit-identically, SIGTERM
    saves a checkpoint that resume replays;
  * the metric logger sends a wandb run what the JAX logger sends it.
"""

import json
import os
import signal
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.data import loader as jloader
from promptir_tpu.data import synthetic as jsynth
from promptir_tpu.train import schedules as jsched
from promptir_tpu.train.state import make_optimizer as jax_make_optimizer
from promptir_tpu_torch import create_model
from promptir_tpu_torch.config import Config
from promptir_tpu_torch.data import loader, synthetic
from promptir_tpu_torch.train import schedules, state
from promptir_tpu_torch.train.losses import l1_loss
from promptir_tpu_torch.train.preemption import PreemptionGuard
from promptir_tpu_torch.train.step import make_train_step
from promptir_tpu_torch.train.trainer import Trainer

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its tensors are small, and
    where the tier-1 run's workers share the host, every op of PyTorch's
    many threads waits at its barrier for threads the other workers hold
    (a default-NAFNet training step took 118 s so against 3 s alone; this
    file's two-epoch trainer runs 414 s against 4.5 s alone). Other files
    import it, which makes it theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
TINY = dict(dim=8, **REDUCED)
# measured 6.0e-5 (prompt1.linear_layer, whose gradient is ~1e-6): the
# port's stats-pass attention and the JAX composition round differently
GRAD_TOL = 5e-4


# bf16 compute, float32 weights: each gradient within BF16_GRAD_TOL of that
# tensor's max |grad| and the median over tensors within BF16_GRAD_MEDIAN.
# The JAX package's own bf16 gradients of this model and batch differ that
# much between its eager and its jitted forms (XLA keeps excess precision in
# fusions): up to 0.179 of a tensor's max, median 0.018. The L1 loss's sign
# makes the median follow the outputs' agreement with the jitted forward.
# With attn rounded into the apply, q and k rounded into the Gram and the
# global residual summed in float32, the port measured a median of 0.0082
# to 0.0086 over 1 to 8 CPU threads (0.0138 to 0.0147 before). PromptGen
# with its rounding points in the wrong order (the GAP, the Linear and the
# mix all kept in float32) measured a median of 0.0139 to 0.0140 (0.0188
# to 0.0197 before, when the bound was 0.017): the per-tensor bound does
# not see that fault, the median bound does.
BF16_GRAD_TOL = 0.25
BF16_GRAD_MEDIAN = 0.011


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_adamw_matches_optax(grad_clip):
    """Identical gradients into both optimizers for 3 steps: the parameters
    agree within 1e-6 (lr 1e-2, so that each step moves them visibly)."""
    rng = np.random.default_rng(2)
    shapes = [(4, 3), (7,), (2, 3, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jax_make_optimizer(1e-2, grad_clip=grad_clip)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = state.make_optimizer(tp, 1e-2)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(a) for a in g], opt_state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        if grad_clip is not None:
            state.clip_by_global_norm([p.grad for p in tp], grad_clip)
        opt.step()
    for a, b, p0 in zip(tp, jp, params):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
        assert np.abs(a.detach().numpy() - p0).max() > 1e-3  # they moved


def test_optimizer_defaults_and_set_learning_rate():
    """torch's AdamW defaults of the reference (train.py:52-53)."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = state.make_optimizer([p])
    assert opt.param_groups[0]["lr"] == 2e-4
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    assert opt.defaults["weight_decay"] == 0.01
    state.set_learning_rate(opt, 1e-3)
    assert opt.param_groups[0]["lr"] == 1e-3


@pytest.mark.parametrize("args", [(2e-4, 15, 150), (1e-3, 1, 3, 1e-5, 1e-6),
                                  (1e-3, 0, 10)])
def test_warmup_cosine_matches_jax(args):
    ref, port = jsched.warmup_cosine(*args), schedules.warmup_cosine(*args)
    assert [port(i) for i in range(160)] == [ref(i) for i in range(160)]


def test_synthetic_data_is_bit_equal_to_jax():
    for seed, h, w in [(0, 32, 48), (1234, 128, 128)]:
        assert np.array_equal(synthetic.synth_clean_image(seed, h, w),
                              jsynth.synth_clean_image(seed, h, w))
    tr, jtr = (m.SyntheticTrainDataset(n=6, patch_size=32) for m in (synthetic, jsynth))
    for i in range(6):
        a = tr.get(i, np.random.default_rng((0, 1, i)))
        b = jtr.get(i, np.random.default_rng((0, 1, i)))
        assert a[0] == b[0]
        assert all(np.array_equal(u, v) for u, v in zip(a[1:], b[1:]))
    te, jte = (m.SyntheticDenoiseTestDataset(n=2, size=32, sigma=25.0)
               for m in (synthetic, jsynth))
    for i in range(2):
        a, b = te.get(i), jte.get(i)
        assert a[0] == b[0]
        assert all(np.array_equal(u, v) for u, v in zip(a[1:], b[1:]))


def test_loader_batches_are_bit_equal_to_jax():
    """The same seed gives the same epoch shuffle and noise draws."""
    ds = synthetic.SyntheticTrainDataset(n=7, patch_size=16)
    ours = loader.TrainLoader(ds, batch_size=2, seed=3, num_workers=2)
    ref = jloader.TrainLoader(jsynth.SyntheticTrainDataset(n=7, patch_size=16),
                              batch_size=2, seed=3, num_workers=2)
    assert len(ours) == len(ref) == 3
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a["degraded"].dtype == torch.float32
            for k in ("de_type", "degraded", "clean"):
                assert np.array_equal(a[k].numpy(), b[k]), k


def test_loader_raises_what_a_worker_raised():
    class Broken:
        def __len__(self):
            return 4

        def get(self, i, rng):
            raise KeyError(f"sample {i}")

    with pytest.raises(KeyError, match="sample"):
        list(loader.TrainLoader(Broken(), batch_size=2).epoch(0))


def test_grad_accum_averages_microbatches():
    """Two microbatches of 2 give the gradient and loss of one batch of 4."""
    ds = synthetic.SyntheticTrainDataset(n=4, patch_size=16)
    batch = next(loader.TrainLoader(ds, batch_size=4, shuffle=False).epoch(0))
    out = []
    for accum in (1, 2):
        torch.manual_seed(0)
        model = create_model("promptir", device="cpu", train=True, **TINY)
        st = state.TrainState(model, state.make_optimizer(model.parameters()))
        metrics = make_train_step(model, grad_accum=accum)(st, batch)
        out.append((metrics, [p.grad.clone() for p in model.parameters()]))
    (m1, g1), (m2, g2) = out
    assert abs(m1["train_loss"].item() - m2["train_loss"].item()) < 1e-6
    assert abs(m1["grad_norm"].item() - m2["grad_norm"].item()) < 1e-5 * m1["grad_norm"].item()
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(a.abs().max().item(), 1e-12))
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(create_model("promptir", device="cpu", train=True, **TINY),
                        grad_accum=3)(st, batch)


def test_xrestormer_backward_runs_through_the_training_route():
    """The X-Restormer family builds for training too: fp32 weights, a bf16
    forward through LnMdta and LnGdfn, a finite gradient on every weight
    (held against JAX by tests/test_torch_train_grads.py)."""
    torch.manual_seed(0)
    model = create_model("promptxrestormerir", device="cpu", train=True,
                         dtype=torch.bfloat16, **REDUCED)
    x = torch.rand(1, 3, 64, 64)
    l1_loss(model(x), x).backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name


def tiny_cfg(tmp_path, epochs=2):
    cfg = Config()
    cfg.train.epochs = epochs
    cfg.train.batch_size = 2
    cfg.train.lr = 1e-3
    cfg.train.warmup_epochs = 1
    cfg.train.cosine_max_epochs = 4
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    cfg.data.num_workers = 2
    cfg.system.device = "cpu"
    return cfg


def tiny_model(seed=0):
    torch.manual_seed(seed)
    return create_model("promptir", device="cpu", train=True, **TINY)


def epoch_losses(cfg):
    with open(os.path.join(cfg.train.log_dir, "metrics.jsonl")) as f:
        return [r["train_loss"] for r in map(json.loads, f) if "epoch" in r]


def test_trainer_fits_and_the_loss_falls(tmp_path):
    cfg = tiny_cfg(tmp_path)
    ds = synthetic.SyntheticTrainDataset(n=8, patch_size=32)
    seen = []
    trainer = Trainer(cfg, ds, model=tiny_model(),
                      eval_hook=lambda ev, m: seen.append(1) or {"hook": 1.0})
    trainer.fit()
    losses = epoch_losses(cfg)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
    assert trainer.ckpt.all_epochs() == [0, 1] and trainer.global_step == 8
    assert seen == [1, 1]


def test_resume_continues_bit_identically(tmp_path):
    """Two epochs in one run equal one epoch, a checkpoint, a new Trainer
    (other initial weights) resumed from it, and the second epoch."""
    ds = synthetic.SyntheticTrainDataset(n=8, patch_size=32)
    straight = Trainer(tiny_cfg(tmp_path / "a"), ds, model=tiny_model())
    straight.fit()
    first = Trainer(tiny_cfg(tmp_path / "b", epochs=1), ds, model=tiny_model())
    first.fit()
    resumed = Trainer(tiny_cfg(tmp_path / "b"), ds, model=tiny_model(seed=5))
    resumed.resume()
    assert resumed.start_epoch == 1 and resumed.global_step == 4
    resumed.fit()
    assert resumed.global_step == straight.global_step == 8
    for a, b in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = (t.state.optimizer.state_dict()["state"] for t in (straight, resumed))
    for k in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k][name], sb[k][name])


def test_sigterm_saves_a_checkpoint_that_resume_replays(tmp_path):
    """SIGTERM mid-epoch: the step finishes, the checkpoint is saved tagged
    epoch - 1, fit returns and restores the handlers; resume replays the
    epoch and completes the run."""
    cfg = tiny_cfg(tmp_path)

    class TermAfter:
        """Sends SIGTERM once the loader has pulled k samples."""

        def __init__(self, ds, k):
            self.ds, self.k, self.n = ds, k, 0

        def __len__(self):
            return len(self.ds)

        def get(self, i, rng=None):
            self.n += 1
            if self.n == self.k:
                os.kill(os.getpid(), signal.SIGTERM)
            return self.ds.get(i, rng)

    ds = synthetic.SyntheticTrainDataset(n=8, patch_size=32)
    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(cfg, TermAfter(ds, 3), model=tiny_model())
    trainer.fit()
    assert signal.getsignal(signal.SIGTERM) is before
    assert trainer.ckpt.all_epochs() == [0] and trainer.global_step < 4
    with open(os.path.join(cfg.train.log_dir, "metrics.jsonl")) as f:
        assert any(json.loads(r).get("preempted_in_epoch") == 0 for r in f)
    again = Trainer(cfg, ds, model=tiny_model(seed=1))
    again.resume()
    assert again.start_epoch == 0 and again.state.epoch == -1
    again.fit()
    assert again.ckpt.all_epochs() == [0, 1]


def test_preemption_guard_latches_sigterm():
    with PreemptionGuard() as guard:
        assert not guard.preempted()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted()
    assert signal.getsignal(signal.SIGTERM) is not guard._on_signal


class FakeWandb:
    """A stand-in `wandb` module that records what a logger sends it."""

    def __init__(self):
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", tuple(sorted(kw))))
        return self

    def log(self, metrics, step):
        self.calls.append(("log", dict(metrics), step))

    def finish(self):
        self.calls.append(("finish",))


def test_metric_logger_sends_wandb_what_jax_sends(tmp_path, monkeypatch):
    """With `wandb_project` and `wandb` importable, each record goes to the
    JSONL file and to the wandb run, as the JAX logger sends it; when
    `wandb` does not import, the JSONL file alone."""
    from promptir_tpu.train.metrics_logger import MetricLogger as JaxLogger
    from promptir_tpu_torch.train.metrics_logger import MetricLogger

    def drive(cls, out):
        log = cls(str(out), wandb_project="p")
        log.log({"train_loss": 0.25, "lr": 1e-4}, step=3)
        log.close()
        with open(out / "metrics.jsonl") as f:
            return [{k: v for k, v in json.loads(line).items() if k != "time"}
                    for line in f]

    sent = {}
    for name, cls in [("jax", JaxLogger), ("torch", MetricLogger)]:
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        rows = drive(cls, tmp_path / name)
        assert rows == [{"step": 3, "train_loss": 0.25, "lr": 1e-4}]
        sent[name] = fake.calls
    assert sent["torch"] == sent["jax"] == [
        ("init", ("dir", "project")),
        ("log", {"train_loss": 0.25, "lr": 1e-4}, 3), ("finish",)]
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises
    assert drive(MetricLogger, tmp_path / "none") == [
        {"step": 3, "train_loss": 0.25, "lr": 1e-4}]
