"""Data parallelism and the rank launcher (promptir_tpu_torch/parallel/mesh.py)
on the CPU, over gloo ranks: each case a `file://` store under tmp_path,
one intra-op thread a rank and a deadline of its own (at most 60 s), so a
hung collective fails its case and never reaches the tier-1 cap.

  * the launcher: a failing rank's traceback is raised in the caller, a
    rank that never returns fails at the deadline, more ranks than cards
    raise, and the 2 x 2 mesh places rank d * n_model + m at (d, m) as the
    JAX mesh places its devices;
  * the data-parallel step of reduced PromptIR over 2 ranks, B2 a rank,
    against the one-process step on the same B4 global batch (the one
    tests/test_torch_train_grads.py holds against JAX), with and without
    the clip: the all-reduced gradient within 1e-4 of each tensor's max
    |grad|, the logged loss within 1e-6 relative, the parameters after one
    AdamW update within 1e-3 lr where |grad| is above 1e-4 of its tensor's
    max and within 2 lr elsewhere (AdamW's first update is lr g / (|g| +
    eps): near g = 0 its sign follows the rounding);
  * a rank's loader rows: bit-equal to the one-process loader's rows at
    the global batch size;
  * `cli/train.py --device cpu --synthetic --n_data 2`: its checkpoint
    equals a `--n_data 1` run's at twice the batch size within the step
    test's bounds, and a second run resumes it for one more epoch
    (tests/test_torch_dp_stochastic.py runs a stochastic model so);
  * `tiled_inference(group=...)` over 2 ranks against the one-process tiler
    (within 1e-5: the blend sums in another order);
  * the demo's `--tile --mesh` and `--spatial` over 2 ranks against the
    demo without them (its uint8 PNGs within one step).
"""

import os

import numpy as np
import pytest
import torch

import torch_ranks
from promptir_tpu_torch import create_model
from promptir_tpu_torch.data.loader import TrainLoader
from promptir_tpu_torch.data.synthetic import SyntheticTrainDataset
from promptir_tpu_torch.eval.tiling import tiled_inference
from promptir_tpu_torch.parallel.mesh import RankError, launch
from promptir_tpu_torch.train.state import TrainState, make_optimizer
from promptir_tpu_torch.train.step import make_train_step
from promptir_tpu_torch.data.datasets import load_image_rgb
from promptir_tpu_torch.utils.image_io import save_image
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

REDUCED = torch_ranks.REDUCED
DEADLINE_S = 60
LR = 1e-3
GRAD_TOL = 1e-4  # of each tensor's max |grad|
LOSS_TOL = 1e-6  # relative


def run(fn, n, tmp_path, *args, timeout_s=DEADLINE_S):
    return launch(fn, n, "cpu", args=args, timeout_s=timeout_s, threads=1,
                  store_dir=str(tmp_path))


def test_a_failing_rank_raises_its_traceback(tmp_path):
    with pytest.raises(RankError, match="rank failed on purpose"):
        run(torch_ranks.fail_rank, 2, tmp_path, 1)


def test_a_hung_rank_fails_at_the_deadline(tmp_path):
    with pytest.raises(RankError, match="did not finish within 5"):
        run(torch_ranks.hang_rank, 2, tmp_path, timeout_s=5)


def test_more_ranks_than_cards_raise():
    with pytest.raises(ValueError, match="visible"):
        launch(torch_ranks.hang_rank, torch.cuda.device_count() + 1, "cuda")


def test_mesh_places_ranks_as_the_jax_mesh(tmp_path):
    """A 2 x 2 mesh: rank d * 2 + m at (d, m); its data group the ranks of
    its column, its model group those of its row."""
    got = run(torch_ranks.mesh_rank, 4, tmp_path, 2, 2)
    for rank, (d, m, data, model) in enumerate(got):
        assert (d, m) == divmod(rank, 2)
        assert data == (m, m + 2) and model == (2 * d, 2 * d + 1)


def seeded_state(path, seed=0):
    torch.manual_seed(seed)
    model = create_model("promptir", device="cpu", train=True, **REDUCED)
    torch.save(model.state_dict(), path)
    return model


def one_process_step(model, degraded, clean, grad_clip):
    st = TrainState(model, make_optimizer(model.parameters(), LR),
                    grad_clip=grad_clip)
    grads = []
    hook = st.optimizer.register_step_pre_hook(lambda *a: grads.append(
        torch.cat([p.grad.reshape(-1) for p in model.parameters()]).clone()))
    metrics = make_train_step(model)(st, {"degraded": torch.from_numpy(degraded),
                                          "clean": torch.from_numpy(clean)})
    hook.remove()
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return grads[0].numpy(), float(metrics["train_loss"]), params.numpy()


def per_tensor(model, flat):
    out, i = [], 0
    for p in model.parameters():
        out.append(flat[i:i + p.numel()])
        i += p.numel()
    return out


def assert_steps_agree(model, got, want):
    """The bounds of the module docstring, tensor by tensor."""
    (g, loss, p), (g1, loss1, p1) = got, want
    assert abs(loss - loss1) <= LOSS_TOL * abs(loss1), (loss, loss1)
    for a, b, pa, pb in zip(*(per_tensor(model, t) for t in (g, g1, p, p1))):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= GRAD_TOL * max(scale, 1e-30)
        big = np.abs(b) > 1e-4 * scale
        step_gap = np.abs(pa - pb)
        assert (step_gap[big] <= 1e-3 * LR).all()
        assert (step_gap[~big] <= 2 * LR * (1 + 1e-6)).all()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.uniform(size=(4, 16, 16, 3)).astype(np.float32),
            rng.uniform(size=(4, 16, 16, 3)).astype(np.float32))


@pytest.mark.parametrize("grad_clip", [None, 0.01])
def test_dp_step_matches_the_one_process_step(grad_clip, batch, tmp_path):
    model = seeded_state(tmp_path / "w.pt")
    before = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    want = one_process_step(model, *batch, grad_clip)
    got = run(torch_ranks.dp_rank, 2, tmp_path, str(tmp_path / "w.pt"),
              *batch, grad_clip)
    assert not np.array_equal(want[2], before.numpy())
    for r in got:
        assert_steps_agree(model, r, want)
    np.testing.assert_array_equal(got[0][2], got[1][2])


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_rows_are_the_one_process_rows(rank):
    ds = SyntheticTrainDataset(n=12, patch_size=16)
    whole = list(TrainLoader(ds, batch_size=4, num_workers=2).epoch(3))
    part = list(TrainLoader(ds, batch_size=2, num_workers=2, rank=rank,
                            world=2).epoch(3))
    assert len(part) == len(whole) == 3
    for a, b in zip(part, whole):
        for k in ("de_type", "degraded", "clean"):
            np.testing.assert_array_equal(a[k].numpy(),
                                          b[k][2 * rank:2 * rank + 2].numpy())


def cli_train(tmp_path, tag, n_data, batch_size, monkeypatch, *flags):
    """Run cli/train.py on the 64 synthetic samples; return its latest
    checkpoint."""
    from promptir_tpu_torch.cli import train
    from promptir_tpu_torch.train.checkpoints import CheckpointManager

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    train.main(["--synthetic", "--patch_size", "16", "--epochs", "1",
                "--dim", "8", "--batch_size", str(batch_size), "--n_data",
                str(n_data), "--lr", str(LR), "--ckpt_dir",
                str(tmp_path / tag), "--log_dir", str(tmp_path / tag),
                "--device", "cpu", "--num_blocks", "1", "1", "1", "1",
                "--num_refinement_blocks", "1", "--num_workers", "2", *flags])
    ckpt = CheckpointManager(str(tmp_path / tag))
    return torch.load(ckpt.path(ckpt.latest_epoch()), weights_only=True)


def test_cli_train_n_data_2_matches_twice_the_batch(tmp_path, monkeypatch):
    """One epoch of the 64 synthetic samples: one step of B32 a rank over 2
    ranks, against one step of B64 in one process. The first epoch's
    learning rate is the warmup's 0, so the weights stay where the seed put
    them and AdamW's first moments (0.1 grad) carry the gradients."""
    dp = cli_train(tmp_path, "dp", 2, 32, monkeypatch)
    one = cli_train(tmp_path, "one", 1, 64, monkeypatch)
    assert dp["step"] == one["step"] == 1
    model = create_model("promptir", device="cpu", dim=8, **REDUCED)
    names = [k for k, _ in model.named_parameters()]

    def flat(ckpt):
        grads = torch.cat([ckpt["optimizer"]["state"][i]["exp_avg"].reshape(-1)
                           for i in range(len(names))]) / 0.1
        params = torch.cat([ckpt["model"][k].reshape(-1) for k in names])
        return grads.numpy(), 0.0, params.numpy()

    assert_steps_agree(model, flat(dp), flat(one))
    # every rank resumes from rank 0's checkpoint and trains epoch 1
    again = cli_train(tmp_path, "dp", 2, 32, monkeypatch, "--epochs", "2",
                      "--resume", "latest")
    assert (again["epoch"], again["step"]) == (1, 2)
    assert all(torch.isfinite(v).all() for v in again["model"].values())


TILED = dict(tile=32, overlap=8, chunk=3, bucket=8)


def test_sharded_tiler_matches_the_one_process_tiler(tmp_path):
    seeded_state(tmp_path / "w.pt")
    model = create_model("promptir", device="cpu", **REDUCED)
    model.load_state_dict(torch.load(tmp_path / "w.pt", weights_only=True))
    img = np.random.default_rng(1).uniform(size=(1, 80, 72, 3)).astype(
        np.float32)
    with torch.inference_mode():
        want = tiled_inference(model.eval(), torch.from_numpy(img),
                               **TILED).numpy()
    got = run(torch_ranks.tiled_rank, 2, tmp_path, str(tmp_path / "w.pt"),
              img, TILED)
    for r in got:
        assert np.abs(r - want).max() <= 1e-5
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("flags", [["--tile", "--tile_size", "32",
                                    "--tile_overlap", "8", "--tile_chunk",
                                    "3"], []], ids=["mesh", "spatial"])
def test_demo_over_ranks_matches_the_demo(flags, tmp_path, monkeypatch):
    """A 48x64 image (a multiple of 16 high, so --spatial's pad base 16 pads
    as the demo's 8 does): `--tile --mesh` against `--tile`, `--spatial`
    against the plain demo, both over 2 ranks."""
    from promptir_tpu_torch.cli import demo

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    img = np.random.default_rng(2).uniform(size=(64, 48, 3)).astype(
        np.float32)
    os.makedirs(tmp_path / "in")
    save_image(str(tmp_path / "in" / "a.png"), img)
    common = ["--test_path", str(tmp_path / "in"), "--device", "cpu",
              "--num_blocks", "1", "1", "1", "1", "--num_refinement_blocks",
              "1"]
    demo.main([*common, *flags, "--output_path", str(tmp_path / "one")])
    sharded = ["--mesh"] if flags else ["--spatial"]
    demo.main([*common, *flags, *sharded, "--n_data", "2",
               "--output_path", str(tmp_path / "ranks")])
    a = load_image_rgb(str(tmp_path / "one" / "a.png")).astype(int)
    b = load_image_rgb(str(tmp_path / "ranks" / "a.png")).astype(int)
    assert a.shape == (64, 48, 3) and np.abs(a - b).max() <= 1
