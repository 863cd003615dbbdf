"""The training entry point (promptir_tpu_torch/cli/train.py) on the CPU.

  * one epoch of reduced PromptIR over a mixed corpus in the reference's
    layout (a noise level over PNG and BMP images, and `dehaze` over a
    JPEG pair): the loss is finite, a checkpoint is saved, the epoch-end
    evaluation and the profiler window write their records; a second run
    with `--resume latest` continues at epoch 1;
  * `--synthetic` trains without a corpus;
  * `--fused`, and `--remat --remat_levels 1 2`, train an epoch through
    their routes (LnBlock; checkpointed blocks), the launch counters as
    the CPU leaves them (0: the plain versions run);
  * the flag value the port does not run yet (`--n_data 2` with a
    stochastic CAMixer model) exits 2 with its message;
    tests/test_torch_parallel.py trains PromptIR with `--n_data 2`.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from promptir_tpu_torch.cli import train
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

TINY = ["--device", "cpu", "--num_blocks", "1", "1", "1", "1",
        "--num_refinement_blocks", "1"]


def scene(hw, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 200, h), np.linspace(0, 200, w),
                         indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 20, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def save(path, img, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path, **kw)


@pytest.fixture
def corpus(tmp_path):
    root = str(tmp_path / "corpus")
    for sub, text in [("noisy/denoise.txt", "a.png\nb.bmp\n"),
                      ("rainy/rainTrain.txt", ""),
                      ("hazy/hazy_outside.txt", "synthetic/0001_0.8_0.2.jpg\n")]:
        os.makedirs(os.path.dirname(f"{root}/data_dir/{sub}"), exist_ok=True)
        with open(f"{root}/data_dir/{sub}", "w") as f:
            f.write(text)
    save(f"{root}/denoise/a.png", scene((40, 56), 1))
    save(f"{root}/denoise/b.bmp", scene((37, 50), 2))
    save(f"{root}/dehaze/synthetic/0001_0.8_0.2.jpg", scene((43, 38), 3))
    save(f"{root}/dehaze/original/0001.jpg", scene((43, 38), 4))
    save(f"{root}/bsd/1.png", scene((24, 24), 5))
    return root


def records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_runs_an_epoch_on_a_mixed_corpus_and_resumes(corpus, tmp_path):
    """denoise_15 over a PNG and a BMP (x3) and dehaze over a JPEG pair: 7
    samples, 3 steps of B2 an epoch."""
    out = tmp_path / "run"
    args = ["--de_type", "denoise_15", "dehaze", "--patch_size", "32",
            "--batch_size", "2", "--num_workers", "2", "--lr", "1e-3",
            "--data_file_dir", f"{corpus}/data_dir/",
            "--denoise_dir", f"{corpus}/denoise/",
            "--derain_dir", f"{corpus}/derain/",
            "--dehaze_dir", f"{corpus}/dehaze/",
            "--ckpt_dir", str(out / "ckpt"), "--log_dir", str(out),
            "--eval_denoise_path", f"{corpus}/bsd",
            "--profile_dir", str(out / "prof"), "--wblogger", "no-such-project",
            *TINY]
    first = train.main(args + ["--epochs", "1"])
    assert len(first.dataset) == 7 and first.global_step == 3
    assert first.ckpt.all_epochs() == [0]
    recs = records(out)
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert len(losses) == 1 and all(np.isfinite(losses))
    assert any("eval_psnr_denoise15" in r and "eval_ssim_denoise15" in r
               for r in recs)
    trace = out / "prof" / "train_steps_2-7.pt.trace.json"
    with open(trace) as f:
        assert json.load(f)["traceEvents"]

    again = train.main(args + ["--epochs", "2", "--resume", "latest"])
    assert again.start_epoch == 1 and again.global_step == 6
    assert again.ckpt.all_epochs() == [0, 1]
    epochs = [r["epoch"] for r in records(out) if "train_loss" in r]
    assert epochs == [0, 1]


def test_train_cli_synthetic(tmp_path):
    trainer = train.main(["--synthetic", "--patch_size", "16", "--batch_size",
                          "64", "--epochs", "1", "--dim", "8",
                          "--ckpt_dir", str(tmp_path / "ckpt"),
                          "--log_dir", str(tmp_path), *TINY])
    assert trainer.global_step == 1
    assert np.isfinite(records(tmp_path)[-1]["train_loss"])


def count_calls(monkeypatch, module, name):
    """Counts the calls of module.name (it still runs)."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def synthetic_epoch(tmp_path, *flags):
    return train.main(["--synthetic", "--patch_size", "16", "--batch_size",
                       "8", "--epochs", "1", "--dim", "8",
                       "--ckpt_dir", str(tmp_path / "ckpt"),
                       "--log_dir", str(tmp_path), *flags, *TINY])


def test_train_cli_fused_trains_every_block_whole(tmp_path, monkeypatch):
    """--fused: one optimizer step a batch of the 64 synthetic samples, each
    of the 11 blocks of the reduced model one LnBlock, recomputed once in
    its backward (plain_ln_block); no block is checkpointed."""
    from promptir_tpu_torch.models import blocks
    from promptir_tpu_torch.ops import autodiff

    whole = count_calls(monkeypatch, autodiff, "plain_ln_block")
    ckpt = count_calls(monkeypatch, blocks, "checkpoint")
    trainer = synthetic_epoch(tmp_path, "--fused")
    assert trainer.global_step == 8 and trainer.model.fused_ffn
    assert len(whole) == 11 * 8 and not ckpt
    assert np.isfinite(records(tmp_path)[-1]["train_loss"])


def test_train_cli_remat_levels_checkpoint_levels_1_and_2(tmp_path,
                                                          monkeypatch):
    """--remat --remat_levels 1 2: of the reduced model's 11 blocks the 6 at
    levels 1 and 2 (encoder 1 and 2, decoder 2 and 1, the refinement, the
    level-1 noise block) run under a checkpoint each step."""
    from promptir_tpu_torch.models import blocks

    ckpt = count_calls(monkeypatch, blocks, "checkpoint")
    trainer = synthetic_epoch(tmp_path, "--remat", "--remat_levels", "1", "2")
    model = trainer.model
    assert (model.remat, model.remat_levels, model.fused_ffn) == (
        True, (1, 2), False)
    assert trainer.global_step == 8 and len(ckpt) == 6 * 8
    assert np.isfinite(records(tmp_path)[-1]["train_loss"])


