"""Data-parallel training of the stochastic CAMixer models
(promptir_tpu_torch/parallel/data.py, train/step.py) on the CPU, over gloo
ranks: one world of 2 ranks runs the four models, a two-microbatch step
and the sharded tiler, one of 4 runs CATA (parallel/mesh.py:launch, a
`file://` store under tmp_path, one intra-op thread a rank, a deadline of
its own).

  * the models, torch-initialised from a seed and saved once: the CAMixer
    X-Restormers at dim 16 and one block a level with the training
    config's heads (test_torch_ca_xrestormer.py:REDUCED, ratio and hard
    ratio 0.5) on a B4 64x64 batch, CAPromptUformerIR at embed 8 and one
    block a stage on a B2 128x128 batch;
  * the DP step (each rank on its rows of the global batch, dealt by
    microbatch: data/loader.py:rank_rows) against the one-process step on
    the global batch at the same seed, as test_torch_parallel.py holds
    PromptIR's: the gradient within 1e-4 of each tensor's own max |grad|
    (tools/parity.py:grad_errors: of 1% of the median tensor's for a
    tensor below that, a selector's cancelling sum, and of the median's
    for the two biases whose gradient is zero in exact arithmetic or to
    first order), the logged loss within 1e-6 relative. The ranks take
    the one-process step's side of every kink (tools/parity.py:Kinks:
    LeakyReLU's sign, flow_warp's cell, L1's sign): at seed 2 one
    LeakyReLU input of CATA's refinement router lies within float32
    rounding of 0, and the 4-rank step's rounding puts it on the other
    side, which moves that router's gradients past the bound by the
    element's term. Each element the forcing moved lies within KINK_NEAR
    (tools/parity.py) of its kink; a fault of the DP path would move
    elements far from it;
  * the gradient at each mixer's mask and each selector's labels, where
    parallel/data.py's `batch_mean` and `gather_batch` act, a rank's over
    n against the one-process gradient's rows, and both collectives alone
    on seeded data (torch_ranks.py:data_ops);
  * every rank draws the one-process step's Gumbel uniforms bit for bit,
    and each mixer keeps its rows of them;
  * CATA's training selector picks exactly one image of the global batch
    per call, summed over the ranks, the one-process step's;
  * `cli/train.py --synthetic --model capromptxrestormereff --n_data 2`
    against `--n_data 1` at twice the batch;
  * the sharded tiler on CATA against the one-process tiler: a chunk is
    one batch to the selector.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from promptir_tpu_torch import create_model
from promptir_tpu_torch.data.loader import TrainLoader, rank_rows
from promptir_tpu_torch.data.synthetic import SyntheticTrainDataset
from promptir_tpu_torch.eval.tiling import tiled_inference
from promptir_tpu_torch.parallel.mesh import launch
from promptir_tpu_torch.tools.parity import (
    KINK_NEAR,
    Routes,
    grad_errors,
    named_grads,
    tap_errors,
)
from test_torch_ca_xrestormer import REDUCED as CA_REDUCED
from test_torch_parallel import cli_train
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

DEADLINE_S = 120
SEED = 7
GRAD_TOL = 1e-4  # of each tensor's max |grad|
LOSS_TOL = 1e-6  # relative
OPS_TOL = 1e-6  # the collectives alone, of the gradient's max
CATA = "catapromptxrestormer"
# label: (model, kwargs, global batch shape, seed, grad_accum)
CASES = {
    "capromptxrestormereff": ("capromptxrestormereff", CA_REDUCED,
                              (4, 64, 64, 3), 0, 1),
    "capromptxrestormereffv2": ("capromptxrestormereffv2", CA_REDUCED,
                                (4, 64, 64, 3), 1, 1),
    CATA: (CATA, dict(CA_REDUCED, hard_ratio=0.5), (4, 64, 64, 3), 2, 1),
    "capromptuformerir": ("capromptuformerir",
                          dict(embed_dim=8, depths=(1,) * 9, ratio=0.5),
                          (2, 128, 128, 3), 3, 1),
    "capromptxrestormereff accum2": ("capromptxrestormereff", CA_REDUCED,
                                     (4, 64, 64, 3), 0, 2),
}
WORLDS = {2: tuple(CASES), 4: (CATA,)}
TILED = dict(tile=64, overlap=16, chunk=4, bucket=64)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(states file, {label: global batch}, {label: the one-process
    step's stochastic_step dict}, tiler input, its one-process output and
    selections)."""
    states, batches, one = {}, {}, {}
    for label, (name, kw, shape, seed, _) in CASES.items():
        torch.manual_seed(seed)
        model = create_model(name, device="cpu", train=True, **kw)
        states[label] = (name, kw, model.state_dict())
        rng = np.random.default_rng(30 + seed)
        batches[label] = {k: rng.uniform(size=shape).astype(np.float32)
                          for k in ("degraded", "clean")}
    path = tmp_path_factory.mktemp("dp") / "states.pt"
    torch.save(states, path)
    for label, case in CASES.items():
        one[label] = torch_ranks.stochastic_step(
            torch_ranks.load_case(path, label, train=True), batches[label],
            SEED, grad_accum=case[-1])
    img = np.random.default_rng(40).uniform(size=(1, 128, 112, 3)).astype(
        np.float32)
    with torch.inference_mode(), Routes() as routes:
        want = tiled_inference(torch_ranks.load_case(path, CATA),
                               torch.from_numpy(img), **TILED).numpy()
    return path, batches, one, img, (want, routes.images)


@pytest.fixture(scope="module")
def worlds(cases, tmp_path_factory):
    """worlds(n): every rank's ({label: stochastic_step dict}, tiler output
    and selections or None, data_ops' errors), launched once a module."""
    path, batches, one, img, _ = cases
    done = {}

    def get(n):
        if n not in done:
            labels = WORLDS[n]
            done[n] = launch(
                torch_ranks.dp_stochastic_rank, n, "cpu",
                args=(str(path), {k: batches[k] for k in labels},
                      {k: (CASES[k][-1], one[k]["sides"]) for k in labels},
                      SEED, (CATA, img, TILED) if n == 2 else None),
                timeout_s=DEADLINE_S, threads=1,
                store_dir=str(tmp_path_factory.mktemp("store")))
        return done[n]

    return get


def params():
    return [pytest.param(n, label, id=f"world{n}-{label}")
            for n, labels in WORLDS.items() for label in labels]


def model_of(label):
    name, kw, *_ = CASES[label]
    return create_model(name, device="cpu", **kw)


def rank_share(ref, r, n):
    """Rank r's rows of a one-process array (rows first)."""
    b = ref.shape[0] // n
    return ref[r * b:(r + 1) * b]


@pytest.mark.parametrize("n,label", params())
def test_dp_step_matches_the_one_process_step(worlds, cases, n, label):
    """The bounds of the module docstring, tensor by tensor, with the
    one-process step's kink sides; the same loss logged on every rank."""
    one = cases[2][label]
    model = model_of(label)
    ref = named_grads(model, one["grad"])
    res = [out[label] for out, *_ in worlds(n)]
    for got in res:
        assert abs(got["loss"] - one["loss"]) <= LOSS_TOL * abs(one["loss"])
        errs = grad_errors(named_grads(model, got["grad"]), ref)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert len({got["loss"] for got in res}) == 1


@pytest.mark.parametrize("n,label", params())
def test_the_kinks_the_ranks_crossed_lie_within_rounding(worlds, cases, n,
                                                         label):
    """Every kink op of the one-process step ran on every rank, with the
    same shapes (Kinks raises otherwise), and each element whose side the
    forcing changed lies within KINK_NEAR of its kink."""
    calls = len(cases[2][label]["sides"])
    assert calls > 0
    for out, *_ in worlds(n):
        got = out[label]
        assert len(got["flips"]) == calls
        assert max(got["near"]) <= KINK_NEAR, (got["flips"], got["near"])


@pytest.mark.parametrize("n,label", params())
def test_mask_and_label_gradients_are_the_one_process_rows(worlds, cases, n,
                                                           label):
    """A rank's gradient at each mixer's mask and at each selector's labels
    before the gather, over n, from the one-process gradient's rows of that
    call within GRAD_TOL (tools/parity.py:tap_errors: of the call's max,
    or of FLOOR of the step's largest where the call's is smaller; the
    latent selector's label gradient, ~3e-3 of level 1's, is a softmax's
    cancelling sum over the batch)."""
    one = cases[2][label]
    assert one["mask_grads"] and (label != CATA or one["label_grads"])
    for r, (out, *_) in enumerate(worlds(n)):
        for kind in ("mask_grads", "label_grads"):
            assert tap_errors(out[label][kind], one[kind], r, n) <= GRAD_TOL


@pytest.mark.parametrize("n", tuple(WORLDS), ids=lambda n: f"world{n}")
def test_data_collectives_match_the_global_batch(worlds, n):
    """torch_ranks.py:data_ops on every rank: batch_mean's and
    gather_batch's values and gradients within OPS_TOL."""
    for _, _, err in worlds(n):
        assert max(err.values()) <= OPS_TOL, err


@pytest.mark.parametrize("n,label", params())
def test_every_rank_draws_the_one_process_uniforms(worlds, cases, n, label):
    """Each draw bit-equal to the one-process step's, in the same order;
    each mixer keeps this rank's rows of its draw."""
    one = cases[2][label]
    drawn1, kept1 = one["drawn"], one["kept"]
    assert drawn1 and len(drawn1) >= len(kept1) > 0
    for r, (out, *_) in enumerate(worlds(n)):
        drawn, kept = out[label]["drawn"], out[label]["kept"]
        assert len(drawn) == len(drawn1) and len(kept) == len(kept1)
        for a, b in zip(drawn, drawn1):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(kept, kept1):
            np.testing.assert_array_equal(a, rank_share(b, r, n))


@pytest.mark.parametrize("n", tuple(WORLDS), ids=lambda n: f"world{n}")
def test_cata_picks_one_hard_image_per_selector_over_the_global_batch(
        worlds, cases, n):
    """The images each selector call picks, rank after rank, are the
    one-process step's: one of the global batch."""
    picked1 = cases[2][CATA]["images"]
    assert picked1 and all(sum(p) == 1 for p in picked1)
    per_rank = [out[CATA]["images"] for out, *_ in worlds(n)]
    assert all(len(p) == len(picked1) for p in per_rank)
    assert [sum(calls, ()) for calls in zip(*per_rank)] == picked1


def test_sharded_tiler_on_cata_matches_one_process(worlds, cases):
    """Within 1e-5 (the blend sums in another order); each chunk of 4
    tiles keeps the one-process tiler's hard images over both ranks: at
    least round(4 * 0.5) = 2 (ties keep more: the last chunk is filled
    with copies of the first tile)."""
    want, picked1 = cases[4]
    res = [tiles for _, tiles, _ in worlds(2)]
    for y, _ in res:
        assert np.abs(y - want).max() <= 1e-5
    assert picked1 and all(sum(p) >= 2 for p in picked1)
    assert [sum(calls, ()) for calls in zip(*(p for _, p in res))] == picked1


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loader_deals_each_rank_its_share_of_every_microbatch(microbatches):
    """Over 2 ranks of B4: rank r's microbatch i (its rows [2 i / k, ...))
    is its half of the one-process B8 batch's microbatch i, and the ranks'
    rows together are the one-process batch."""
    ds = SyntheticTrainDataset(n=16, patch_size=16)
    whole = next(TrainLoader(ds, batch_size=8, num_workers=2).epoch(1))
    parts = [next(TrainLoader(ds, batch_size=4, num_workers=2, rank=r,
                              world=2, microbatches=microbatches).epoch(1))
             for r in range(2)]
    m = 4 // microbatches
    for r, part in enumerate(parts):
        rows = rank_rows(4, r, 2, microbatches)
        for i in range(microbatches):
            np.testing.assert_array_equal(
                part["clean"][i * m:(i + 1) * m].numpy(),
                whole["clean"][i * 2 * m + r * m:i * 2 * m + (r + 1) * m].numpy())
        np.testing.assert_array_equal(part["clean"].numpy(),
                                      whole["clean"][rows].numpy())
    assert sorted(np.concatenate([rank_rows(4, r, 2, microbatches)
                                  for r in range(2)])) == list(range(8))


def cli_dp_against_one(tmp_path, monkeypatch, *flags):
    """One epoch of the 64 synthetic samples at 64x64 of
    capromptxrestormereff (dim 8): one step of B32 a rank over 2 ranks
    against one step of B64 in one process, as test_torch_parallel.py
    holds PromptIR's (the warmup's lr 0 leaves the weights where the seed
    put them; AdamW's first moments carry the gradients): the gradients
    within GRAD_TOL (tools/parity.py:grad_errors), the weights equal."""
    flags = ["--model", "capromptxrestormereff", "--patch_size", "64", *flags]
    dp = cli_train(tmp_path, "dp", 2, 32, monkeypatch, *flags)
    one = cli_train(tmp_path, "one", 1, 64, monkeypatch, *flags)
    assert dp["step"] == one["step"] == 1
    model = create_model("capromptxrestormereff", device="cpu", dim=8,
                         num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    names = [k for k, _ in model.named_parameters()]

    def grads(ckpt):
        return {k: ckpt["optimizer"]["state"][i]["exp_avg"].numpy() / 0.1
                for i, k in enumerate(names)}

    errs = grad_errors(grads(dp), grads(one))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    for k in names:
        torch.testing.assert_close(dp["model"][k], one["model"][k], rtol=0,
                                   atol=0)


def test_cli_train_n_data_2_matches_twice_the_batch(tmp_path, monkeypatch):
    """cli_dp_against_one."""
    cli_dp_against_one(tmp_path, monkeypatch)


def test_cli_train_n_data_2_grad_accum_2_matches_twice_the_batch(
        tmp_path, monkeypatch):
    """cli_dp_against_one with two microbatches a step: the trainer's
    loader deals each rank its 16 rows of each global microbatch of 32."""
    cli_dp_against_one(tmp_path, monkeypatch, "--grad_accum", "2")
