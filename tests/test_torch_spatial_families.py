"""The exact H-sharded forward of the other eleven models
(promptir_tpu_torch/parallel/spatial.py and the hooks in ops/ and models/)
on the CPU, over gloo ranks: one world of 2 ranks runs every case, one of
4 runs promptxrestormerir and promptuformerir (parallel/mesh.py:launch, a
`file://` store under tmp_path, one intra-op thread a rank, a deadline of
its own).

  * the cases are tests/test_halo.py's reduced configs: the X-Restormers,
    EasyPromptXRestormer and the CAMixer X-Restormers at dim 16 and one
    block a level (the CA models at ratio and hard ratio 0.5, B2), the
    Uformers at embed 8 (PromptUformerIR at win_size 4 on 128x64,
    CAPromptUformerIR on 128x128), NAFNet and NAFNetLocal at width 8 with
    two levels (NAFNetLocal's TLC windows smaller than the map), and
    `xrestormerir` also at scale 2. Each input is tall enough that every
    level's stripe has a seam. A deeper NAFNet, whose 16-row pad multiple
    the stripes miss, runs its gathered path;
  * fp32, on the JAX model's parameter tree filled with seeded values
    (test_torch_easy.py:jax_variables; NAFBlock's beta and gamma are 0 at
    init, which would make every block the identity) carried across by
    compat/jax_params.py: the sharded output within tests/test_halo.py's
    bound for the family (2e-5 for OCAB, Easy and NAFNet, 5e-5 for the
    X-Restormer U-Nets, the Uformers and CAMixer) of the port's unsharded
    forward, within the family test file's fp32 bound of the jitted JAX
    forward, the same on every rank, its all_reduce traffic counted, and
    the windows each CAMixer call keeps and the images each selector call
    picks equal to the unsharded forward's;
  * the op-level hooks against their whole-image counterparts: the dilated
    conv plans, OCAB's neighbour rows, a LeWin block's shift across a seam
    and its gathered path, the TLC pool (a window smaller than the image,
    and one covering it: the global mean), the condition pyramid and
    `upscale_input`;
  * every registered model (parallel/spatial.py:SPATIAL_MODELS) has
    `spatial_hooks`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu_torch import available_models, create_model
from promptir_tpu_torch.eval.padding import pad_bases
from promptir_tpu_torch.parallel.mesh import launch
from promptir_tpu_torch.tools.parity import Routes
from test_torch_ca_xrestormer import REDUCED as CA_REDUCED
from test_torch_easy import (  # noqa: F401 (one_torch_thread: a fixture)
    jax_variables,
    one_torch_thread,
    port_model,
)
from test_torch_uformer import run_jax

DEADLINE_S = 120
ONE_BLOCK = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
XR = dict(ONE_BLOCK, dim=16)
NAF = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
UFORMER_WIN4 = dict(embed_dim=8, win_size=4, depths=(2, 2, 2, 1, 1, 1, 2, 2, 2),
                    num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2))
# tests/test_halo.py's bounds of the sharded forward against the unsharded
HALO_TOL = {"ocab": 2e-5, "easy": 2e-5, "nafnet": 2e-5, "xr": 5e-5,
            "uformer": 5e-5, "camixer": 5e-5}
# the family files' fp32 bounds against jitted JAX: absolute, or of max |JAX|
JAX_TOL = {
    "xr": (1e-4, "abs"),  # test_torch_xrestormer.py, prompt_xrestormer_eff.py
    "easy": (1e-5, "abs"),  # test_torch_easy.py
    "nafnet": (1e-5, "abs"),  # test_torch_nafnet.py
    "uformer": (1e-5, "max"),  # test_torch_uformer.py, test_torch_camixer.py
    "camixer": (1e-5, "max"),  # test_torch_ca_xrestormer.py, test_torch_cata.py
}
# label: (model, kwargs, input shape, family, whether JAX is compared)
CASES = {
    "xrestormerir": ("xrestormerir", XR, (1, 128, 64, 3), "xr", True),
    "xrestormerir scale 2": ("xrestormerir", dict(XR, scale=2),
                             (1, 64, 32, 3), "xr", True),
    "promptxrestormerir": ("promptxrestormerir", XR, (1, 256, 64, 3), "xr",
                           True),
    "promptxrestormereffir": ("promptxrestormereffir", XR, (1, 128, 64, 3),
                              "xr", True),
    "easypromptxrestormer": ("easypromptxrestormer", XR, (1, 64, 32, 3),
                             "easy", True),
    "nafnet": ("nafnet", NAF, (1, 64, 32, 3), "nafnet", True),
    "nafnetlocal": ("nafnetlocal", dict(NAF, tlc_train_size=(32, 32)),
                    (1, 64, 32, 3), "nafnet", True),
    "nafnet gathered": ("nafnet", dict(NAF, enc_blk_nums=(1, 1, 1, 1),
                                       dec_blk_nums=(1, 1, 1, 1)),
                        (1, 48, 32, 3), "nafnet", False),
    "promptuformerir": ("promptuformerir", UFORMER_WIN4, (1, 128, 64, 3),
                        "uformer", True),
    "capromptuformerir": ("capromptuformerir",
                          dict(embed_dim=8, depths=(1,) * 9, ratio=0.5),
                          (1, 128, 128, 3), "uformer", True),
    "capromptxrestormereff": ("capromptxrestormereff", CA_REDUCED,
                              (2, 64, 64, 3), "camixer", True),
    "capromptxrestormereffv2": ("capromptxrestormereffv2", CA_REDUCED,
                                (2, 64, 64, 3), "camixer", True),
    "catapromptxrestormer": ("catapromptxrestormer",
                             dict(CA_REDUCED, hard_ratio=0.5),
                             (2, 64, 64, 3), "camixer", True),
}
FOUR = ("promptxrestormerir", "promptuformerir")
STOCHASTIC = ("capromptuformerir", "capromptxrestormereff",
              "capromptxrestormereffv2", "catapromptxrestormer")


def jax_apply(name, kwargs):
    jmodel = jax_create_model(name, **kwargs)
    if name in STOCHASTIC:
        return lambda v, x: jmodel.apply(v, x, True)
    return jmodel.apply


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(states file, {label: input}, {label: (the port's unsharded output,
    windows, images)}, {label: JAX's output})."""
    states, inputs, port, jobs = {}, {}, {}, []
    for i, (label, (name, kw, shape, _, with_jax)) in enumerate(CASES.items()):
        x = np.random.default_rng(100 + i).uniform(size=shape).astype(
            np.float32)
        variables = jax_variables(name, kw, shape, 200 + i)
        model = port_model(name, kw, variables).eval()
        states[label] = (name, kw, model.state_dict())
        inputs[label] = x
        with torch.no_grad(), Routes() as routes:
            y = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        port[label] = (y.permute(0, 2, 3, 1).numpy(), routes.windows,
                       routes.images)
        if with_jax:
            jobs.append((label, (jax_apply(name, kw), (variables,
                                                       jnp.asarray(x)))))
    ref = dict(zip([label for label, _ in jobs],
                   (np.asarray(o) for o in run_jax([j for _, j in jobs]))))
    path = tmp_path_factory.mktemp("families") / "states.pt"
    torch.save(states, path)
    return path, inputs, port, ref


@pytest.fixture(scope="module")
def worlds(cases, tmp_path_factory):
    """worlds(n): every rank's ({label: (output, (all_reduce calls, bytes),
    windows, images)}, {op: error}) in the world of n ranks, launched once
    a module (2 ranks: every case; 4: FOUR)."""
    path, inputs, _, _ = cases
    done = {}

    def get(n):
        if n not in done:
            labels = list(CASES) if n == 2 else list(FOUR)
            done[n] = launch(
                torch_ranks.families_rank, n, "cpu",
                args=(str(path), {k: inputs[k] for k in labels}, labels, n),
                timeout_s=DEADLINE_S, threads=1,
                store_dir=str(tmp_path_factory.mktemp("store")))
        return done[n]

    return get


def case_params(with_jax=False):
    return [pytest.param(n, label, id=f"world{n}-{label}")
            for n, labels in ((2, CASES), (4, FOUR)) for label in labels
            if CASES[label][4] or not with_jax]


@pytest.mark.parametrize("n,label", case_params())
def test_sharded_forward_matches_unsharded(worlds, cases, n, label):
    want = cases[2][label][0]
    tol = HALO_TOL[CASES[label][3]]
    for out, _ in worlds(n):
        y = out[label][0]
        assert y.shape == want.shape
        err = np.abs(y - want).max()
        assert err <= tol, (label, err)


@pytest.mark.parametrize("n,label", case_params(with_jax=True))
def test_sharded_forward_matches_jax(worlds, cases, n, label):
    want = cases[3][label]
    tol, kind = JAX_TOL[CASES[label][3]]
    bound = tol * (np.abs(want).max() if kind == "max" else 1.0)
    err = np.abs(worlds(n)[0][0][label][0] - want).max()
    assert err <= bound, (label, err, bound)


@pytest.mark.parametrize("n,label", case_params())
def test_every_rank_returns_the_same_output_and_traffic(worlds, n, label):
    res = [out[label] for out, _ in worlds(n)]
    calls, nbytes = res[0][1]
    assert calls > 0 and nbytes > 0
    for y, traffic, *_ in res[1:]:
        np.testing.assert_array_equal(y, res[0][0])
        assert traffic == res[0][1]


@pytest.mark.parametrize("label", STOCHASTIC)
def test_routing_matches_unsharded(worlds, cases, label):
    """The windows each mixer call keeps and the images each selector call
    picks, call by call (the mixers decide on the gathered level)."""
    _, windows, images = cases[2][label]
    assert windows and (images or label != "catapromptxrestormer")
    for out, _ in worlds(2):
        assert out[label][2] == windows
        assert out[label][3] == images


FAMILY_OPS = ([f"conv {k}" for k in torch_ranks.FAMILY_CONV_PLANS]
              + ["ocab", "lewin shift across a seam",
                 "lewin gathered (a stripe thinner than a window)",
                 "tlc pool (NAFBlock, window 8 on 16 n rows)",
                 "tlc pool (NAFBlock, a window covering the image)"]
              + [f"condition pyramid level {i}" for i in (1, 2, 3, 4)]
              + ["upscale_input x2"])


@pytest.mark.parametrize("n", (2, 4), ids=lambda n: f"world{n}")
@pytest.mark.parametrize("name", FAMILY_OPS)
def test_op_hooks_match_their_global_counterparts(worlds, n, name):
    """Within 1e-5 (the same sums, blocked or reassociated differently on
    another shape, or across the ranks)."""
    for _, ops in worlds(n):
        assert ops[name] <= 1e-5, (name, ops[name])


@pytest.mark.parametrize("name", available_models())
def test_every_model_has_its_spatial_hooks(name):
    model = create_model(name, device="meta")
    assert type(model).spatial_hooks is True


def test_demo_spatial_runs_a_camixer_model(tmp_path, monkeypatch):
    """`--spatial --n_data 2` on capromptxrestormereff (one block a level)
    against the demo without it: a 64x48 image pads to pad_bases' 64x64
    both ways, the uint8 PNGs within one step."""
    from promptir_tpu_torch.cli import demo
    from promptir_tpu_torch.data.datasets import load_image_rgb
    from promptir_tpu_torch.utils.image_io import save_image

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    name = "capromptxrestormereff"
    assert pad_bases(name, 2) == pad_bases(name) == (64, 64)
    img = np.random.default_rng(3).uniform(size=(64, 48, 3)).astype(
        np.float32)
    (tmp_path / "in").mkdir()
    save_image(str(tmp_path / "in" / "a.png"), img)
    common = ["--test_path", str(tmp_path / "in"), "--device", "cpu",
              "--model", name, "--num_blocks", "1", "1", "1", "1",
              "--num_refinement_blocks", "1"]
    demo.main([*common, "--output_path", str(tmp_path / "one")])
    demo.main([*common, "--spatial", "--n_data", "2", "--output_path",
               str(tmp_path / "ranks")])
    a = load_image_rgb(str(tmp_path / "one" / "a.png")).astype(int)
    b = load_image_rgb(str(tmp_path / "ranks" / "a.png")).astype(int)
    assert a.shape == (64, 48, 3) and np.abs(a - b).max() <= 1
