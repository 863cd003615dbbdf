"""The exact H-sharded forward (promptir_tpu_torch/parallel/spatial.py) on
the CPU, over 2 and 4 gloo ranks (parallel/mesh.py:launch, a `file://`
store under tmp_path, one intra-op thread a rank, a deadline of its own).

  * reduced PromptIR (`num_blocks=(1, 1, 1, 1), num_refinement_blocks=1`,
    the JAX package's own initialisation carried by compat/jax_params.py),
    fp32, on a 1x64x64 input: the sharded output within 2e-5 of the port's
    unsharded forward (tests/test_halo.py:47 holds JAX's sharded forward to
    its unsharded one within 2e-5), within 1e-4 of the jitted JAX forward
    (the reduced-promptir fp32 bound of test_torch_model.py), the same on
    every rank, and its all_reduce traffic counted;
  * the row helpers (exchange_halo with zero and reflected borders,
    sharded_roll_h both ways, gather_rows / slice_local_rows,
    global_mean_hw, sharded_resize_bilinear) and parallel/halo.py's
    fixed-halo engine on a local conv net against their global
    counterparts on seeded data: exact, or within 1e-6 where a sum or a
    conv reassociates;
  * ops/conv.py's plans (stride-1 halo at k 3 and 5, stride == kernel,
    the strided k == s + 2p halo, the gather) against the unsharded conv,
    and the gather's NotImplementedError when its rows do not partition;
  * the refusals: a height off 8 n, a `fused_ffn=True` model and a module
    with no hooks (tests/test_torch_spatial_families.py runs the other
    eleven models sharded);
  * eval/padding.py:pad_bases against the JAX package's for all 12 models
    at 1, 2, 4 and 8 shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from jax_init import init_variables
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.parallel.spatial import pad_bases as jax_pad_bases
from promptir_tpu_torch import available_models, create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.eval.padding import pad_bases
from promptir_tpu_torch.parallel.mesh import launch
from promptir_tpu_torch.parallel.spatial import spatial_sharded_apply
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

REDUCED = torch_ranks.REDUCED
WORLDS = (2, 4)
DEADLINE_S = 60
SHARDED_TOL = 2e-5  # tests/test_halo.py:47's bound for JAX's own
JAX_TOL = 1e-4  # test_torch_model.py's reduced-promptir fp32 bound
# sums and interpolations that reassociate across the ranks (float32)
HELPER_TOL = {"global_mean_hw": 1e-6, "spatial_sharded_forward": 1e-6}


@pytest.fixture(scope="module")
def promptir(tmp_path_factory):
    """(state path, input, the port's unsharded output, JAX's output)."""
    x = np.random.default_rng(0).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    jmodel = jax_create_model("promptir", **REDUCED)
    variables = init_variables(jmodel, 3, jnp.asarray(x))
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = create_model("promptir", device="cpu", **REDUCED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    path = tmp_path_factory.mktemp("spatial") / "promptir.pt"
    torch.save(model.state_dict(), path)
    with torch.no_grad():
        y = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return path, x, y.numpy(), ref


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def sharded(request, promptir, tmp_path_factory):
    path, x, _, _ = promptir
    n = request.param
    return n, launch(torch_ranks.spatial_rank, n, "cpu",
                     args=(str(path), x, n), timeout_s=DEADLINE_S, threads=1,
                     store_dir=str(tmp_path_factory.mktemp("store")))


def test_sharded_forward_matches_unsharded(sharded, promptir):
    _, res = sharded
    err = np.abs(res[0]["forward"] - promptir[2]).max()
    assert err <= SHARDED_TOL, err


def test_sharded_forward_matches_jax(sharded, promptir):
    _, res = sharded
    np.testing.assert_allclose(res[0]["forward"], promptir[3],
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_every_rank_returns_the_same_output(sharded):
    n, res = sharded
    assert len(res) == n
    for r in res[1:]:
        np.testing.assert_array_equal(r["forward"], res[0]["forward"])


def test_sharded_forward_traffic_is_counted(sharded):
    """The forward's all_reduces: 1-row halos of the stride-1 convs, the
    norms and Grams of 11 blocks, 3 GAPs, the output gather; the same on
    every rank, and some bytes each."""
    _, res = sharded
    calls, nbytes = res[0]["traffic"]
    assert calls > 11 * 2 and nbytes > 0
    assert all(r["traffic"] == res[0]["traffic"] for r in res)


HELPERS = ["exchange_halo zeros", "exchange_halo reflect",
           "sharded_roll_h 3", "sharded_roll_h -3", "gather_rows",
           "slice_local_rows", "global_mean_hw", "sharded_resize_bilinear",
           "spatial_sharded_forward"]


@pytest.mark.parametrize("name", HELPERS)
def test_row_helpers_match_their_global_counterparts(sharded, name):
    _, res = sharded
    for r in res:
        assert r["primitives"][name] <= HELPER_TOL.get(name, 0.0), (
            name, r["primitives"][name])


@pytest.mark.parametrize("label", list(torch_ranks.CONV_PLANS))
def test_conv_plans_match_the_unsharded_conv(sharded, label):
    """Each plan within 1e-5 of the whole image's conv (the same sums; the
    conv of a taller input may block them differently)."""
    _, res = sharded
    for r in res:
        assert r["convs"][label] <= 1e-5, (label, r["convs"][label])


def test_gather_refuses_rows_that_do_not_partition(sharded):
    _, res = sharded
    assert all(r["convs"]["gather rows that do not partition"] == 1.0
               for r in res)


def tiny_promptir(**kw):
    return create_model("promptir", device="cpu", dim=8, **REDUCED, **kw)


def test_sharded_forward_refuses_a_height_off_8n():
    with pytest.raises(ValueError, match="divisible by 8"):
        spatial_sharded_apply(tiny_promptir(), torch.zeros(1, 60, 64, 3), None)


def test_sharded_forward_refuses_fused_ffn():
    with pytest.raises(ValueError, match="unfused op path"):
        spatial_sharded_apply(tiny_promptir(fused_ffn=True),
                              torch.zeros(1, 64, 64, 3), None)


def test_sharded_forward_refuses_a_model_without_hooks():
    """A module that does not say `spatial_hooks = True` (here a bare
    conv, whose stripe seams nothing would exchange) is refused."""
    model = torch.nn.Conv2d(3, 3, 3, padding=1)
    with pytest.raises(NotImplementedError, match="no spatial hooks"):
        spatial_sharded_apply(model, torch.zeros(1, 64, 64, 3), None)


@pytest.mark.parametrize("flags,message", [
    (["--spatial", "--tile"], "mutually exclusive"),
    (["--spatial", "--fused"], "unfused op path"),
    (["--mesh"], "add --tile"),
])
def test_demo_refuses_flag_combinations(flags, message, tmp_path):
    from promptir_tpu_torch.cli import demo

    with pytest.raises(SystemExit) as e:
        demo.main(["--test_path", str(tmp_path), "--device", "cpu", *flags])
    assert message in str(e.value.code)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", available_models())
def test_pad_bases_match_jax(name, n):
    assert pad_bases(name, n) == jax_pad_bases(name, n)
