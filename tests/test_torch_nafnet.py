"""The port's NAFBlock, NAFNet (`nafnet`) and NAFNetLocal (`nafnetlocal`)
on the CPU, against the reference's goldens and the JAX package:

  * NAFBlock against `nafblock.npz` within 3e-5; width 16 with one block a
    stage against `nafnet_small.npz` (a 60x60 input, padded to 64 inside
    the model) within 1e-4, its weights loaded verbatim from a Lightning
    `.ckpt` through compat/torch_ckpt.py. Its beta and gamma are the init's
    0, so every block there is an identity: the blocks are held against
    JAX below on seeded, non-zero beta and gamma;
  * the default config: 664 tensors, 29,159,715 parameters, every key at
    the flax path that compat/jax_params.py:flax_path names;
  * the reduced model on a (2, 40, 72, 3) batch (padded to 48x80 inside)
    with seeded weights carried across from the JAX tree: fp32 within 1e-5,
    bf16 within BF16_MODEL_TOL served and training, the loss and gradients
    as tests/test_torch_easy.py holds them;
  * the bf16 residual stream is float32 and every convolution computes in
    bf16, as in the JAX model; where the model pads inside, jitted JAX
    rounds the global residual to bf16 and the port does not;
  * local_avg_pool against JAX at odd sizes and with a window that covers
    the map; NAFNetLocal equal to NAFNet where its windows cover every map,
    and to JAX's NAFNetLocal where they do not;
  * the engine serves odd sizes at pad base 8; the CLIs take both models;
    no kernel wrapper of the port runs, and the launch counters stay 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.ops.easy import NAFBlock as JaxNAFBlock
from promptir_tpu.ops.easy import local_avg_pool as jax_local_avg_pool
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import flax_path, state_dict_from_flax
from promptir_tpu_torch.compat.torch_ckpt import load_checkpoint
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.ops.easy import NAFBlock, local_avg_pool
from test_torch_easy import (  # noqa: F401 (one_torch_thread: a fixture)
    check_bf16,
    check_bf16_grads,
    check_fp32_grads,
    clis_take,
    filled,
    forward_np,
    jax_sides,
    jax_variables,
    kernel_calls,
    nchw,
    one_torch_thread,
    port_model,
    serves_odd_sizes,
)
from test_torch_precision import BF16_MODEL_TOL

NAME = "nafnet"
REDUCED = dict(width=16, middle_blk_num=1, enc_blk_nums=(1, 1, 1, 1),
               dec_blk_nums=(1, 1, 1, 1))
SHAPE = (2, 40, 72, 3)


def test_nafblock_matches_golden(golden):
    g = golden("nafblock")
    blk = NAFBlock(32)
    blk.load_state_dict({k: torch.from_numpy(v)
                         for k, v in g.state_dict.items()}, strict=True)
    with torch.no_grad():
        y = blk(torch.from_numpy(g.x))
    np.testing.assert_allclose(y.numpy(), g.y, rtol=3e-5, atol=3e-5)


def test_small_model_matches_golden_from_a_lightning_ckpt(golden, tmp_path):
    g = golden("nafnet_small")
    assert len(g.state_dict) == 178 and g.x.shape == (1, 3, 60, 60)
    torch.save({"state_dict": {"net." + k: torch.from_numpy(v)
                               for k, v in g.state_dict.items()}},
               tmp_path / "nafnet.ckpt")
    model = load_checkpoint(create_model(NAME, device="cpu", **REDUCED),
                            str(tmp_path / "nafnet.ckpt"))
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    assert y.dtype == torch.float32 and y.shape == g.x.shape
    np.testing.assert_allclose(y.numpy(), g.y, rtol=1e-4, atol=1e-4)


def test_default_config_keys_are_the_flax_paths():
    """NAFNetLocal's tensors are NAFNet's, name for name and shape for
    shape."""
    with torch.device("meta"):
        model = create_model(NAME, device="meta")
        local = create_model("nafnetlocal", device="meta")
    sd = model.state_dict()
    assert len(sd) == 664
    assert sum(p.numel() for p in model.parameters()) == 29_159_715
    assert {k: v.shape for k, v in local.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    tree = jax.eval_shape(jax_create_model(NAME).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    paths = {tuple(p.key for p in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(tree["params"])}
    assert {flax_path(k, v.dim()) for k, v in sd.items()} == paths
    assert flax_path("ups.0.0.weight", 4) == ("ups_0_0", "kernel")
    assert flax_path("downs.3.bias", 1) == ("downs_3", "bias")
    assert flax_path("encoders.3.7.sca.1.weight", 4) == \
        ("encoders_3_7", "sca_1", "kernel")
    assert flax_path("middle_blks.11.beta", 4) == ("middle_blks_11", "beta")
    assert sd["middle_blks.11.beta"].shape == (1, 512, 1, 1)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    assert len(state_dict_from_flax(zeros, model)) == 664


@pytest.fixture(scope="module")
def jax_side():
    return jax_sides(NAME, REDUCED, SHAPE, 3)


def test_reduced_model_matches_jax_fp32_nonsquare_batch2(jax_side):
    """fp32 within 1e-5 (measured 3.6e-7 of outputs up to 1.67); beta and
    gamma N(0, 0.3), so every block computes."""
    x, _, variables, ref, _ = jax_side
    assert np.abs(variables["params"]["middle_blks_0"]["beta"]).min() > 0
    y = forward_np(port_model(NAME, REDUCED, variables), x)
    assert y.shape == x.shape
    np.testing.assert_allclose(y, ref["fp32"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_reduced_model_matches_jax_bf16(jax_side, train):
    """BF16_MODEL_TOL (measured 7.8e-3, one bf16 ulp at 1, in both)."""
    err = check_bf16(NAME, REDUCED, jax_side, train)
    assert err <= BF16_MODEL_TOL, err


def test_reduced_loss_and_grads_match_jax(jax_side):
    check_fp32_grads(NAME, REDUCED, jax_side)


def test_reduced_bf16_loss_and_grads_match_jax(jax_side):
    """bf16 (measured: worst ratio 1.53, median error 0.0126 against JAX's
    0.0181)."""
    check_bf16_grads(NAME, REDUCED, jax_side)


def test_bf16_nafblock_returns_float32_as_jax_does():
    """`inp + x * beta` multiplies a bf16 tensor by a float32 parameter,
    which JAX promotes: a bf16 NAFBlock returns float32 in both packages,
    though the port's served block holds beta in bf16."""
    x = np.random.default_rng(7).normal(size=(2, 6, 10, 16)).astype(np.float32)
    jblk = JaxNAFBlock(16, dtype=jnp.bfloat16)
    v = filled(jax.eval_shape(jblk.init, jax.random.PRNGKey(0), x), 8)
    jy = jax.eval_shape(jblk.apply, v, jnp.asarray(x).astype(jnp.bfloat16))
    blk = NAFBlock(16)
    blk.load_state_dict(state_dict_from_flax(v, blk), strict=True)
    blk = blk.bfloat16()
    assert blk.beta.dtype == torch.bfloat16
    with torch.no_grad():
        y = blk(nchw(x).bfloat16())
    assert jy.dtype == jnp.float32 and y.dtype == torch.float32


@pytest.mark.parametrize("train", [False, True])
def test_bf16_stream_is_float32_and_every_conv_computes_in_bf16(train):
    """Fails if the residual stream is rounded to bf16 (a block returns
    bf16) or a convolution runs in float32 (its input is float32)."""
    torch.manual_seed(0)
    model = create_model(NAME, device="cpu", dtype=torch.bfloat16, train=train,
                         **REDUCED)
    seen = {"conv": set(), "block": set()}
    hooks = [m.register_forward_hook(
        lambda m, a, out, kind=("conv" if isinstance(m, Conv) else "block"):
        seen[kind].add(a[0].dtype if kind == "conv" else out.dtype))
        for m in model.modules() if isinstance(m, (Conv, NAFBlock))]
    with torch.no_grad():
        y = model(torch.rand(2, 3, 40, 72))
    for h in hooks:
        h.remove()
    assert seen == {"conv": {torch.bfloat16}, "block": {torch.float32}}
    assert y.dtype == torch.float32


def test_padded_global_residual_is_rounded_by_jitted_jax(jax_side):
    """Where NAFNet pads its input inside (40x72, not multiples of 16), the
    jitted JAX bf16 forward rounds `x + x_in` to bf16 before the crop:
    every output lies on the bf16 grid (unpadded, most do not:
    test_torch_bf16_route.py's global residual test). The port sums in
    float32 at every size, off the grid (ROADMAP.md Queue 3; its distance
    from JAX: test_reduced_model_matches_jax_bf16)."""
    from test_torch_precision import on_bf16_grid

    x, _, variables, ref, _ = jax_side
    y = forward_np(port_model(NAME, REDUCED, variables, dtype=torch.bfloat16), x)
    assert on_bf16_grid(ref["bf16"]) == 1.0 and on_bf16_grid(y) < 0.5


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_local_avg_pool_matches_jax_at_odd_sizes(dtype):
    """9x11 with windows (4, 5) and (9, 3), within 1e-6 in fp32 (measured
    4.2e-7: the integral images sum in another order) and bit-equal in
    bf16, and a window covering the map: the global mean."""
    x = np.random.default_rng(0).uniform(size=(2, 9, 11, 3)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).permute(0, 3, 1, 2)
    if dtype == jnp.bfloat16:
        xt = xt.bfloat16()
    for kernel in [(4, 5), (20, 20), (9, 3)]:
        want = np.asarray(jax_local_avg_pool(xj, kernel).astype(jnp.float32))
        got = local_avg_pool(xt, kernel)
        assert got.dtype == xt.dtype
        got = got.float().permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        tol = 1e-6 if dtype == np.float32 else 0
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def nafnet_weights():
    return jax_variables(NAME, REDUCED, (1, 64, 64, 3), 9)


def test_nafnetlocal_equals_nafnet_where_its_windows_cover_every_map(
        nafnet_weights):
    """tlc_base (4096, 4096) within 1e-6 of NAFNet; the default windows
    (384 px at level 0) on a 64x64 input bit for bit."""
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    base = port_model(NAME, REDUCED, nafnet_weights)
    wide = port_model("nafnetlocal", REDUCED, nafnet_weights,
                      tlc_base=(4096, 4096))
    default = port_model("nafnetlocal", REDUCED, nafnet_weights)
    with torch.no_grad():
        y = base(x)
        torch.testing.assert_close(wide(x), y, rtol=0, atol=1e-6)
        assert torch.equal(default(x), y)


def test_nafnetlocal_matches_jax_where_its_windows_are_local(nafnet_weights):
    """tlc_train_size (32, 32) on a 64x64 input (windows 48 / 24 / 12 / 6 /
    3 px a level): equal to JAX's NAFNetLocal within 1e-5 and not to
    NAFNet (measured 5.1e-4 apart)."""
    kw = dict(tlc_train_size=(32, 32), **REDUCED)
    x = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_create_model("nafnetlocal", **kw).apply)(
        nafnet_weights, x))
    local = forward_np(port_model("nafnetlocal", kw, nafnet_weights), x)
    base = forward_np(port_model(NAME, REDUCED, nafnet_weights), x)
    np.testing.assert_allclose(local, want, rtol=0, atol=1e-5)
    assert np.abs(local - base).max() > 1e-4


@pytest.mark.parametrize("name", ["nafnet", "nafnetlocal"])
def test_engine_serves_odd_sizes_cropped_with_pad_base_8(name):
    serves_odd_sizes(name, **REDUCED)


@pytest.mark.parametrize("name", ["nafnet", "nafnetlocal"])
def test_the_clis_take_the_model(tmp_path, name):
    """The default model through the trainer, the demo and the server; the
    size flags, which NAFNet has not, are refused as the JAX model refuses
    them."""
    from promptir_tpu_torch.cli import test as cli_test

    trainer = clis_take(name, tmp_path)
    model = trainer.model
    assert type(model).__name__ == "NAFNet" and model.intro.out_channels == 32
    assert len(model.middle_blks) == 12
    assert [len(s) for s in model.encoders] == [2, 2, 4, 8]
    blocks = [m for m in model.modules() if isinstance(m, NAFBlock)]
    assert {b.tlc_kernel is None for b in blocks} == {name == "nafnet"}
    for flags in (["--num_blocks", "1", "1", "1", "1"],
                  ["--num_refinement_blocks", "1"]):
        args = cli_test.build_parser().parse_args(
            ["--model", name, "--device", "cpu", *flags])
        with pytest.raises(TypeError, match=flags[0][2:]):
            cli_test.build_model(args)


def test_no_kernel_runs_and_the_launches_stay_0():
    torch.manual_seed(0)
    served = create_model(NAME, device="cpu", dtype=torch.bfloat16, **REDUCED)
    trained = create_model(NAME, device="cpu", dtype=torch.bfloat16,
                           train=True, **REDUCED)
    x = torch.rand(1, 3, 16, 24)

    def run():
        with torch.no_grad():
            served(x)
        trained(x).mean().backward()

    seen, launches = kernel_calls(run)
    assert seen == set() and launches == [0] * 7
