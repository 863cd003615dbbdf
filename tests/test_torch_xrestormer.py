"""The port's X-Restormer family: OCAB, the X-blocks and both models
against the reference's goldens and the JAX package, the training config's
state dict, and serving with the 64-pixel pad base."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_init import init_variables
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.models.xrestormer import XTransformerBlock as JaxXBlock
from promptir_tpu.ops.ocab import OCAB as JaxOCAB
from promptir_tpu.ops.ocab import extract_overlapping_windows as jax_windows
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.models.prompt_xrestormer import PromptXBlock
from promptir_tpu_torch.models.xrestormer import XTransformerBlock
from promptir_tpu_torch.ops.ocab import OCAB, extract_overlapping_windows
from promptir_tpu_torch.serve.engine import InferenceEngine
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
# the reference's training config (tools/gen_key_fixtures.py:48-58)
TRAIN = dict(num_blocks=(2, 4, 4, 4), num_refinement_blocks=4,
             channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))


def tensors(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def nhwc(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def channels_last(a):
    return torch.from_numpy(a).contiguous(memory_format=torch.channels_last)


def test_windows_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 3)).astype(np.float32)
    ref = jax_windows(jnp.asarray(x), 8, 12)
    out = extract_overlapping_windows(torch.from_numpy(x), 8, 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_ocab_matches_golden(golden):
    """The reference's OCAB on a (2, 48, 16, 24) input, 3e-5 (the JAX
    suite's tolerance)."""
    g = golden("ocab")
    ocab = OCAB(48, 8, 0.5, 2, 16)
    ocab.load_state_dict(tensors(g.state_dict), strict=True)
    with torch.no_grad():
        y = ocab(nhwc(g.x))
    np.testing.assert_allclose(y.numpy(), g.y_nhwc, rtol=3e-5, atol=3e-5)


def test_ocab_matches_jax_nonsquare_batch2():
    """Flax-initialised weights in both packages, 4 heads of 8, 2e-5."""
    x = np.random.default_rng(1).normal(size=(2, 24, 16, 32)).astype(np.float32)
    jocab = JaxOCAB(dim=32, num_heads=4, dim_head=8)
    variables = jocab.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jocab.apply(variables, jnp.asarray(x)))
    ocab = OCAB(32, 8, 0.5, 4, 8)
    ocab.load_state_dict(state_dict_from_flax(variables, ocab), strict=True)
    with torch.no_grad():
        y = ocab(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_ocab_rejects_sizes_off_the_window():
    with pytest.raises(ValueError, match="multiples of the window 8"):
        OCAB(16, 8, 0.5, 1, 16)(torch.zeros(1, 12, 16, 16))


def test_xblock_matches_golden(golden):
    g = golden("xblock")
    blk = XTransformerBlock(48, num_channel_heads=2, num_spatial_heads=2)
    blk.load_state_dict(tensors(g.state_dict), strict=True)
    with torch.no_grad():
        y = blk(channels_last(g.x))
    np.testing.assert_allclose(y.numpy(), g.y, rtol=3e-5, atol=3e-5)


def test_xblock_matches_unfused_jax_block():
    """The port's block (stats, tail, OCAB, ln_gdfn plain versions) against
    the JAX block with fused_ffn=False, non-square batch 2, 2e-5."""
    x = np.random.default_rng(2).normal(size=(2, 16, 24, 48)).astype(np.float32)
    jblk = JaxXBlock(dim=48, num_channel_heads=2, num_spatial_heads=3)
    variables = jblk.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = np.asarray(jblk.apply(variables, jnp.asarray(x)))
    blk = XTransformerBlock(48, num_channel_heads=2, num_spatial_heads=3)
    blk.load_state_dict(state_dict_from_flax(variables, blk), strict=True)
    with torch.no_grad():
        y = blk(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), ref, rtol=2e-5,
                               atol=2e-5)


def test_prompt_xblock_matches_golden(golden):
    g = golden("prompt_xblock")
    blk = PromptXBlock(32, 5, 16, 48, num_channel_heads=1, num_spatial_heads=2)
    blk.load_state_dict(tensors(g.state_dict), strict=True)
    with torch.no_grad():
        y = blk(channels_last(g.x))
    np.testing.assert_allclose(y.numpy(), g.y, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("name,golden_name,n_tensors", [
    ("xrestormerir", "xrestormer_small", 186),
    ("promptxrestormerir", "prompt_xrestormer_small", 267),
])
def test_small_model_matches_golden(golden, name, golden_name, n_tensors):
    """The reference's own 64 px outputs at one block a level, 1e-4 (the
    JAX suite's tolerance)."""
    g = golden(golden_name)
    assert len(g.state_dict) == n_tensors
    model = create_model(name, device="cpu", **REDUCED)
    model.load_state_dict(tensors(g.state_dict), strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), g.y, rtol=1e-4, atol=1e-4)


def test_reduced_promptxrestormer_matches_jax_nonsquare_batch2():
    """The slice as a whole: one block a level with the training config's
    heads (one channel head, so d reaches 704 at prompt3), flax-initialised
    weights through the bridge (2-D rel_height / rel_width untransposed),
    fp32, a (2, 64, 128, 3) input, 1e-4."""
    x = np.random.default_rng(3).uniform(size=(2, 64, 128, 3)).astype(np.float32)
    kw = dict(TRAIN, **REDUCED)
    jmodel = jax_create_model("promptxrestormerir", **kw)
    variables = init_variables(jmodel, 4, jnp.asarray(x[:1, :64, :64]))
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = create_model("promptxrestormerir", device="cpu", **kw)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-4, atol=1e-4)


def test_training_config_state_dict_matches_reference_keys():
    """707 tensors, 45,713,886 parameters, the reference's names and
    shapes (tests/goldens/sd_keys_promptxrestormerir.json)."""
    ref = json.loads((GOLDENS / "sd_keys_promptxrestormerir.json").read_text())
    model = create_model("promptxrestormerir", device="cpu", **TRAIN)
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref) and len(sd) == 707
    for k, v in ref.items():
        assert list(sd[k].shape) == v["shape"], k
    assert sum(p.numel() for p in model.parameters()) == 45_713_886


@pytest.fixture(scope="module")
def served():
    torch.manual_seed(0)
    return create_model("promptxrestormerir", device="cpu", **REDUCED,
                        channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))


def test_engine_serves_odd_sizes_cropped_with_pad_base_64(served):
    from promptir_tpu_torch.eval.padding import pad_bases
    from promptir_tpu_torch.serve.engine import pad_image_np

    rng = np.random.default_rng(5)
    imgs = [rng.uniform(size=s).astype(np.float32)
            for s in [(50, 70, 3), (64, 64, 3), (33, 100, 3)]]
    base = pad_bases("promptxrestormerir")[0]
    with InferenceEngine(served, pad_base=base, max_batch=2,
                         batch_timeout_ms=100) as eng:
        outs = eng.restore_many(imgs)
        s = eng.stats()
    for im, out in zip(imgs, outs):
        assert out.shape == im.shape and 0.0 <= out.min() and out.max() <= 1.0
        x = torch.from_numpy(pad_image_np(im, base)[None]).permute(0, 3, 1, 2)
        with torch.no_grad():
            ref = served(x).clamp(0, 1).permute(0, 2, 3, 1).numpy()[0]
        np.testing.assert_allclose(out, ref[:im.shape[0], :im.shape[1]],
                                   atol=1e-5)
    # buckets: 64x128 (first and third), 64x64
    assert s["requests"] == 3 and s["compiled_shapes"] == 2


def test_forward_off_the_pad_base_raises(served):
    with pytest.raises(ValueError, match="multiples of 64"):
        served(torch.zeros(1, 3, 64, 72))
