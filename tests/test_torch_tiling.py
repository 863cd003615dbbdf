"""The port's overlap-blend tiler and the engine's tiled path, on the CPU.

Mirrors tests/test_eval.py (tile positions, the identity blend, the small
image) and tests/test_serve.py (the oversized request routed to the tiler),
and holds the port against the JAX tiler on the same inputs and weights:
  * an identity model blends to the JAX tiler's output bit for bit (the
    same sums in the same order) and to clip(x) within 1e-6 (a sum of three
    equal values over 3 need not round back exactly);
  * a reduced PromptIR with `fused_ffn=True`, two blocks in its first and
    last level stacks so that the tiles run the chained route, against JAX's
    tiled_inference at
    80x72 with tile 32, overlap 8 and chunk 3, fp32, within 1e-4 (the
    whole-model tolerance of test_torch_model.py);
  * the engine serves an oversized request through the tiler exactly as a
    direct call does, a small one batched beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_init import init_variables
from promptir_tpu.eval import tiling as jtiling
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.eval.tiling import tile_positions, tiled_inference
from promptir_tpu_torch.serve.engine import InferenceEngine, pad_image_np

CHAINED = dict(num_blocks=(2, 1, 1, 1), num_refinement_blocks=2)
TILED = dict(tile=32, overlap=8, chunk=3, bucket=8)


class Identity(torch.nn.Module):
    """NCHW identity with one parameter (the tiler reads its device)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x + self.w


class Recorder(Identity):
    """Identity that records the shape of every batch it is given."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def forward(self, x):
        self.shapes.append(tuple(x.shape))
        return super().forward(x)


@pytest.mark.parametrize("tile,stride", [(128, 96), (32, 24), (16, 8)])
def test_tile_positions_match_jax(tile, stride):
    for size in [1, 15, 16, 17, 31, 32, 33, 100, 128, 129, 256, 300, 1023]:
        assert tile_positions(size, tile, stride) == jtiling.tile_positions(
            size, tile, stride)


def test_identity_blend_matches_jax_and_clip():
    x = np.random.default_rng(4).uniform(-0.2, 1.2, size=(1, 300, 280, 3))
    x = x.astype(np.float32)
    y = tiled_inference(Identity(), torch.from_numpy(x), tile=128,
                        overlap=32).numpy()
    ref = np.asarray(jtiling.tiled_inference(lambda p, v: v, None,
                                             jnp.asarray(x), tile=128,
                                             overlap=32))
    np.testing.assert_array_equal(y, ref)
    np.testing.assert_allclose(y, np.clip(x, 0, 1), rtol=1e-6, atol=1e-6)


def test_small_image_takes_one_padded_forward():
    x = np.random.default_rng(5).uniform(size=(1, 60, 50, 3)).astype(np.float32)
    model = Recorder()
    y = tiled_inference(model, torch.from_numpy(x))
    assert model.shapes == [(1, 3, 64, 64)]
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.clip(x, 0, 1), rtol=1e-6)


def test_tiles_run_in_fixed_chunks():
    """9 tiles at 80x72 in chunks of 4: three forwards of exactly 4 tiles
    of the batch of 2 (the last chunk filled with copies that are not
    blended)."""
    x = np.random.default_rng(6).uniform(size=(2, 80, 72, 3)).astype(np.float32)
    model = Recorder()
    y = tiled_inference(model, torch.from_numpy(x), tile=32, overlap=8,
                        chunk=4, bucket=8)
    assert model.shapes == [(8, 3, 32, 32)] * 3
    np.testing.assert_allclose(y.numpy(), x, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def chained():
    """(input, port model, JAX tiled output) of a reduced PromptIR on the
    same flax-initialised weights."""
    x = np.random.default_rng(0).uniform(size=(1, 80, 72, 3)).astype(np.float32)
    jmodel = jax_create_model("promptir", **CHAINED)
    variables = init_variables(jmodel, 3, jnp.zeros((1, 32, 32, 3)))
    fn = jax.jit(lambda p, v: jmodel.apply(p, v))
    ref = np.asarray(jtiling.tiled_inference(fn, variables, jnp.asarray(x),
                                             **TILED))
    model = create_model("promptir", device="cpu", fused_ffn=True, **CHAINED)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return x, model, ref


def test_reduced_promptir_tiled_matches_jax(chained):
    x, model, ref = chained
    y = tiled_inference(model, torch.from_numpy(x), **TILED)
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_engine_tiled_path_matches_jax(chained):
    """An 80x72 request (80x72 padded, above the 64x64 threshold) runs alone
    through the tiler, as the JAX engine runs it (bucket = pad_base); a
    24x40 request is served whole beside it."""
    x, model, ref = chained
    small = np.random.default_rng(1).uniform(size=(24, 40, 3)).astype(np.float32)
    with InferenceEngine(model, pad_base=8, max_batch=2, batch_timeout_ms=50,
                         tile_threshold_px=64 * 64, tile_size=32,
                         tile_overlap=8, tile_chunk=3) as eng:
        out_small, out_big = eng.restore_many([small, x[0]])
        s = eng.stats()
    np.testing.assert_allclose(out_big, ref[0], rtol=1e-4, atol=1e-4)
    direct = tiled_inference(model, torch.from_numpy(x), **TILED).numpy()[0]
    np.testing.assert_array_equal(out_big, direct)
    with torch.no_grad():
        whole = model(torch.from_numpy(pad_image_np(small, 8)[None])
                      .permute(0, 3, 1, 2)).clamp(0, 1)
    np.testing.assert_allclose(out_small, whole[0].permute(1, 2, 0).numpy(),
                               atol=1e-5)
    assert s["tiled_requests"] == 1 and s["requests"] == 2
    assert s["batches"] == 2 and s["compiled_shapes"] == 1
