"""The port's ops against the reference's per-op goldens.

Each golden holds the original PyTorch module's state dict, input and
output (NCHW); the port's module loads the state dict verbatim
(`strict=True`) and must reproduce the output at the JAX suite's 2e-5
(tests/test_ops_parity.py). The TransformerBlock case runs the port's block
path: the stats and tail kernels' plain versions on the CPU.
"""

import jax  # noqa: F401  (both frameworks share the test process)
import numpy as np
import pytest
import torch

from promptir_tpu_torch.models.blocks import TransformerBlock
from promptir_tpu_torch.ops.attention import MDTA
from promptir_tpu_torch.ops.embed import OverlapPatchEmbed
from promptir_tpu_torch.ops.gdfn import GDFN
from promptir_tpu_torch.ops.norm import LayerNorm
from promptir_tpu_torch.ops.prompt import PromptGenBlock
from promptir_tpu_torch.ops.resample import Downsample, Upsample

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = {
    "layernorm_withbias": lambda: LayerNorm(48, bias_free=False),
    "layernorm_biasfree": lambda: LayerNorm(48, bias_free=True),
    "mdta_h1": lambda: MDTA(48, 1),
    "mdta_h4": lambda: MDTA(64, 4, bias=True),
    "gdfn": lambda: GDFN(48, 2.66),
    "transformer_block": lambda: TransformerBlock(48, 2, 2.66),
    "patch_embed": lambda: OverlapPatchEmbed(3, 48),
    "downsample": lambda: Downsample(48),
    "upsample": lambda: Upsample(48),
    "promptgen_up": lambda: PromptGenBlock(32, 5, 16, 48),
    "promptgen_down": lambda: PromptGenBlock(32, 5, 16, 48),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_golden(golden, name):
    g = golden(name)
    module = CASES[name]()
    module.load_state_dict(
        {k: torch.from_numpy(v) for k, v in g.state_dict.items()}, strict=True
    )
    with torch.no_grad():
        y = module(torch.from_numpy(g.x))
    np.testing.assert_allclose(y.numpy(), g.y, **TOL)
