"""The JAX models' constructor options in the port: every dataclass field of
every JAX model is a constructor argument of the port's model, and each
option the port gained (`use_bias`, `scale`, PromptXRestormer's `prompt`,
PromptUformerIR's `drop_path_rate` and `cross_modulator`) runs the JAX
model's forward, held against it at reduced depth in fp32 within the
family's tolerance; SRUpsample against the reference's goldens; a biased
model launches no kernel."""

import inspect
import sys

import jax
import numpy as np
import pytest
import torch

from promptir_tpu.models import _REGISTRY as JAX_REGISTRY
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu_torch import create_model
from promptir_tpu_torch.models import _REGISTRY
from promptir_tpu_torch.ops.resample import SRUpsample
from promptir_tpu_torch.ops.window_attention import DropPath
from test_torch_easy import forward_np, jax_variables, port_model
from test_torch_fused_train import COUNTED, recording_library  # noqa: F401
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_uformer import run_jax

# JAX fields with no constructor argument in the port: `dtype` is the
# registry's (create_model(..., dtype=...) and precision.py), and `variant`
# is the class itself (one port class a registry name)
NOT_ARGUMENTS = {"dtype", "variant"}
REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
XR = dict(REDUCED, channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))
# (id, model, kwargs, input shape, tolerance as (rtol, atol) or a share of
# max |JAX|): the families' tolerances of test_torch_model.py,
# test_torch_xrestormer.py, test_torch_ca_xrestormer.py (ratio 1: every
# window kept), test_torch_easy.py and test_torch_uformer.py
CASES = [
    ("promptir-use_bias", "promptir", dict(REDUCED, use_bias=True),
     (2, 32, 48, 3), (1e-4, 1e-4)),
    ("xrestormerir-use_bias-scale2", "xrestormerir",
     dict(XR, use_bias=True, scale=2), (2, 32, 64, 3), (1e-4, 1e-4)),
    ("promptxrestormereffir-scale3", "promptxrestormereffir",
     dict(XR, scale=3, window_size=4), (1, 32, 32, 3), (1e-4, 1e-4)),
    ("promptxrestormerir-no-prompt", "promptxrestormerir",
     dict(XR, prompt=False), (2, 64, 64, 3), (1e-4, 1e-4)),
    ("easypromptxrestormer-use_bias", "easypromptxrestormer",
     dict(REDUCED, use_bias=True), (2, 32, 48, 3), (0, 1e-5)),
    ("capromptxrestormereff-use_bias", "capromptxrestormereff",
     dict(XR, dim=16, ratio=1.0, use_bias=True), (2, 64, 128, 3), 1e-5),
    ("promptuformerir-drop_path", "promptuformerir",
     dict(embed_dim=8, depths=(1,) * 9, drop_path_rate=0.1,
          cross_modulator=True), (1, 128, 128, 3), 1e-5),
]


def port_arguments(name):
    """The constructor arguments of the port's model `name`: its class's,
    and, where that takes **kwargs, its bases' up to one that does not."""
    fn = _REGISTRY[name]
    cls = getattr(sys.modules[fn.__module__],
                  inspect.signature(fn).return_annotation)
    args = set()
    for c in cls.__mro__:
        if "__init__" not in vars(c):
            continue
        params = inspect.signature(c.__init__).parameters
        args |= set(params) - {"self", "kwargs"}
        if not any(p.kind is p.VAR_KEYWORD for p in params.values()):
            return args
    return args


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_every_jax_field_is_a_port_argument(name):
    jmodel = JAX_REGISTRY[name]()
    fields = {f for f in jmodel.__dataclass_fields__
              if f not in ("parent", "name")}
    assert fields - NOT_ARGUMENTS - port_arguments(name) == set()


@pytest.fixture(scope="module")
def jax_outputs():
    """{case id: (input, variables, the jitted JAX forward's output)}."""
    inputs, jobs = {}, []
    for i, (cid, name, kw, shape, _) in enumerate(CASES):
        x = np.random.default_rng(i).uniform(size=shape).astype(np.float32)
        variables = jax_variables(name, kw, shape, 10 + i)
        inputs[cid] = (x, variables)
        jobs.append((jax_create_model(name, **kw).apply, (variables, x)))
    outs = run_jax(jobs)
    return {cid: (*inputs[cid], np.asarray(y))
            for (cid, *_), y in zip(CASES, outs)}


@pytest.mark.parametrize("cid,name,kw,shape,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_option_forward_matches_jax(one_torch_thread, jax_outputs, cid, name,
                                    kw, shape, tol):
    x, variables, ref = jax_outputs[cid]
    y = forward_np(port_model(name, kw, variables), x)
    scale = kw.get("scale", 1)
    assert y.shape == (shape[0], shape[1] * scale, shape[2] * scale, 3)
    if isinstance(tol, tuple):
        np.testing.assert_allclose(y, ref, rtol=tol[0], atol=tol[1])
    else:
        np.testing.assert_allclose(y, ref, rtol=0,
                                   atol=tol * np.abs(ref).max())


def test_prompt_false_builds_no_prompt_block():
    """Like the JAX model's variables, the state dict has no prompt keys."""
    model = create_model("promptxrestormerir", device="cpu", prompt=False,
                         **XR)
    assert not any(k.startswith("prompt") for k in model.state_dict())
    tree = jax.eval_shape(
        jax_create_model("promptxrestormerir", prompt=False, **XR).init,
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    assert not any(k.startswith("prompt") for k in tree["params"])


@pytest.mark.parametrize("case,scale", [("sr_upsample_x4", 4),
                                        ("sr_upsample_x3", 3)])
def test_sr_upsample_matches_golden(golden, case, scale):
    """The reference's SR_Upsample at 16 features, the JAX suite's 2e-5."""
    g = golden(case)
    up = SRUpsample(scale, 16)
    up.load_state_dict({k: torch.from_numpy(v)
                        for k, v in g.state_dict.items()}, strict=True)
    with torch.no_grad():
        y = up(torch.from_numpy(g.x))
    np.testing.assert_allclose(y.numpy(), g.y, rtol=2e-5, atol=2e-5)


def test_sr_upsample_rejects_other_scales():
    with pytest.raises(ValueError, match="scale 5 is not supported"):
        SRUpsample(5, 8)


def test_drop_path_is_identity_unless_sampled():
    """Rate 0 or deterministic: x itself. Sampled: each image kept (scaled by
    1 / keep) or zeroed, the draws from the generator."""
    x = torch.rand(64, 4, 4, 3) + 0.5
    assert DropPath(0.0)(x, deterministic=False) is x
    assert DropPath(0.3)(x) is x
    gen = torch.Generator().manual_seed(0)
    y = DropPath(0.3)(x, deterministic=False, generator=gen)
    kept = (y != 0).flatten(1).all(1)
    assert ((y == 0).flatten(1).all(1) | kept).all()
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    assert 0 < int(kept.sum()) < 64
    again = DropPath(0.3)(x, deterministic=False,
                          generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, y)


# served bf16 forwards at B1 64x64 on storage-less tensors: the launches of
# stats/tail/ln_gdfn/seam/ln_mdta/tail_stats/gram without and with use_bias
LAUNCHES = [
    ("promptir", {}, (11, 11, 0, 1, 0, 0, 2)),
    ("promptxrestormereffir", XR, (11, 11, 8, 0, 0, 0, 6)),
    ("capromptxrestormereffv2", dict(XR, ratio=1.0), (11, 11, 8, 0, 0, 0, 6)),
]


@pytest.mark.parametrize("name,kw,want", LAUNCHES, ids=[c[0] for c in LAUNCHES])
def test_a_biased_model_launches_no_kernel(recording_library, name, kw, want):
    x = torch.zeros(1, 3, 64, 64, device="meta")
    for bias, counts in ((False, want), (True, (0,) * 7)):
        for fn in COUNTED:
            fn.launches = 0
        model = create_model(name, device="meta", dtype=torch.bfloat16,
                             use_bias=bias, **dict(REDUCED, **kw))
        with torch.no_grad():
            model(x)
        assert tuple(fn.launches for fn in COUNTED) == counts, bias
