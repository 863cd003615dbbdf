"""The plain reference against the port's models, on the CPU in float32
at a small size, on seeded weights (port_bench/weights.py)."""

import json
import math

import pytest
import torch

from port_bench import common, manifest, weights
from port_bench.reference import models as reference

CONFIGS = ("promptir", "promptxrestormerir")


def config(name, **model):
    with open(manifest.HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["model"].update(model)
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_has_the_published_parameter_count(name):
    cfg = config(name)
    shapes = common.reference_shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_in_float32(name):
    cfg = config(name, dim=16, num_blocks=[1, 2, 1, 1],
                 num_refinement_blocks=1)
    seed = 2 ** 31 + 7
    ref = common.reference_model(cfg, seed, "cpu")
    from promptir_tpu_torch.models import create_model

    port = create_model(cfg["port_model"], device="meta", train=False,
                        **cfg["model"], **cfg["port_options"])
    port = weights.load_into(
        port, weights.seeded_state_dict(weights.shapes_of(ref), seed, "cpu"),
        "cpu")
    x = torch.rand(2, 3, 64, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = ref(x), port(x)
    # float32 on both sides: only the order of sums differs
    assert (got - want).abs().max().item() < 1e-4
    assert (want - x).abs().mean().item() > 1e-2  # the residual is not zero


def test_seeded_weights_repeat_and_differ_by_seed():
    cfg = config("promptir", dim=16, num_blocks=[1, 1, 1, 1],
                 num_refinement_blocks=1)
    shapes = common.reference_shapes(cfg)
    a = weights.seeded_state_dict(shapes, 5, "cpu")
    b = weights.seeded_state_dict(shapes, 5, "cpu")
    c = weights.seeded_state_dict(shapes, 6, "cpu")
    key = "encoder_level1.0.attn.qkv.weight"
    assert torch.equal(a[key], b[key])
    assert not torch.equal(a[key], c[key])
    assert abs(a["encoder_level1.0.norm1.body.weight"].mean().item() - 1) < 0.1


def test_fp8_products_move_the_reference():
    from port_bench.reference.precision import products_in

    cfg = config("promptir", dim=16, num_blocks=[1, 1, 1, 1],
                 num_refinement_blocks=1)
    ref = common.reference_model(cfg, 3, "cpu")
    x = torch.rand(1, 3, 32, 48, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = ref(x)
        with products_in("fp8"):
            low = ref(x)
    gap = (full - low).abs().max().item()
    assert 1e-3 < gap < 1.0


def test_reference_builds_every_family():
    assert set(reference.FAMILIES) == {"promptir", "promptxrestormer"}
