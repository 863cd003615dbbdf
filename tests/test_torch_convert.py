"""cli/convert.py against the JAX CLI: a Lightning checkpoint of the
reference's promptir_small state dict through both gives .npz files with
the same keys and bit-equal arrays; the port reads its file back and
reproduces the reference's output; a wrong state dict names its missing
and unexpected keys. Also compat/jax_params.py's flax_from_state_dict
against the JAX converter on the full-depth and the Uformer state dicts."""

import numpy as np
import pytest
import torch

from promptir_tpu.cli import convert as jax_convert
from promptir_tpu.compat.torch_ckpt import convert_state_dict
from promptir_tpu_torch import create_model
from promptir_tpu_torch.cli import convert
from promptir_tpu_torch.compat.jax_params import (
    flax_from_state_dict,
    load_params_npz,
    state_dict_from_flax,
)
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)


def lightning_ckpt(path, state_dict):
    """`state_dict` as a Lightning checkpoint: `net.` keys and more."""
    torch.save({"epoch": 3, "global_step": 120, "state_dict": {
        f"net.{k}": torch.from_numpy(v) for k, v in state_dict.items()}}, path)
    return str(path)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype == np.float32, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_converted_npz_equals_the_jax_clis(golden, tmp_path, one_torch_thread):
    g = golden("promptir_small")
    ckpt = lightning_ckpt(tmp_path / "small.ckpt", g.state_dict)
    # the JAX CLI has no --num_refinement_blocks, so its check cannot take
    # the one-refinement-block model: both run unchecked here
    jax_convert.main([ckpt, str(tmp_path / "jax.npz"), "--skip_check"])
    convert.main([ckpt, str(tmp_path / "port.npz"), "--skip_check"])
    assert_same_npz(tmp_path / "jax.npz", tmp_path / "port.npz")
    model = create_model("promptir", device="cpu", **REDUCED)
    model.load_state_dict(state_dict_from_flax(
        load_params_npz(str(tmp_path / "port.npz")), model), strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(g.x))
    np.testing.assert_allclose(y.numpy(), g.y, rtol=5e-5, atol=5e-5)


def test_checked_full_depth_conversion_equals_the_jax_converter(
        golden, tmp_path, capsys):
    """The 548-tensor reference state dict, checked against the default
    model: the JAX converter's tree, array for array."""
    sd = golden("promptir_full").state_dict
    ckpt = lightning_ckpt(tmp_path / "full.ckpt", sd)
    convert.main([ckpt, str(tmp_path / "full.npz")])
    assert "all param paths and shapes match the model" in capsys.readouterr().out
    want = dict(flat(convert_state_dict(sd)["params"]))
    with np.load(tmp_path / "full.npz") as got:
        assert sorted(got.files) == sorted(want)
        for k in got.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_uformer_tree_equals_the_jax_converter():
    """The modulators, the transposed convs and the integer buffers (left
    out), at embed 8."""
    model = create_model("promptuformerir", device="cpu", embed_dim=8,
                         depths=(1,) * 9)
    sd = model.state_dict()
    want = dict(flat(convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})["params"]))
    got = dict(flat(flax_from_state_dict(sd, model)))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_wrong_state_dict_names_its_keys(golden, tmp_path):
    sd = dict(golden("promptir_full").state_dict)
    del sd["latent.0.ffn.project_in.weight"]
    sd["latent.9.ffn.project_in.weight"] = np.zeros((2, 2), np.float32)
    ckpt = lightning_ckpt(tmp_path / "bad.ckpt", sd)
    with pytest.raises(ValueError) as e:
        convert.main([ckpt, str(tmp_path / "bad.npz")])
    msg = str(e.value)
    assert "missing from checkpoint (1): ['latent.0.ffn.project_in.weight']" in msg
    assert "unexpected in checkpoint (1): ['latent.9.ffn.project_in.weight']" in msg
    assert not (tmp_path / "bad.npz").exists()
