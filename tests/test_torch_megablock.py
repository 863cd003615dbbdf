"""The merged tail + stats function and the chained-stack route, on the CPU.

  * `tail_stats` (on the CPU its plain version: block_tail_plain, then
    mdta_stats_plain) against the Pallas `fused_tail_stats_padded` in
    interpret mode on the same inputs and weights, as
    test_pallas_kernels.py::test_merged_tail_stats_matches_two_kernels holds
    the Pallas kernel against its two-kernel sequence: x3 within 1e-5 and v2
    within 1e-4; the attention built from the stats within 3e-4, because the
    Pallas kernel rounds q and k to bf16 before the Gram
    (promptir_tpu/ops/pallas/mdta.py:107-113) and the port keeps them fp32;
  * `run_stack` on a reduced PromptIR with `fused_ffn=True` and without
    autograd: the same output as the per-block route of the nn.Sequential
    stacks and as the JAX model, with one mdta_stats, n - 1 tail_stats and
    one block_tail per stack; under autograd, and by default, no tail_stats;
  * the wrapper's launch path on a storage-less tensor: it launches inside
    its tensor's card and counts the launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import block_diag, torch_weights

from jax_init import init_variables
from promptir_tpu.models import create_model as jax_create_model
from promptir_tpu.ops.pallas import mdta as jmdta
from promptir_tpu.ops.pallas.block import pad_nhwc, unpad_nhwc
from promptir_tpu.ops.pallas.megablock import fused_tail_stats_padded
from promptir_tpu_torch import create_model
from promptir_tpu_torch.compat.jax_params import state_dict_from_flax
from promptir_tpu_torch.models import blocks
from promptir_tpu_torch.models import promptir as promptir_model
from promptir_tpu_torch.ops.cuda import build, mdta, megablock

STACK = dict(num_blocks=(2, 3, 2, 2), num_refinement_blocks=2)
STACKS = ("encoder_level1", "encoder_level2", "encoder_level3", "latent",
          "decoder_level3", "decoder_level2", "decoder_level1", "refinement")


def merged_weights(c, heads, seed):
    """numpy weights in the JAX kernels' layout, at the scales of
    test_pallas_kernels.py:_block_weights."""
    rng = np.random.default_rng(seed)
    f = int(c * 2.66)

    def n(*s, sc=1.0, mean=0.0):
        return (rng.normal(size=s) * sc + mean).astype(np.float32)

    return dict(
        ln1w=n(c, sc=0.1, mean=1.0), ln1b=n(c, sc=0.1),
        wqkv=n(c, 3 * c, sc=0.05), wdwa=n(3, 3, 3 * c, sc=0.2),
        wproj=n(c, c, sc=0.05),
        temp=rng.uniform(0.5, 2.0, (heads,)).astype(np.float32),
        ln2w=n(c, sc=0.1, mean=1.0), ln2b=n(c, sc=0.1),
        w1=n(c, 2 * f, sc=0.05), wdwf=n(3, 3, 2 * f, sc=0.2),
        w2=n(f, c, sc=0.05),
    )


@pytest.mark.parametrize("shape,heads", [((2, 40, 24, 48), 2),
                                         ((2, 16, 24, 96), 1)])
def test_tail_stats_matches_pallas_merged_kernel(shape, heads):
    b, h, w, c = shape
    wn, wn1 = merged_weights(c, heads, 31), merged_weights(c, heads, 32)
    tn, tn1 = torch_weights(wn), torch_weights(wn1)
    x = np.random.default_rng(33).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x)
    v, stats = mdta.mdta_stats(xt, tn["ln1w"], tn["ln1b"], tn["wqkv"],
                               tn["wdwa"], heads)
    attn = mdta.attn_from_stats(stats, tn["temp"])
    x3, v2, stats2 = megablock.tail_stats(
        v, xt, attn, tn["wproj"], tn["ln2w"], tn["ln2b"], tn["w1"], tn["wdwf"],
        tn["w2"], tn1["ln1w"], tn1["ln1b"], tn1["wqkv"], tn1["wdwa"], heads)
    attn2 = mdta.attn_from_stats(stats2, tn1["temp"]).numpy()

    cp = 128 * -(-c // 128)
    v_p = np.pad(v.numpy(), ((0, 0),) * 3 + ((0, cp - c),))
    out = fused_tail_stats_padded(
        jnp.asarray(v_p), pad_nhwc(jnp.asarray(x)),
        jnp.asarray(block_diag(attn.numpy(), cp)), wn["wproj"], wn["ln2w"],
        wn["ln2b"], wn["w1"], wn["wdwf"], wn["w2"], wn1["ln1w"], wn1["ln1b"],
        wn1["wqkv"], wn1["wdwa"], w=w, c=c, interpret=True,
    )
    assert out is not None
    x3_j, v2_j, (s_qk, ssq_q, ssq_k, qkp) = out
    attn2_j = jmdta.attn_from_stats(s_qk, ssq_q, ssq_k, jnp.asarray(wn1["temp"]),
                                    c, cp, heads, qkp)
    np.testing.assert_allclose(x3.numpy(), np.asarray(unpad_nhwc(x3_j, w, c)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2_j)[..., :c],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(block_diag(attn2, c),
                               np.asarray(attn2_j)[:, :c, :c], atol=3e-4)


def test_tail_stats_is_block_tail_then_mdta_stats():
    """On the CPU the wrapper is exactly the composition, bias-free norms
    included, and counts no launch."""
    c, heads = 48, 4
    tn = torch_weights(merged_weights(c, heads, 5))
    tn1 = torch_weights(merged_weights(c, heads, 6))
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(1, 9, 13, c, generator=gen)
    v = torch.randn(1, 9, 13, c, generator=gen)
    attn = torch.rand(1, heads, c // heads, c // heads, generator=gen)
    launches = megablock.tail_stats.launches
    x3, v2, stats = megablock.tail_stats(
        v, x, attn, tn["wproj"], tn["ln2w"], None, tn["w1"], tn["wdwf"],
        tn["w2"], tn1["ln1w"], None, tn1["wqkv"], tn1["wdwa"], heads,
        bias_free=True)
    from promptir_tpu_torch.ops.cuda.block import block_tail

    x3_0 = block_tail(v, x, attn, tn["wproj"], tn["ln2w"], None, tn["w1"],
                      tn["wdwf"], tn["w2"], bias_free=True)
    v2_0, stats_0 = mdta.mdta_stats(x3_0, tn1["ln1w"], None, tn1["wqkv"],
                                    tn1["wdwa"], heads, bias_free=True)
    assert torch.equal(x3, x3_0) and torch.equal(v2, v2_0)
    assert torch.equal(stats, stats_0)
    assert megablock.tail_stats.launches == launches


def test_every_tile_serves_a_chained_width():
    """TILES (float32) holds only tiles that the rule returns at the promptir
    stacks' widths, and at each width the rule's tile is the first of TILES
    within the two-blocks-an-SM budget; TC_TILES (bfloat16) holds only tiles
    the stacks take, each the tile of its width class."""
    widths = [(48, 1), (96, 2), (192, 4), (384, 8), (96, 1)]
    two_per_sm = megablock.SM_SMEM // 2 - megablock.BLOCK_RESERVED
    picked = {megablock.tail_stats_tile(c, heads) for c, heads in widths}
    assert picked == set(megablock.TILES)
    for c, heads in widths:
        i = megablock.TILES.index(megablock.tail_stats_tile(c, heads))
        assert all(megablock._smem(c, heads, t) > two_per_sm
                   for t in megablock.TILES[:i])
    bf16 = torch.bfloat16
    picked = {megablock.tail_stats_tile(c, heads, bf16) for c, heads in widths}
    assert picked == {t for _, t in megablock.TC_TILES}
    for c, heads in widths:
        widest, tile = next(e for e in megablock.TC_TILES if c <= e[0])
        assert megablock.tail_stats_tile(c, heads, bf16) == tile


def test_tail_stats_tile_fits_every_chained_width():
    """Every width of the promptir stacks takes the largest tile of which
    two blocks share an SM, a width too wide for that raises; the slots
    stay bounded."""
    want = {(48, 1): (8, 8), (96, 2): (8, 8), (192, 4): (6, 6),
            (384, 8): (4, 6), (96, 1): (6, 6)}
    two_per_sm = megablock.SM_SMEM // 2 - megablock.BLOCK_RESERVED
    for (c, heads), tile in want.items():
        assert megablock.tail_stats_tile(c, heads) == tile
        assert megablock.tail_stats_smem(c, heads) <= two_per_sm
    with pytest.raises(ValueError, match="fits no tile"):
        megablock.tail_stats_tile(704, 1)
    # bfloat16: the ring fills the tensor-core product's rows, one block an SM
    bf16 = torch.bfloat16
    want = {(48, 1): (14, 14), (96, 2): (14, 14), (192, 4): (6, 14),
            (384, 8): (6, 6), (96, 1): (14, 14)}
    for (c, heads), tile in want.items():
        assert megablock.tail_stats_tile(c, heads, bf16) == tile
        assert megablock.tail_stats_smem(c, heads, bf16) <= mdta.SMEM_LIMIT
    with pytest.raises(ValueError, match="fits no tile"):
        megablock.tail_stats_tile(704, 1, bf16)
    assert megablock.tail_stats_slots(4, 256, 256, 48, 1, bf16) == 19 * 19
    d = 48
    per_slot = 4 * 4 * (d * d + 2 * d)
    assert megablock.tail_stats_slots(4, 256, 256, 48, 1) == 32 * 32
    big = megablock.tail_stats_slots(4, 4096, 4096, 48, 1)
    assert big * per_slot <= mdta.STATS_BUDGET < (big + 1) * per_slot
    with pytest.raises(ValueError, match="multiple of 4"):
        megablock.tail_stats(*[torch.zeros(1, 2, 2, 6)] * 2,
                             torch.zeros(1, 1, 6, 6),
                             *[torch.zeros(1)] * 10, 1)


class Spy:
    """Counts the calls of the kernel wrappers that run_stack reaches."""

    def __init__(self, monkeypatch):
        self.calls = {"mdta_stats": 0, "tail_stats": 0, "block_tail": 0}
        for name in self.calls:
            monkeypatch.setattr(blocks, name, self.wrap(name, getattr(blocks, name)))

    def wrap(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return call


def per_block_route(monkeypatch):
    """PromptIR's stacks run as the nn.Sequential of blocks."""
    monkeypatch.setattr(promptir_model, "run_stack",
                        lambda stack, xh, chain, remat=False:
                        blocks.nhwc(stack(blocks.nchw(xh))))


def test_run_stack_matches_per_block_route_and_jax(monkeypatch):
    x = np.random.default_rng(0).uniform(size=(2, 32, 48, 3)).astype(np.float32)
    jmodel = jax_create_model("promptir", **STACK)
    variables = init_variables(jmodel, 3, jnp.asarray(x))
    # jitted: within 1.8e-7 of the eager forward (a tenth of the bound is
    # 1e-5), 6.5 s against 31.9 s eager on the test host
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = create_model("promptir", device="cpu", fused_ffn=True, **STACK)
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    spy = Spy(monkeypatch)
    with torch.no_grad():
        y = model(xt)
    n = [len(getattr(model, s)) for s in STACKS]
    assert spy.calls == {"mdta_stats": 8 + 3, "tail_stats": sum(n) - 8,
                         "block_tail": 8 + 3}
    per_block_route(monkeypatch)
    with torch.no_grad():
        y_seq = model(xt)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-4, atol=1e-4)


def test_run_stack_under_autograd_runs_per_block(monkeypatch):
    torch.manual_seed(0)
    model = create_model("promptir", device="cpu", train=True, **STACK)
    spy = Spy(monkeypatch)
    x = torch.rand(1, 3, 16, 24)
    model(x).mean().backward()
    assert spy.calls == {"mdta_stats": 0, "tail_stats": 0, "block_tail": 0}
    assert all(p.grad is not None for p in model.encoder_level2.parameters())
    stack = model.encoder_level2
    xh = torch.rand(1, 8, 12, stack[0].norm1.body.weight.shape[0])
    with torch.no_grad():
        y = blocks.run_stack(stack, xh, chain=True)
    assert spy.calls == {"mdta_stats": 1, "tail_stats": len(stack) - 1,
                         "block_tail": 1}
    with torch.no_grad():
        y_seq = blocks.nhwc(stack(blocks.nchw(xh)))
    torch.testing.assert_close(y, y_seq, rtol=0, atol=0)


def test_promptir_chains_its_stacks_only_with_fused_ffn(monkeypatch):
    """By default every block of served PromptIR runs alone (mdta_stats,
    then block_tail: 47 of each at full depth); `fused_ffn=True` chains the
    level stacks through tail_stats (11 mdta_stats, 36 tail_stats, 11
    block_tail). Both give the same output."""
    torch.manual_seed(0)
    model = create_model("promptir", device="cpu", **STACK)
    assert model.fused_ffn is False
    n_blocks = sum(isinstance(m, blocks.TransformerBlock)
                   for m in model.modules())
    x = torch.rand(1, 3, 16, 24)
    spy = Spy(monkeypatch)
    with torch.no_grad():
        y = model(x)
    assert spy.calls == {"mdta_stats": n_blocks, "tail_stats": 0,
                         "block_tail": n_blocks}
    chained = create_model("promptir", device="cpu", fused_ffn=True, **STACK)
    chained.load_state_dict(model.state_dict(), strict=True)
    spy = Spy(monkeypatch)
    with torch.no_grad():
        y_chain = chained(x)
    n = sum(len(getattr(model, s)) for s in STACKS)
    assert spy.calls == {"mdta_stats": 8 + 3, "tail_stats": n - 8,
                         "block_tail": 8 + 3}
    torch.testing.assert_close(y_chain, y, rtol=1e-5, atol=1e-5)


def test_single_block_stack_takes_block_forward(monkeypatch):
    torch.manual_seed(0)
    model = create_model("promptir", device="cpu",
                         num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    spy = Spy(monkeypatch)
    xh = torch.rand(1, 8, 8, 48)
    with torch.no_grad():
        blocks.run_stack(model.encoder_level1, xh)
    assert spy.calls == {"mdta_stats": 1, "tail_stats": 0, "block_tail": 1}


def test_tail_stats_launches_inside_its_card(monkeypatch):
    """The wrapper's launch path with storage-less tensors and a recording
    library: one launch, inside the input's card, on its stream, with the
    tile, slots and shared memory of the Python side."""
    log = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            log.append(("enter", self.device))

        def __exit__(self, *exc):
            log.append(("exit", self.device))

    monkeypatch.setattr(build, "on_card_of", lambda t: Device(t.device))
    monkeypatch.setattr(build, "stream_of", lambda t: 9)
    monkeypatch.setattr(build, "check", lambda code, what: None)

    def function(name, argtypes, restype=None):
        if name == "block_tail_smem":
            return lambda dtype, c: 0
        if name == "tail_stats_smem":
            return lambda dtype, th, tw, c, d: megablock._smem(c, c // d,
                                                               (th, tw))
        assert len(argtypes) == 34  # the C signature of tail_stats_launch
        return lambda *args: log.append(("launch", name, args)) or 0

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(megablock.tail_stats, "launches", 0)
    dev = torch.device("meta")
    c, f, heads = 96, 255, 2

    def z(*s):
        return torch.zeros(*s, device=dev)

    x = z(2, 20, 30, c)
    x3, v2, stats = megablock.tail_stats(
        x, x, z(2, heads, c // heads, c // heads), z(c, c), z(c), z(c),
        z(2 * f, c), z(2 * f, 9), z(c, f), z(c), z(c), z(3 * c, c),
        z(3 * c, 9), heads)
    assert x3.shape == v2.shape == x.shape
    assert stats.shape == (2, heads, 48 * 48 + 96)
    (_, name, args), = [e for e in log if e[0] == "launch"]
    assert name == "tail_stats_launch" and args[-1] == 9
    assert args[20:31] == (2, 20, 30, c, heads, heads, f, 8, 8,
                           megablock.tail_stats_slots(2, 20, 30, c, heads), 0)
    assert args[-2] == megablock.tail_stats_smem(c, heads)
    assert log[0] == ("enter", dev) and log[-1] == ("exit", dev)
    assert megablock.tail_stats.launches == 1
