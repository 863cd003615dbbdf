"""The frozen work counts (port_bench/counts/) against FlopCounterMode
over the plain reference's blocks at small shapes. The counts add the
elementwise work FlopCounterMode leaves out (the LayerNorms, the gates,
the softmax, the norms of q and k), which is taken off here."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import manifest
from port_bench.counts import flops, peaks, restormer_block, xblock
from port_bench.reference.layers import TransformerBlock, XTransformerBlock


def counted(module, x):
    with FlopCounterMode(display=False) as c, torch.no_grad():
        module(x)
    return c.get_total_flops()


@pytest.mark.parametrize("b,h,w,c,heads", [(2, 8, 12, 48, 1), (1, 16, 8, 96, 2),
                                           (3, 4, 4, 64, 4)])
def test_restormer_block_count(b, h, w, c, heads):
    f = int(c * 2.66)
    with torch.device("meta"):
        blk = TransformerBlock(c, heads)
        x = torch.zeros(b, c, h, w)
    ops, nbytes = restormer_block.work((b, h, w, c, heads, f))
    px = b * h * w
    assert ops - px * (20 * c + 10 * f) == counted(blk, x)
    assert nbytes >= 2 * 2 * px * c


@pytest.mark.parametrize("b,h,w,c,sp_heads", [(1, 16, 16, 48, 1),
                                              (2, 16, 24, 96, 2)])
def test_xblock_count(b, h, w, c, sp_heads):
    f = int(c * 2.66)
    with torch.device("meta"):
        blk = XTransformerBlock(c, 8, 0.5, 1, sp_heads, 16, 2.66)
        x = torch.zeros(b, c, h, w)
    rec = (b, h, w, c, 1, f, 8, 12, sp_heads, 16)
    ops, _ = xblock.work(rec)
    px = b * h * w
    logits = px * sp_heads * 12 * 12
    elementwise = px * (20 * c + 10 * f) + 16 * px * c + 5 * logits
    assert ops - elementwise == counted(blk, x)


def test_record_reads_the_port_call():
    from promptir_tpu_torch.models.blocks import TransformerBlock as PortBlock

    blk = PortBlock(48, 2)
    xh = torch.zeros(2, 8, 12, 48)
    rec = restormer_block.record((blk.norm1, blk.attn, blk.norm2, blk.ffn, xh),
                                 {})
    assert rec == (2, 8, 12, 48, 2, int(48 * 2.66))


def test_forward_flops_at_the_served_shapes():
    with open(manifest.HERE / "configs" / "promptir.json") as f:
        text = json.dumps(json.load(f), sort_keys=True)
    # 345.41 GFLOP at 256x256 (the port's cli/summary.py counts the same)
    assert abs(flops.forward_flops(text, 256, 256) / 1e9 - 345.411) < 0.01
    assert flops.forward_flops(text, 328, 488) > flops.forward_flops(text, 256, 256)


def test_bound_is_the_larger_of_the_two():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
