"""Holding a distributed run of the port against its one-process run.

A data-parallel step over n ranks (parallel/data.py) or an H-sharded
forward (parallel/spatial.py) computes what one process computes on the
whole batch or image, in another summation order. `tests/torch_ranks.py`
and `chip_smoke.py` hold the two against each other with these parts:

  * `Routes` records what the CAMixers route: the windows each mixer call
    keeps and the images each branch selector call picks, and, where the
    forward is differentiated, the gradient reaching each mixer's mask and
    each selector's labels before they are gathered over a data group
    (`gather_batch`), the quantities whose batch means and choices
    parallel/data.py makes global;
  * `grad_errors` gives each parameter's max |grad - ref| over its own
    max |ref|, or over FLOOR of the median parameter's where that is
    smaller (a cancelling sum, which float32 rounds by ~1e-3 of itself);
    a parameter whose gradient is zero in exact arithmetic or to first
    order (ZERO_IN_EXACT_ARITHMETIC) is held over the median's; `tap_errors`
    holds the gradients `Routes` records alike;
  * `Kinks` records the side of its kink that each element of every
    piecewise-linear op's input lies on (`F.leaky_relu`'s sign, flow_warp's
    sample cell and clipping, the sign of each output's error in the train
    step's L1 loss), and, given an earlier recording of the global batch,
    takes that recording's sides on this rank's rows. Two summation orders
    can put an input that lies within rounding of a kink on its two sides,
    and one such element moves a weight's gradient by its whole term (0.9
    of it for LeakyReLU(0.1)): a discontinuity of the gradient, not an
    error of either run. Forcing the sides removes exactly those terms and
    leaves everything else to be compared; the flips counted say how many
    there were and how close to its kink each lay (KINK_NEAR).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the parameters whose gradient is zero in exact arithmetic, or to first
# order, so that either run's is rounding alone: CAMixer v1's project_k
# bias (a constant added to every key of a window shifts each query's
# logits alike, which the softmax ignores; ~1e-11 against a median
# tensor's ~1.6e-5) and the branch selector's classifier bias (it shifts
# every image's logit alike, which the Gumbel softmax over the batch
# ignores but for the spread of the sigmoid's slopes: 1e-6 to 2e-4 of the
# median tensor's, what is left of a cancelling sum over the batch, whose
# terms are the gradient at the labels that `Routes` records)
ZERO_IN_EXACT_ARITHMETIC = ("project_k.bias", "classifier.0.bias")


# how far from its kink an element whose side two runs disagree on may
# lie: float32 rounding of a sum of O(1) terms, or of a position below 128
KINK_NEAR = 1e-4

# a tensor whose max |gradient| is below this share of the median tensor's
# is held over that share: its gradient is what is left of a sum that
# cancels (a branch selector's, whose labels enter the loss through a
# softmax over the batch), and float32 rounds it in another summation
# order by ~1e-3 of itself
FLOOR = 1e-2


def grad_errors(grads, ref) -> dict:
    """{parameter: max |grads[p] - ref[p]| / max |ref[p]|} over two dicts
    of arrays or tensors by name; the divisor is at least FLOOR of the
    median parameter's max |ref|, and the median's itself for a parameter
    of ZERO_IN_EXACT_ARITHMETIC."""
    assert grads.keys() == ref.keys()
    peak = {k: float(np.abs(np.asarray(v)).max()) for k, v in ref.items()}
    median = float(np.median(list(peak.values())))
    return {k: float(np.abs(np.asarray(grads[k]) - np.asarray(ref[k])).max())
            / (median if k.endswith(ZERO_IN_EXACT_ARITHMETIC)
               else max(peak[k], FLOOR * median))
            for k in ref}


def tap_errors(got, ref, rank: int, ranks: int) -> float:
    """The largest error, call by call, of a rank's gradients at a tap
    (`Routes.mask_grads` or `label_grads`) over `ranks` (the ranks' losses
    sum to `ranks` times the one-process loss) against this rank's rows of
    the one-process gradients: over the call's max |ref|, or FLOOR of the
    largest call's where that is smaller, as `grad_errors` floors a
    parameter."""
    if len(got) != len(ref):
        raise ValueError(f"{len(got)} taps against {len(ref)}")
    top = max((float(np.abs(b).max()) for b in ref), default=0.0)
    worst = 0.0
    for a, b in zip(got, ref):
        rows = b.shape[0] // ranks
        err = np.abs(a / ranks - b[rank * rows:(rank + 1) * rows]).max()
        worst = max(worst, float(err) / max(float(np.abs(b).max()),
                                            FLOOR * top))
    return worst


def named_grads(model, flat) -> dict:
    """A flat gradient (the parameters' in order) as {name: numpy array}."""
    flat = torch.as_tensor(flat)
    out, i = {}, 0
    for name, p in model.named_parameters():
        out[name] = flat[i:i + p.numel()].detach().cpu().numpy()
        i += p.numel()
    return out


class Routes:
    """Records, while entered, the windows each CAMixer call keeps (how
    many: the entries of its mask above 1/2, which in training are 1 or 0
    plus a rounding of the straight-through sample) and the images each
    branch selector call picks (which: a 0/1 tuple of its batch). Where
    the forward is differentiated, `mask_grads` and `label_grads` receive,
    in the forward's call order, the gradient reaching each mask and each
    selector's labels before `gather_batch` (numpy)."""

    def __enter__(self):
        from promptir_tpu_torch.ops import camixer

        self.windows, self.images = [], []
        self.mask_grads, self.label_grads = [], []
        self._saved = (camixer.route_mask, camixer.BranchSelector.forward,
                       camixer.gather_batch)
        route_mask, select, gather = self._saved

        def tap(t, into):
            if t.requires_grad:
                into.append(None)
                i = len(into) - 1

                def hook(g):
                    into[i] = g.detach().float().cpu().numpy()

                t.register_hook(hook)

        def route(*a, **kw):
            mask = route_mask(*a, **kw)
            self.windows.append(int((mask.detach() > 0.5).sum()))
            tap(mask, self.mask_grads)
            return mask

        def selector(sel, *a, **kw):
            label = select(sel, *a, **kw)
            self.images.append(tuple(int(v) for v in label.detach() > 0.5))
            return label

        def gather_labels(t):
            tap(t, self.label_grads)
            return gather(t)

        (camixer.route_mask, camixer.BranchSelector.forward,
         camixer.gather_batch) = route, selector, gather_labels
        return self

    def __exit__(self, *exc):
        from promptir_tpu_torch.ops import camixer

        (camixer.route_mask, camixer.BranchSelector.forward,
         camixer.gather_batch) = self._saved


class Kinks:
    """Records, while entered, the side of its kink of every element of
    each piecewise-linear op's input, call by call in `sides`: x > 0 for
    F.leaky_relu (the routers', the selectors', the Uformers' input
    projection's); for CAMixer v1's flow_warp each sample's cell
    (the floor of its clipped position) and whether the position lies in
    the image, where clipping passes its gradient; for the train step's
    L1 loss the sign of each output's error (train/step.py:l1_loss; an
    output within rounding of its target flips the sign of its term's
    gradient).

    With `force` (the `sides` of an earlier run of the same forward on the
    global batch) and `rows` ((rank, ranks): this rank holds that share of
    the batch's rows), `flips` counts, call by call, the elements of this
    rank's rows whose own side differs from the recorded one, and `near`
    gives the largest |input| (for flow_warp, the largest distance of a
    position from its nearest integer) among them; with `apply` each op
    also takes the recorded side instead of its own. Forcing changes the
    forward by at most that input's size at a flipped element and the
    gradient by the element's term."""

    def __init__(self, force=None, rows=(0, 1), apply=True):
        self.force, self.rows = force, rows
        self.apply = apply and force is not None
        self.sides, self.flips, self.near = [], [], []

    def _take(self, own, dist):
        """Record `own` (a tuple of tensors), count its flips; return the
        forced sides, or `own` when nothing is applied. `dist` holds, for
        each of `own`, each element's distance from its kink."""
        self.sides.append(tuple(t.detach() for t in own))
        if self.force is None:
            return own
        rank, ranks = self.rows
        want = []
        for o, f in zip(own, self.force[len(self.sides) - 1]):
            b = f.shape[0] // ranks
            f = f[rank * b:(rank + 1) * b].to(o.device)
            if f.shape != o.shape:
                raise ValueError(f"kink call {len(self.sides) - 1}: recorded "
                                 f"{tuple(f.shape)}, this run {tuple(o.shape)}")
            want.append(f)
        flips = [o != f for o, f in zip(own, want)]
        self.flips.append(int(torch.stack(flips).any(0).sum()))
        self.near.append(max((float(d[f].max()) for d, f in zip(dist, flips)
                              if f.any()), default=0.0))
        return tuple(want) if self.apply else own

    def __enter__(self):
        from promptir_tpu_torch.ops import camixer
        from promptir_tpu_torch.ops.flow_warp import bilinear, sample_points
        from promptir_tpu_torch.train import step

        self._saved = (F.leaky_relu, camixer.flow_warp, step.l1_loss)
        leaky_relu, _, l1_loss = self._saved

        def leaky(x, negative_slope=0.01, inplace=False):
            (pos,) = self._take((x > 0,), (x.detach().abs(),))
            if not self.apply:
                return leaky_relu(x, negative_slope, inplace)
            return torch.where(pos, x, x * negative_slope)

        def warp(x, flow):
            _, h, w, _ = x.shape
            rx, ry = sample_points(flow, h, w)
            px, py = rx.clamp(0.0, w - 1.0), ry.clamp(0.0, h - 1.0)
            own = ((rx >= 0) & (rx <= w - 1), (ry >= 0) & (ry <= h - 1),
                   px.floor().long(), py.floor().long())
            dx, dy = ((t - t.round()).abs().detach() for t in (rx, ry))
            inx, iny, x0, y0 = self._take(own, (dx, dy, dx, dy))
            # where the recording lies in the image, the unclipped position
            # carries the gradient, as clipping passes it there
            px = torch.where(inx, rx, px.detach())
            py = torch.where(iny, ry, py.detach())
            return bilinear(x, px, py, x0, y0)

        def l1(pred, target):
            d = pred.float() - target.float()
            (sign,) = self._take((torch.sign(d.detach()).to(torch.int8),),
                                 (d.detach().abs(),))
            if not self.apply:
                return l1_loss(pred, target)
            return (d * sign).mean()

        F.leaky_relu, camixer.flow_warp, step.l1_loss = leaky, warp, l1
        return self

    def __exit__(self, *exc):
        from promptir_tpu_torch.ops import camixer
        from promptir_tpu_torch.train import step

        F.leaky_relu, camixer.flow_warp, step.l1_loss = self._saved
