"""Rank functions of the port's multi-rank CPU tests.

`promptir_tpu_torch.parallel.mesh.launch` pickles a rank's function by its
module and name, and every spawned rank imports that module: these import
torch, numpy and the port only (no JAX, no test module), so that a rank
starts in about a second. Each runs inside a gloo process group and
returns numpy arrays and numbers to the test.
"""

import time

import torch
import torch.distributed as dist

from promptir_tpu_torch import create_model
from promptir_tpu_torch.ops.conv import Conv
from promptir_tpu_torch.data.loader import rank_rows
from promptir_tpu_torch.parallel import data, halo, mesh, spatial, tp
from promptir_tpu_torch.tools.parity import Kinks, Routes

REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)


def world():
    return dist.group.WORLD


def reduced_promptir(state_path, **kw):
    model = create_model("promptir", device="cpu", **REDUCED, **kw)
    model.load_state_dict(torch.load(state_path, weights_only=True))
    return model.eval()


def spatial_rank(state_path, x, seed):
    """The sharded forward of reduced PromptIR on the global NHWC `x`, the
    all_reduce traffic it made, and each row primitive's and conv plan's
    max |difference| from its global counterpart on seeded data."""
    g = world()
    n, r = mesh.group_size(g), mesh.group_rank(g)
    model = reduced_promptir(state_path)
    calls, nbytes = mesh.all_reduce_sum.calls, mesh.all_reduce_sum.bytes
    y = spatial.spatial_sharded_apply(model, torch.from_numpy(x), g).numpy()
    traffic = (mesh.all_reduce_sum.calls - calls,
               mesh.all_reduce_sum.bytes - nbytes)
    return dict(forward=y, traffic=traffic, primitives=primitives(g, n, r, seed),
                convs=conv_plans(g, n, seed))


def primitives(g, n, r, seed):
    """{name: max |sharded - global|} of the row helpers."""
    gen = torch.Generator().manual_seed(seed)
    xg = torch.rand((2, 8 * n, 5, 3), generator=gen)
    xl = spatial.local_stripe(xg, g)
    hl = xg.shape[1] // n
    err = {}

    def put(name, got, want):
        err[name] = float((got - want).abs().max())

    zeros = torch.nn.functional.pad(xg, (0, 0, 0, 0, 2, 2))
    put("exchange_halo zeros", halo.exchange_halo(xl, 2, g),
        zeros[:, r * hl:r * hl + hl + 4])
    refl = torch.cat([xg[:, 1:3].flip(1), xg, xg[:, -3:-1].flip(1)], 1)
    put("exchange_halo reflect", halo.exchange_halo(xl, 2, g, "reflect"),
        refl[:, r * hl:r * hl + hl + 4])
    for shift in (3, -3):
        put(f"sharded_roll_h {shift}", spatial.sharded_roll_h(xl, shift, g),
            spatial.local_stripe(torch.roll(xg, shift, 1), g))
    put("gather_rows", spatial.gather_rows(xl, g), xg)
    put("slice_local_rows", spatial.slice_local_rows(xg, g), xl)
    with spatial.spatial_sharding(g):
        got = spatial.global_mean_hw(xl)
    put("global_mean_hw", got, xg.mean(dim=(1, 2), keepdim=True))
    xc = xg.permute(0, 3, 1, 2)
    out_hw = (12 * n, 7)
    want = torch.nn.functional.interpolate(xc, size=out_hw, mode="bilinear",
                                           align_corners=False)
    put("sharded_resize_bilinear", spatial.sharded_resize_bilinear(
        spatial.local_stripe(xc, g, 2), out_hw, g),
        spatial.local_stripe(want, g, 2))
    # the fixed-halo engine on a local net: two 3x3 convs see 2 rows a
    # side, so a halo of 2 is exact at the seams; at the image's top and
    # bottom the second conv reads the first's output on the zero halo
    # where the whole net reads its zero padding (halo.py's docstring), so
    # those 2 rows are left out
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                              torch.nn.GELU(),
                              torch.nn.Conv2d(4, 3, 3, padding=1))
    with torch.no_grad():
        got = halo.spatial_sharded_forward(net, xg, g, halo=2)
        want = net(xc).permute(0, 2, 3, 1)
    put("spatial_sharded_forward", got[:, 2:-2], want[:, 2:-2])
    return err


# the conv plans of ops/conv.py: (label, Conv arguments)
CONV_PLANS = {
    "stride 1 halo": dict(k=3),
    "stride 1 halo k5": dict(k=5),
    "stride == kernel local": dict(k=2, stride=2, padding=0),
    "strided k == s + 2p": dict(k=4, stride=2, padding=1),
    "gather": dict(k=3, stride=2, padding=1),
}


def conv_plans(g, n, seed):
    """{label: max |sharded - global|} of one Conv per plan on a stripe of
    an NCHW image 16 n rows tall; "gather rows that do not partition" is
    1.0 when that plan raised NotImplementedError."""
    torch.manual_seed(seed)
    xg = torch.randn(1, 4, 16 * n, 9)
    err = {}
    for label, kw in CONV_PLANS.items():
        kw = dict(kw)
        conv = Conv(4, 6, kw.pop("k"), bias=True, **kw)
        with torch.no_grad():
            want = spatial.local_stripe(conv(xg), g, 2)
            with spatial.spatial_sharding(g):
                got = conv(spatial.local_stripe(xg, g, 2))
        err[label] = float((got - want).abs().max())
    odd = Conv(4, 6, 3, stride=3, padding=1)  # 16 n rows -> ceil(16 n / 3)
    try:
        with torch.no_grad(), spatial.spatial_sharding(g):
            odd(spatial.local_stripe(xg, g, 2))
        err["gather rows that do not partition"] = 0.0
    except NotImplementedError:
        err["gather rows that do not partition"] = 1.0
    return err


def dp_rank(state_path, degraded, clean, grad_clip):
    """One data-parallel step of reduced PromptIR on this rank's rows of the
    global batch: (flat gradient after the all_reduce, logged loss, flat
    parameters after the update)."""
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    g = world()
    n, r = mesh.group_size(g), mesh.group_rank(g)
    model = create_model("promptir", device="cpu", train=True, **REDUCED)
    model.load_state_dict(torch.load(state_path, weights_only=True))
    st = TrainState(model, make_optimizer(model.parameters(), 1e-3),
                    grad_clip=grad_clip)
    b = degraded.shape[0] // n
    rows = slice(r * b, (r + 1) * b)
    batch = {"degraded": torch.from_numpy(degraded[rows]),
             "clean": torch.from_numpy(clean[rows])}
    step = make_train_step(model, group=g)
    # the gradient the update used: read it before AdamW moves the weights
    grads = []
    hook = st.optimizer.register_step_pre_hook(lambda *a: grads.append(
        torch.cat([p.grad.reshape(-1) for p in model.parameters()]).clone()))
    metrics = step(st, batch)
    hook.remove()
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return grads[0].numpy(), float(metrics["train_loss"]), params.numpy()


def mesh_rank(n_data, n_model):
    """(data rank, model rank, the world ranks of this rank's data group and
    of its model group), each group's found by an all_reduce of one-hots."""
    m = mesh.create_mesh(n_data, n_model, device="cpu")
    found = []
    for group in (m.data_group, m.model_group):
        onehot = torch.zeros(dist.get_world_size())
        onehot[m.rank] = 1.0
        mesh.all_reduce_sum(onehot, group)
        found.append(tuple(int(i) for i in onehot.nonzero().flatten()))
    return m.data_rank, m.model_rank, found[0], found[1]


def tiled_rank(state_path, img, kw):
    from promptir_tpu_torch.eval.tiling import tiled_inference

    model = reduced_promptir(state_path)
    with torch.inference_mode():
        return tiled_inference(model, torch.from_numpy(img), group=world(),
                               **kw).numpy()


def tp_rank(module_states, xs):
    """TP GDFN and MDTA of the given module states, each on its replicated
    NCHW input xs[label]: {label: output}."""
    from promptir_tpu_torch.ops.attention import MDTA
    from promptir_tpu_torch.ops.gdfn import GDFN

    g = world()
    out = {}
    for label, (kind, args, state) in module_states.items():
        mod = (GDFN if kind == "gdfn" else MDTA)(*args)
        mod.load_state_dict(state)
        apply = tp.tp_gdfn_apply if kind == "gdfn" else tp.tp_mdta_apply
        with torch.no_grad():
            out[label] = apply(mod, torch.from_numpy(xs[label]), g).numpy()
    return out


def fail_rank(bad):
    """Rank `bad` raises; the others wait in a collective it never joins."""
    if dist.get_rank() == bad:
        raise ValueError("rank failed on purpose")
    mesh.all_reduce_sum(torch.zeros(1), world())


def hang_rank():
    """Rank 1 never returns."""
    if dist.get_rank() == 1:
        time.sleep(3600)
    return dist.get_rank()


# ------------------------------------------------- the other eleven models

def load_case(path, label, train=False):
    """The model of case `label` from the states file `path` ({label:
    (name, kwargs, state dict)}), on the CPU."""
    name, kwargs, state = torch.load(path, weights_only=False)[label]
    model = create_model(name, device="cpu", train=train, **kwargs)
    model.load_state_dict(state)
    return model if train else model.eval()


def families_rank(states_path, inputs, labels, seed):
    """The sharded forward of each case of `labels` on its global NHWC
    input, with its traffic and routing ({label: (output, (all_reduce
    calls, bytes), windows kept a mixer call, images a selector call)}),
    and each op-level hook's max |sharded - global| (`ops`)."""
    g = world()
    out = {}
    for label in labels:
        model = load_case(states_path, label)
        calls, nbytes = mesh.all_reduce_sum.calls, mesh.all_reduce_sum.bytes
        with Routes() as routes:
            y = spatial.spatial_sharded_apply(
                model, torch.from_numpy(inputs[label]), g).numpy()
        out[label] = (y, (mesh.all_reduce_sum.calls - calls,
                          mesh.all_reduce_sum.bytes - nbytes),
                      routes.windows, routes.images)
    return out, family_ops(g, seed)


# the conv plans the families add: (label, Conv arguments)
FAMILY_CONV_PLANS = {
    "dilated halo": dict(k=3, padding=2, dilation=2),
    "dilated depthwise halo": dict(k=3, padding=2, dilation=2, groups=4),
    "dilated k5 halo": dict(k=5, padding=4, dilation=2),
}


def family_ops(g, seed):
    """{name: max |sharded - global|} of the families' op-level hooks on
    seeded data, each whole-image result computed in this rank."""
    from promptir_tpu_torch.ops.easy import NAFBlock
    from promptir_tpu_torch.ops.ocab import OCAB
    from promptir_tpu_torch.ops.window_attention import LeWinTransformerBlock

    n = mesh.group_size(g)
    torch.manual_seed(seed)
    err = {}

    def check(name, fn, xg, dim):
        """fn on the whole xg against fn on this rank's stripe, sharded."""
        with torch.no_grad():
            want = spatial.local_stripe(fn(xg), g, dim)
            with spatial.spatial_sharding(g):
                got = fn(spatial.local_stripe(xg, g, dim))
        err[name] = float((got - want).abs().max())

    for label, kw in FAMILY_CONV_PLANS.items():
        kw = dict(kw)
        conv = Conv(4, 8 if kw.get("groups") else 6, kw.pop("k"), bias=True,
                    **kw)
        check(f"conv {label}", conv, torch.randn(1, 4, 16 * n, 9), 2)
    ocab = OCAB(16, window_size=8, overlap_ratio=0.5, num_heads=2)
    check("ocab", ocab, torch.randn(1, 16 * n, 24, 16), 1)
    lewin = LeWinTransformerBlock(8, 2, win_size=4, shift_size=2)
    with torch.no_grad():  # a per-window modulator-free block, bias nonzero
        lewin.attn.relative_position_bias_table.normal_()
    check("lewin shift across a seam", lewin, torch.randn(1, 8 * n, 8, 8), 1)
    check("lewin gathered (a stripe thinner than a window)", lewin,
          torch.randn(1, 2 * n, 8, 8), 1)
    naf = NAFBlock(8, tlc_kernel=(8, 8))
    with torch.no_grad():  # beta and gamma 0 would make it the identity
        naf.beta.normal_()
        naf.gamma.normal_()
    check("tlc pool (NAFBlock, window 8 on 16 n rows)", naf,
          torch.randn(1, 8, 16 * n, 16), 2)
    naf.tlc_kernel = (16 * n, 16)
    check("tlc pool (NAFBlock, a window covering the image)", naf,
          torch.randn(1, 8, 16 * n, 16), 2)
    ca = create_model("capromptxrestormereff", device="cpu", dim=8,
                      num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    xg = torch.randn(1, 16 * n, 24, 8)
    for level in range(4):
        check(f"condition pyramid level {level + 1}",
              lambda x, level=level: ca.conditions(
                  x, spatial.global_rows(x.shape[1]), x.shape[2])[level],
              xg, 1)
    check("upscale_input x2", lambda x: spatial.upscale_input(x, 2),
          torch.rand(1, 3, 8 * n, 6), 2)
    return err


class Draws:
    """Records, while entered, every Gumbel draw (`gumbel_uniform`'s
    output, the global batch's) and the rows each mixer keeps of one
    (`batch_uniform`'s output)."""

    def __enter__(self):
        from promptir_tpu_torch.ops import camixer

        self.drawn, self.kept = [], []
        self._draw, self._keep = camixer.gumbel_uniform, camixer.batch_uniform

        def draw(*a, **kw):
            u = self._draw(*a, **kw)
            self.drawn.append(u.numpy().copy())
            return u

        def keep(*a, **kw):
            u = self._keep(*a, **kw)
            self.kept.append(u.numpy().copy())
            return u

        camixer.gumbel_uniform, camixer.batch_uniform = draw, keep
        return self

    def __exit__(self, *exc):
        from promptir_tpu_torch.ops import camixer

        camixer.gumbel_uniform, camixer.batch_uniform = self._draw, self._keep


def stochastic_step(model, batch, seed, group=None, grad_accum=1,
                    force=None, rows=(0, 1)):
    """One train step of `model` on `batch` ({"degraded", "clean"} numpy,
    this rank's rows, dealt by `grad_accum` microbatches) over `group`,
    under `Kinks(force, rows)` (tools/parity.py). Returns {"grad": the flat
    gradient the update used, "loss": the logged loss, "drawn": the Gumbel
    draws, "kept": the rows kept of them, "images": the images each
    selector call picked, "windows": the windows each mixer call kept,
    "mask_grads" and "label_grads": the gradient at each mask and each
    selector's labels, "sides": each kink op's sides (numpy), "flips" and
    "near": the elements whose side the forcing changed, call by call, and
    the largest distance from its kink among them}."""
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    st = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    grads = []
    hook = st.optimizer.register_step_pre_hook(lambda *a: grads.append(
        torch.cat([p.grad.reshape(-1) for p in model.parameters()]).clone()))
    step = make_train_step(model, grad_accum=grad_accum, seed=seed,
                           group=group)
    if force is not None:
        force = [tuple(torch.from_numpy(a) for a in call) for call in force]
    with Draws() as draws, Routes() as routes, Kinks(force, rows) as kinks:
        metrics = step(st, {k: torch.from_numpy(v) for k, v in batch.items()})
    hook.remove()
    return dict(grad=grads[0].numpy(), loss=float(metrics["train_loss"]),
                drawn=draws.drawn, kept=draws.kept, images=routes.images,
                windows=routes.windows, mask_grads=routes.mask_grads,
                label_grads=routes.label_grads,
                sides=[tuple(t.numpy() for t in call) for call in kinks.sides],
                flips=kinks.flips, near=kinks.near)


def data_ops(g, seed):
    """{name: error} of parallel/data.py's collectives on seeded data, each
    whole-batch result computed in this rank: the values of `batch_mean`
    and `gather_batch` against the global batch's mean and rows, and the
    gradient of the square of a batch mean (the ratio losses') and of a
    softmax over the gathered batch plus a mean over the rank's rows
    (CATA's selector and its L1 term), a rank's divided by n against the
    one-process gradient's rows, over the latter's max: the ranks' losses
    sum to n times the one-process loss, and the train step averages their
    gradients."""
    n, r = mesh.group_size(g), mesh.group_rank(g)
    gen = torch.Generator().manual_seed(seed)
    xg = torch.rand((3 * n, 5, 2), generator=gen)
    w = torch.rand((3 * n, 1), generator=gen)
    rows = slice(3 * r, 3 * r + 3)

    def mean_sq(x, wx):
        return (data.batch_mean(x.mean()) - 0.25) ** 2

    def softmax_over_batch(x, wx):
        lab = data.gather_batch(x.mean((1, 2))[:, None])
        return (lab.softmax(0) * w).sum() + (data.keep_rows(lab) * wx).mean()

    err = {}
    for name, f in (("batch_mean", mean_sq),
                    ("gather_batch", softmax_over_batch)):
        xa = xg.clone().requires_grad_()
        f(xa, w).backward()
        xl = xg[rows].clone().requires_grad_()
        with data.data_sharding(g):
            f(xl, w[rows]).backward()
        err[f"{name} gradient"] = float((xl.grad / n - xa.grad[rows]).abs().max()
                                        / xa.grad.abs().max())
    with data.data_sharding(g):
        err["batch_mean value"] = float(
            (data.batch_mean(xg[rows].mean()) - xg.mean()).abs())
        err["gather_batch value"] = float(
            (data.gather_batch(xg[rows]) - xg).abs().max())
    return err


def dp_stochastic_rank(states_path, batches, cases, seed, tiled):
    """The DP step of each case ({label: (grad_accum, the one-process
    step's kink sides)}) on this rank's rows of its global batch
    ({label: stochastic_step's dict}), data_ops' errors, and with `tiled`
    ((label, image, tiler arguments)) the sharded tiler's output."""
    from promptir_tpu_torch.eval.tiling import tiled_inference

    g = world()
    n, r = mesh.group_size(g), mesh.group_rank(g)
    out = {}
    for label, (accum, sides) in cases.items():
        batch = batches[label]
        mine = rank_rows(batch["degraded"].shape[0] // n, r, n, accum)
        out[label] = stochastic_step(
            load_case(states_path, label, train=True),
            {k: v[mine] for k, v in batch.items()}, seed, g, accum, sides,
            (r, n))
    tiles = None
    if tiled is not None:
        label, img, kw = tiled
        model = load_case(states_path, label)
        with torch.inference_mode(), Routes() as routes:
            y = tiled_inference(model, torch.from_numpy(img), group=g, **kw)
        tiles = (y.numpy(), routes.images)
    return out, tiles, data_ops(g, seed)
