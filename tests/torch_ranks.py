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
from promptir_tpu_torch.parallel import halo, mesh, spatial, tp

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
