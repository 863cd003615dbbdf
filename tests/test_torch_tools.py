"""The instruments (promptir_tpu_torch/tools/) on the CPU at tiny sizes:
each prints its JSON line naming the device, refuses to run without a card
unless told `--device cpu`, and split_trace attributes a trace's ops to the
ranges that hold their launches. Also the bounded shift-mask cache."""

import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from promptir_tpu_torch.ops import window_attention
from promptir_tpu_torch.tools import (
    kbench,
    profile_forward,
    profile_train,
    sbench,
    shape_sweep,
    tbench,
)
from promptir_tpu_torch.tools.trace import (
    module_shares,
    profiled_ms,
    split_trace,
)
from test_torch_train import one_torch_thread  # noqa: F401 (a fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--num_blocks", "1", "1", "1", "1", "--num_refinement_blocks", "1"]
CPU = ["--device", "cpu"]


def printed(capsys):
    """The JSON lines the tool printed."""
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def train_trace(tmp_path_factory):
    """profile_train's line and trace directory for one reduced fp32 step."""
    out = tmp_path_factory.mktemp("profile_train")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line = profile_train.main([*TINY, *CPU, "--batch", "1", "--size", "16",
                                   "--dtype", "float32", "--iters", "1",
                                   "--out", str(out)])
    finally:
        torch.set_num_threads(n)
    return line, out


def test_profile_train_splits_a_step(train_trace):
    line, _ = train_trace
    assert line["tool"] == "profile_train" and line["device"] == "cpu"
    parts = line["parts_ms"]
    assert parts["forward_other"] > 0 and parts["backward"] > 0
    assert parts["optimizer"] > 0 and parts["forward_kernels"] == 0.0
    assert line["in_ranges"] >= 0.99


def test_split_trace_parts_sum_to_the_window(train_trace):
    """forward + backward + optimizer within 1% of all the step's ops."""
    _, out = train_trace
    for path in sorted(out.glob("window_*.json")):
        split = split_trace(path, profile_train.RANGES)
        assert not split["device"]
        parts = split["parts"]
        inside = sum(parts[k]["ms"] for k in ("forward", "backward",
                                              "optimizer"))
        assert abs(inside / split["busy_ms"] - 1) <= 0.01
        assert parts["backward"]["ops"] > 0


def test_profile_train_parses_a_trace_directory(train_trace, capsys):
    _, out = train_trace
    line = profile_train.main(["--parse", str(out)])
    assert line["device"] == "cpu" and line["steps"] == 1
    assert printed(capsys)[-1]["parts_ms"] == line["parts_ms"]


def trace_of(events):
    return {"traceEvents": [dict(ph="X", pid=1, **e) for e in events]}


def test_split_trace_places_kernels_by_their_launch():
    """A kernel goes to the innermost named range holding its launch on the
    launching thread (ctypes launches have no aten op above them); a launch
    in no range is "(outside)"; the idle share is the window's gaps."""
    host = [
        dict(cat="user_annotation", name="forward", tid=1, ts=0, dur=100),
        dict(cat="user_annotation", name="module:latent", tid=1, ts=10, dur=20),
        dict(cat="cpu_op", name="autograd::engine::evaluate_function: X",
             tid=2, ts=200, dur=50),
    ]
    launches = [(1, 15, 1), (1, 50, 2), (2, 210, 3), (1, 300, 4)]
    for tid, ts, corr in launches:
        host.append(dict(cat="cuda_runtime", name="cudaLaunchKernel", tid=tid,
                         ts=ts, dur=5, args={"correlation": corr}))
    kernels = [dict(cat="kernel", name=f"k{c}", tid=7, ts=100 * c, dur=10 * c,
                    args={"correlation": c}) for c in (1, 2, 3, 4)]
    split = split_trace(trace_of(host + kernels), {
        "forward": "forward", "latent": "module:latent",
        "backward": "autograd::engine::evaluate_function:"})
    parts = split["parts"]
    assert split["device"] and split["ops"] == 4
    assert [parts[k]["top"][0][0] for k in ("latent", "forward", "backward",
                                            "(outside)")] == ["k1", "k2", "k3",
                                                              "k4"]
    assert split["busy_ms"] == pytest.approx(0.1)
    assert split["window_ms"] == pytest.approx(0.34)
    assert split["idle"] == pytest.approx(1 - 0.1 / 0.34)


def test_profile_forward_splits_by_module(one_torch_thread, capsys):
    line = profile_forward.main([*TINY, *CPU, "--batch", "1", "--size", "16",
                                 "--dtype", "float32", "--iters", "1"])
    assert printed(capsys)[-1] == json.loads(json.dumps(line))
    assert line["device"] == "cpu" and line["in_ranges"] == 1.0
    for group in ("levels", "refinement", "prompts", "noise_blocks"):
        assert line["groups_ms"][group] > 0, group
    assert {"encoder_level1", "latent", "noise_level3",
            "prompt2"} <= set(line["modules"])


@pytest.mark.parametrize("op", kbench.KERNELS)
def test_kbench_times_each_kernel(one_torch_thread, capsys, op):
    line = kbench.main(["--op", op, "--shape", "2", "16", "16", "48",
                        "--heads", "2", "--reps", "2", "--warmup", "1",
                        "--dtype", "float32", *CPU])
    assert printed(capsys) == [json.loads(json.dumps(line))]
    assert line["device"] == "cpu" and line["ms"] > 0 and line["bound_ms"] > 0
    assert (line["library_ms"] is None) == (op not in ("mdta_gram", "seam"))


def test_kbench_bound_is_phase_9s():
    """block_tail at B4 256x256 C48 bf16: the operations of the smoke's
    phase 9 (chip_smoke.py reads block_work from here)."""
    (_, _), (ops, nbytes) = kbench.block_work((256, 256, 48, 1), 2, 4)
    f, px = int(48 * 2.66), 4 * 256 * 256
    assert ops == 2 * px * (48 * 48 + 48 * 48 + 2 * f * 48 + 18 * f + f * 48) \
        + px * (8 * 48 + 10 * f)
    b, by = kbench.bound_ms(ops, nbytes, torch.bfloat16)
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / 989e12 * 1e3
    assert b == pytest.approx(max(t_bytes, t_ops))
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


def test_tbench_reports_a_step(one_torch_thread):
    line = tbench.main([*TINY, *CPU, "--batch", "1", "--size", "16",
                        "--dtype", "float32", "--steps", "2", "--warmup", "1"])
    assert line["device"] == "cpu" and line["peak_memory_gib"] is None
    assert line["images_per_s"] == pytest.approx(1e3 / line["step_ms"])


def test_sbench_serves_two_buckets(one_torch_thread):
    line = sbench.main([*TINY, *CPU, "--size", "16", "--size2", "24",
                        "--clients", "2", "--seconds", "1", "--max_batch", "2",
                        "--dtype", "float32"])
    assert line["device"] == "cpu" and line["completed"] > 0
    assert line["latency_ms"]["p99_samples"] == line["completed"]
    assert line["rejected"] == line["timed_out"] == line["errors"] == 0
    assert 1 - 1e-9 <= line["mean_batch_fill"] <= 2 + 1e-9  # a float mean


def test_shape_sweep_holds_every_kernel(one_torch_thread, capsys):
    lines = shape_sweep.main(["--sizes", "16", "--batch", "1", *CPU,
                              "--num_blocks", "1", "1", "1", "2"])
    assert printed(capsys)[-1] == {"tool": "shape_sweep", "device": "cpu",
                                   "sweep": 1, "failures": 0}
    runs = lines[0]["runs"]
    assert set(runs) == {"block float32", "block bfloat16", "chained float32",
                         "chained bfloat16"}
    assert set(runs["chained float32"]["kernels"]) == {
        "mdta_stats", "block_tail", "tail_stats", "seam"}


def swapped(route):
    """{(module, name): what `route` puts there} over the port's modules
    (an autograd Function's stand-in by its `apply`)."""
    with route():  # import what it swaps
        pass
    mods = [m for n, m in sorted(sys.modules.items())
            if n.startswith("promptir_tpu_torch")]
    before = {(m.__name__, k): v for m in mods for k, v in vars(m).items()}
    with route():
        inside = {(m.__name__, k): v for m in mods for k, v in vars(m).items()}
    return {key: getattr(v, "apply", v) for key, v in inside.items()
            if before.get(key) is not v}


def test_shape_sweep_plain_route_is_the_smokes():
    """The sweep's reference route swaps what chip_smoke.py's own does (the
    smoke keeps its copy, so that it runs on a checkout without tools/)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ours = swapped(shape_sweep.plain_route)
    assert len(ours) == 8 and swapped(smoke.plain_route) == ours


def test_module_shares_and_profiled_ms_read_the_split(one_torch_thread):
    """The key_averages-free views of traced_split, on the CPU's ops: each
    module's range gets its own ops, and profiled_ms is the same window's
    busy time a call."""
    lin, conv = torch.nn.Linear(64, 64), torch.nn.Conv2d(4, 4, 3)
    x, y = torch.rand(256, 64), torch.rand(2, 4, 32, 32)

    def fn():
        with torch.no_grad():
            return lin(x), conv(y)

    cpu = torch.device("cpu")
    text = module_shares(fn, {"linear": (torch.nn.Linear, "forward"),
                              "conv": (torch.nn.Conv2d, "forward")},
                         device=cpu)
    assert text.startswith("device time by module over 2 calls: linear ")
    shares = [float(part.split("(")[1].split("%")[0])
              for part in text.split(": ", 1)[1].split("; ")[:2]]
    assert all(v > 0 for v in shares) and sum(shares) == pytest.approx(
        100, abs=0.2)
    assert profiled_ms(fn, reps=2, device=cpu) > 0


TOOL_ARGS = [(kbench, []), (profile_forward, []), (profile_train, []),
             (tbench, []), (sbench, []), (shape_sweep, [])]


@pytest.mark.parametrize("tool,args", TOOL_ARGS,
                         ids=[t.__name__.rsplit(".", 1)[-1] for t, _ in TOOL_ARGS])
def test_tools_refuse_to_run_without_a_card(tool, args):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(args)


def test_shift_mask_cache_is_bounded():
    """SHIFT_MASKS distinct shapes fit; one more evicts the oldest."""
    window_attention.shift_mask.cache_clear()
    cpu = torch.device("cpu")
    shapes = [(16 * (i + 1), 16, 8, 4) for i in range(
        window_attention.SHIFT_MASKS + 1)]
    first = window_attention.shift_mask(*shapes[0], cpu)
    for s in shapes[1:-1]:
        window_attention.shift_mask(*s, cpu)
    assert window_attention.shift_mask(*shapes[0], cpu) is first  # kept
    for s in shapes[1:]:  # the 17th shape: shapes[0] is now the oldest
        window_attention.shift_mask(*s, cpu)
    info = window_attention.shift_mask.cache_info()
    assert info.currsize == window_attention.SHIFT_MASKS == info.maxsize
    assert window_attention.shift_mask(*shapes[0], cpu) is not first
    window_attention.shift_mask.cache_clear()
