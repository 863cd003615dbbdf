"""The (data, model) layout as process groups, and the rank launcher.

Counterpart of promptir_tpu/parallel/mesh.py. A JAX mesh lays devices out in
one process; here each device has a process of its own (a rank), and the
mesh is a pair of torch.distributed groups per rank:

  * `create_mesh(n_data, n_model, device)` inside a rank: rank
    `d * n_model + m` sits at (d, m), as `np.array(devices).reshape(n_data,
    n_model)` places device d * n_model + m (mesh.py:33-35). Its data group
    holds the ranks of its column (the batch is sharded over it), its model
    group those of its row. `n_data=None` takes every rank, as the JAX mesh
    takes every device (mesh.py:29-30); `data_size(None, device)` says how
    many ranks that is before any rank starts: every visible card, or one
    on the CPU.
  * `launch(fn, n, device, backend)` starts the ranks: `spawn`ed processes
    over a `file://` store in a temporary directory (no TCP port, so that
    concurrent runs never race for one), a deadline on the whole run and a
    `timeout` on every collective, every rank killed when one fails or the
    deadline passes, and the failing rank's traceback raised in the caller.

The backend follows the device: NCCL for tensors on a card, gloo on the CPU.
A caller may name another (`backend="gloo"` on the card runs two ranks on
one card, which NCCL refuses): an argument it chooses, never a fallback.
The port's collectives are written against `all_reduce` (and `broadcast`),
the two that gloo takes on CUDA tensors; `all_reduce_sum` counts the calls
and bytes that go through it.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) layout."""

    n_data: int
    n_model: int
    rank: int  # in the world
    data_group: Any  # a torch.distributed group, None in a lone process
    model_group: Any
    data_rank: int
    model_rank: int
    device: torch.device


def group_size(group) -> int:
    """Ranks in `group`; a lone process (group None) is a group of one."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def data_size(n_data: Optional[int], device, n_model: int = 1) -> int:
    """The data-parallel size that `n_data` asks for: itself, or with None
    every visible card (one rank on the CPU) over `n_model`."""
    if n_data is not None:
        return n_data
    if torch.device(device).type == "cuda":
        return max(1, torch.cuda.device_count() // n_model)
    return 1


def rank_device(device) -> torch.device:
    """This rank's device: the current card (`launch` makes a rank's card
    current before it runs), or the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                device="cuda") -> Mesh:
    """This rank's (data, model) groups. Every rank of the world calls it,
    in the same order as every other collective call (torch.distributed
    creates each group on all ranks). Outside a distributed run it returns
    the layout of one process, with no groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh(1, 1, 0, None, None, 0, 0, dev)
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group,
                rank // n_model, rank % n_model, dev)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place and return it; a lone process (group
    None) has nothing to do, a group of one still makes the call. Every
    collective of the port's parallel code goes through here or
    `broadcast`, and `all_reduce_sum.calls` and `.bytes` count them (the
    bytes of `t`, each call)."""
    if group is not None:
        all_reduce_sum.calls += 1
        all_reduce_sum.bytes += t.numel() * t.element_size()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


def broadcast(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite `tensors` in place with group rank `src`'s."""
    if group is not None:
        src = dist.get_global_rank(group, src)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


# ------------------------------------------------------------------ launch

def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_main(fn, args, rank, n, device_type, backend, store, timeout_s,
               share_card, threads, results):
    """The body of one spawned rank: its card, the process group, `fn`,
    and its result (or its traceback) handed to the parent."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(0 if share_card else rank)
        timeout = (None if timeout_s is None
                   else datetime.timedelta(seconds=timeout_s))
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=n, rank=rank,
            timeout=timeout)
        out = fn(*args)
        dist.destroy_process_group()
        results.put(("ok", rank, out))
    except BaseException:  # reported to the parent, which raises it
        results.put(("error", rank, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)  # a peer may still wait in a collective: no teardown


class RankError(RuntimeError):
    """A rank raised, died or outlived the deadline."""


def _last_words(results) -> str | None:
    """The error a dead rank put on the queue before it exited, if any."""
    try:
        while True:
            kind, rank, value = results.get(timeout=1.0)
            if kind == "error":
                return f"rank {rank} failed:\n{value}"
    except queue.Empty:
        return None


def launch(fn: Callable, n: int, device="cuda", backend: Optional[str] = None,
           args: tuple = (), timeout_s: Optional[float] = None,
           share_card: bool = False, threads: Optional[int] = None,
           store_dir: Optional[str] = None) -> list:
    """Run `fn(*args)` in `n` spawned ranks of one process group; return
    their results, by rank.

    `fn` and `args` are pickled (a module-level function). Rank r runs on
    card r (`device` "cuda"), or on the CPU; `share_card` puts every rank
    on card 0, which only a backend other than NCCL accepts. `n` larger
    than the visible cards raises: two ranks never share a card unless
    asked. `backend` defaults to `default_backend(device)`. `timeout_s`
    bounds the whole run and every collective (None: no deadline, and
    torch.distributed's default timeout); `threads` sets each rank's
    intra-op threads. The store lives in a fresh directory under
    `store_dir` (the system's temporary directory by default) and is
    removed at the end.
    """
    device_type = torch.device(device).type
    backend = backend or default_backend(device)
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if share_card and backend == "nccl" and n > 1:
            raise ValueError("NCCL refuses two ranks on one card: pass "
                             "backend='gloo' to share a card")
        if not share_card and n > cards:
            raise ValueError(f"{n} ranks need {n} cards; {cards} visible")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=store_dir)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, args, r, n, device_type, backend, os.path.join(tmp, "store"),
        timeout_s, share_card, threads, results)) for r in range(n)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            try:
                kind, rank, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RankError(_last_words(results) or (
                        f"rank {dead[0]} of {n} died with exit code "
                        f"{procs[dead[0]].exitcode}"))
                if deadline is not None and time.monotonic() > deadline:
                    raise RankError(f"{n} ranks of {fn.__name__} did not "
                                    f"finish within {timeout_s} s; ranks "
                                    f"done: {sorted(out)}")
                continue
            if kind == "error":
                raise RankError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(None if deadline is None
                   else max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]
