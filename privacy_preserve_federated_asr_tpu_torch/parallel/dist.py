"""Ranks, process groups and collectives of the port's parallel layer.

The JAX package runs every layout in one process over a ``jax.sharding.Mesh``;
the port runs one process (rank) per device under ``torch.distributed``:

  * ``init_distributed`` joins the process group a launcher set up through
    the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun``'s
    variables) and picks the rank's device: ``cuda:<LOCAL_RANK mod cards>``.
    The backend is NCCL where every rank has a card of its own, gloo on the
    CPU and where ranks share a card; the choice is printed.
  * ``launch_cli`` starts the ranks of a CLI command (one process each,
    ``python -m <package>.cli <argv>``), ``RankPool`` keeps a group of ranks
    alive and runs functions on all of them (the tests' workers).
  * ``DACS_RANKS_PER_DEVICE`` (default 1) places that many ranks on each
    device, as ``--xla_force_host_platform_device_count`` gives JAX more CPU
    devices; the device count every layout is checked against is the cards
    (or 1 for the CPU) times this number.

Collectives take tensors on the rank's device. Under gloo a CUDA tensor is
staged through the host (gloo's send/recv take CPU tensors only), and only
the collectives both backends provide are used: ``all_reduce``,
``broadcast``, list ``all_gather``, ``send``/``recv``; a reduce-scatter is an
all-reduce and a slice. The autograd-aware forms (``copy_to_group``,
``reduce_from_group``, ``gather_summed``, ``gather_identical``) carry the
gradients of tensor and sequence parallelism and of the output gathers.
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import traceback
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

RANKS_PER_DEVICE_ENV = "DACS_RANKS_PER_DEVICE"
_PACKAGE = __name__.rsplit(".", 2)[0]


def ranks_per_device() -> int:
    return max(int(os.environ.get(RANKS_PER_DEVICE_ENV, "1")), 1)


def device_count(device: str | torch.device) -> int:
    """Devices the layouts may place ranks on: the cards (or 1 CPU) times
    ``DACS_RANKS_PER_DEVICE``."""
    cards = (torch.cuda.device_count() if torch.device(device).type == "cuda" else 1)
    return cards * ranks_per_device()


def is_parallel() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_parallel() else 1


def rank() -> int:
    return dist.get_rank() if is_parallel() else 0


def in_launched_rank() -> bool:
    """True inside a process a launcher started (``WORLD_SIZE`` set)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device: torch.device) -> str:
    """NCCL when each rank of this node has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device: str | torch.device) -> torch.device:
    """The device of this rank: ``cuda`` becomes ``cuda:<LOCAL_RANK mod
    cards>``; an explicit index or the CPU stays."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def init_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Join the launcher's process group (once) and return this rank's
    device; a no-op outside a launched rank."""
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if is_parallel() or not in_launched_rank():
        return device
    backend = backend_for(device)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    if dist.get_rank() == 0:
        print(f"[dist] {dist.get_world_size()} ranks, backend {backend}, "
              f"{'one card each' if backend == 'nccl' else f'on {device.type}'}",
              flush=True)
    return device


def _rank_env(r: int, world: int, port: int, per_device: int) -> dict:
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), **{RANKS_PER_DEVICE_ENV: str(per_device)})
    return env


def launch_cli(argv: Sequence[str], world: int) -> int:
    """Run ``python -m <package>.cli argv`` as ``world`` ranks on this node and
    wait for them; returns the first nonzero exit code (0 if all passed)."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", f"{_PACKAGE}.cli", *argv],
                              env=_rank_env(r, world, port, ranks_per_device()))
             for r in range(world)]
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((rc for rc in rcs if rc), 0)


_RANK_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
             "MASTER_PORT", RANKS_PER_DEVICE_ENV)


def _join(r: int, world: int, port: int, device: str) -> None:
    """Leave the current process group and join a new one of ``world`` ranks
    (the ranks ``>= world`` join none)."""
    if is_parallel():
        dist.destroy_process_group()
    if r < world:
        os.environ.update({k: v for k, v in _rank_env(r, world, port, world).items()
                           if k in _RANK_ENV})
        init_distributed(device)


def _pool_worker(r: int, world: int, port: int, device: str, preload, conn) -> None:
    torch.set_num_threads(1)
    for module in preload:
        importlib.import_module(module)
    _join(r, world, port, device)
    while True:
        task = conn.recv()
        if task is None:
            break
        try:
            if task[0] == "join":
                conn.send(("ok", _join(r, *task[1:], device)))
                continue
            _, module, name, args, kwargs = task
            out = getattr(importlib.import_module(module), name)(*args, **kwargs)
            conn.send(("ok", out))
        except BaseException:  # noqa: BLE001 - handed to the caller
            conn.send(("error", traceback.format_exc()))
    os._exit(0)  # the group ends with its processes


class RankPool:
    """``world`` ranks in one process group (spawned processes, one torch
    thread each) that run ``fn(*args)`` together: :meth:`run` sends the same
    call to every rank and returns the ranks' results in rank order, or
    raises with the first failing rank's traceback; :meth:`run_on` runs it
    on the first ``n`` ranks only, in a process group of their own (the
    pool re-forms its group when ``n`` changes). A call that does not end
    within ``timeout`` seconds kills the pool. The ranks share the devices
    (``DACS_RANKS_PER_DEVICE`` is the group's size), start at once and
    import ``preload`` (module names) while the caller goes on. Use it as a
    context manager."""

    def __init__(self, world: int, device: str = "cpu", timeout: float = 120.0,
                 preload: Sequence[str] = ()):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = self.active = world
        self.timeout = timeout
        port = free_port()
        self.conns, self.procs = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_pool_worker,
                            args=(r, world, port, device, tuple(preload), child),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)

    def run(self, fn: Callable | str, *args, **kwargs) -> list[Any]:
        """``fn``: a module-level function, or ``"module:name"``."""
        return self.run_on(self.world, fn, *args, **kwargs)

    def run_on(self, n: int, fn: Callable | str, *args, **kwargs) -> list[Any]:
        """:meth:`run` on ranks ``0..n-1`` as a process group of ``n``."""
        if n != self.active:
            self._call(self.conns, ("join", n, free_port()), "join")
            self.active = n
        module, name = (fn.split(":") if isinstance(fn, str)
                        else (fn.__module__, fn.__qualname__))
        return self._call(self.conns[:n], ("call", module, name, args, kwargs),
                          f"{module}:{name}")

    def _call(self, conns, task, what: str) -> list[Any]:
        from multiprocessing.connection import wait

        for c in conns:
            c.send(task)
        out, pending = {}, list(conns)
        while pending:
            ready = wait(pending, self.timeout)
            if not ready:
                self.close(kill=True)
                raise TimeoutError(f"rank pool call {what} took over {self.timeout} s")
            for c in ready:  # a rank that fails ends the call at once
                status, value = c.recv()
                if status != "ok":
                    self.close(kill=True)
                    raise RuntimeError(f"rank pool call {what} failed on rank "
                                       f"{self.conns.index(c)}:\n{value}")
                out[self.conns.index(c)] = value
                pending.remove(c)
        return [out[self.conns.index(c)] for c in conns]

    def close(self, kill: bool = False) -> None:
        for c, p in zip(self.conns, self.procs):
            if p.is_alive() and not kill:
                try:
                    c.send(None)
                except OSError:
                    pass
        for p in self.procs:
            p.join(timeout=0 if kill else 5)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- collectives (gloo: CUDA tensors staged through the host) ----

def is_gloo(group=None) -> bool:
    return dist.get_backend(group) == "gloo"


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if t.is_cuda and is_gloo(group) else t


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM over ``group``; returns ``t``."""
    s = _staged(t, group)
    dist.all_reduce(s, group=group)
    if s is not t:
        t.copy_(s)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In place from global rank ``src``; returns ``t``."""
    s = _staged(t, group)
    dist.broadcast(s, src, group=group)
    if s is not t:
        t.copy_(s)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    group-rank order."""
    s = _staged(t.contiguous(), group)
    parts = [torch.empty_like(s) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, s, group=group)
    return torch.cat(parts, dim).to(t.device)


def all_gather_object(obj: Any, group=None) -> list:
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def send(t: torch.Tensor, dst: int) -> None:
    s = _staged(t.contiguous(), None)
    dist.send(s, dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor of ``like``'s shape and dtype from global rank ``src``, on
    ``like``'s device."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if is_gloo() else like.device)
    dist.recv(buf, src)
    return buf.to(like.device)


def group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank()) if group is not None else 0


def group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def _local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, SUM all-reduce of the gradient (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """SUM all-reduce forward, identity gradient (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the gradient is this rank's slice of the
    incoming gradient, SUM-reduced over the group first when ``summed``
    (each rank used the gathered tensor differently) and as it is otherwise
    (every rank computed the same thing from it)."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = all_reduce_(g.contiguous().clone(), ctx.group)
        return _local_slice(g, ctx.group, ctx.dim).contiguous(), None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_summed(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Gather.apply(x, group, dim, True)


def gather_identical(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Gather.apply(x, group, dim, False)


def flat_all_reduce_(tensors: Sequence[torch.Tensor], group) -> None:
    """SUM all-reduce of many tensors as one flat buffer, in place."""
    if not tensors or group_size(group) == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    torch._foreach_copy_(list(tensors), [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])

