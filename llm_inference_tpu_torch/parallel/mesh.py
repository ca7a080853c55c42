"""Tensor-parallel groups over torch.distributed (counterpart of
`llm_inference_tpu/parallel/mesh.py`: make_mesh with
ShardingConfig(tensor=tp)).

The JAX package runs a tensor-parallel forward as one shard_map program
over a device mesh. The port runs one process per rank; each holds its
shard of the weights and of the KV cache (parallel/sharding.py) and runs
the same forward, joined by the two collectives of the JAX program:
`TPGroup.all_reduce_sum` (the psum of the row-sharded wo and down
products and of the vocab-sharded embedding rows) and
`TPGroup.all_gather_last` (the vocab-sharded logits). `run_ranks` starts
the ranks.

The backend follows a fixed rule (`backend_for`): NCCL when every rank
has a card of its own, gloo when the ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU. Gloo's collectives run on host
tensors here: a rank on a card stages every collective through a pinned
host buffer (the device work before it is synchronised, then the copy,
the collective and the copy back). Partial sums are added in float32 and
rounded once to the caller's dtype; JAX adds bf16 partials in bf16, which
at tp = 2 is the same value.

Every rank counts its collectives and their host wall time
(`collectives`, `collective_s`, the device sync before a staged
collective excluded), so a caller can split a step's time into the
ranks' own work and the collectives.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(tp: int, device) -> str:
    """"nccl" when every one of tp ranks on `device` gets a card of its
    own, "gloo" when they share one card or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class TPGroup:
    """One rank of a tensor-parallel group: its index, the group size, its
    device and backend, and the torch.distributed process group (None at
    size 1, where the collectives are identities)."""
    rank: int
    size: int
    device: torch.device
    backend: str = "none"
    group: Any = None
    collectives: int = 0
    collective_s: float = 0.0
    _pinned: Dict[int, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def staged(self) -> bool:
        """Whether collectives go through host memory (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, x32: torch.Tensor) -> torch.Tensor:
        """A pinned float32 host copy of x32 (the buffer is reused)."""
        n = x32.numel()
        buf = self._pinned.get(n)
        if buf is None:
            buf = torch.empty(n, dtype=torch.float32, pin_memory=True)
            self._pinned[n] = buf
        host = buf.view(x32.shape)
        host.copy_(x32)
        return host

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x, in float32, returned in x.dtype on
        x's device (every rank gets the same values)."""
        if self.size == 1:
            return x
        x32 = x.to(torch.float32, copy=True).contiguous()
        if self.staged:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            host = self._host(x32)
            dist.all_reduce(host, group=self.group)
            x32.copy_(host)
        else:
            t0 = time.perf_counter()
            dist.all_reduce(x32, group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return x32.to(x.dtype)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x concatenated along the last axis, in rank order."""
        if self.size == 1:
            return x
        src = x.contiguous()
        if self.staged:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            src = src.cpu()
        else:
            t0 = time.perf_counter()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=-1).to(x.device)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return out

    def broadcast_object(self, obj=None):
        """Rank 0's `obj` on every rank (a line of the CLI's REPL)."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def _init_rank(rank: int, tp: int, device, backend: str,
               init_method: str) -> TPGroup:
    dev = torch.device(device)
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        elif dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        # ranks on the CPU share its cores (oversubscribed thread pools
        # spin against each other)
        torch.set_num_threads(max(1, torch.get_num_threads() // tp))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=tp, rank=rank, timeout=_TIMEOUT)
    return TPGroup(rank=rank, size=tp, device=dev, backend=backend,
                   group=dist.group.WORLD)


def _rank_main(fn, rank, tp, device, backend, init_method, args, results):
    try:
        group = _init_rank(rank, tp, device, backend, init_method)
        out = fn(group, *args)
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, tp: int, *args, device="cuda",
              in_caller: bool = False) -> List[Any]:
    """fn(group, *args) on each of tp ranks, one process each (spawned,
    with a file:// rendezvous under a fresh temporary directory); returns
    the ranks' results in rank order. fn must be importable by the
    spawned processes (a module-level function) and return picklable
    host objects. `device` is "cuda" (a card index per rank under NCCL)
    or "cpu"; the backend follows backend_for's rule. With `in_caller`
    rank 0 runs in this process and ranks 1..tp-1 are spawned (the CLI's
    REPL stays in the process the user started). A rank that raises makes
    this raise with its traceback, after the other ranks are stopped."""
    backend = backend_for(tp, device)
    tmp = tempfile.mkdtemp(prefix="llmi_tp_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    first = 1 if in_caller else 0
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, tp, device, backend, init_method, args,
                               results))
             for r in range(first, tp)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        if in_caller:
            group = _init_rank(0, tp, device, backend, init_method)
            try:
                out[0] = fn(group, *args)
            finally:
                dist.destroy_process_group()
        pending = set(range(first, tp))
        while pending:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in zip(range(first, tp),
                                                        procs)
                        if r in pending and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"tensor-parallel ranks exited "
                                       f"without a result: {dead}")
                continue
            if not ok:
                raise RuntimeError(f"tensor-parallel rank {rank} failed:\n"
                                   f"{val}")
            out[rank] = val
            pending.discard(rank)
    except BaseException:
        for p in procs:              # ranks left waiting in a collective
            if p.is_alive():
                p.terminate()
        raise
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(tp)]
