"""The peer group of the sharded runtime: one process per peer (what the
reference passes as a mesh and an ``axis_name``).

``PeerGroup`` is a rank's view of the K processes of a run: its ``rank``,
the world ``size`` K and its ``device``, with

- ``exchange(block, lanes)``: the reference's ``gather_peer_leaf`` for one
  (1, ...) block: one send and one receive a rank per ``graph.PermLane``;
  returns the (K, ...) stack holding this rank's row, the rows it received,
  and zeros where it hears from no one;
- ``all_gather(t)`` -> (K, ...) in rank order, ``all_reduce(t)`` (the sum in
  rank order, the same bits on every rank) and ``barrier()``;
- ``ring_shift(t)``: the reference's ``ppermute`` around the ring, which the
  hierarchical runtime's ring gather streams blocks with: every rank sends
  its tensor to rank - 1 and receives rank + 1's (mod the size).

A rank of the hierarchical runtime holds a block of p peers, so ``size`` is
K / p there.

Two transports, chosen by the caller (``spawn_peers`` takes the one of its
device) and never by a fallback:

- ``"gloo"``, on the CPU: ``torch.distributed`` over gloo, one
  ``batch_isend_irecv`` a lane an exchange;
- ``"cuda_ipc"``, K ranks on ONE card.  NCCL refuses two ranks on one device
  and gloo has no CUDA send / receive, so the launcher allocates each rank's
  inbox on the card, (2, K, slot) bytes, and hands every inbox to every rank
  through ``torch.multiprocessing``'s CUDA IPC.  A send is a device copy of
  the row into slot [sender] of the receiver's inbox; the sender's stream is
  synchronized and a gloo barrier on the host orders the copies before any
  receiver reads its slots.  The inboxes are double-buffered by call (a call
  writes buffer ``n % 2``): a rank overwrites a slot only after every rank
  has passed the barrier of the next call, by which point every read of the
  previous use of that buffer has completed (each rank synchronizes its
  stream before that barrier).  ``all_gather`` is the same copy to every
  rank.  A ring shift hears from one rank only, so it has inboxes of its
  own, (2, 1, ring slot) bytes a rank and double-buffered the same way:
  the slot holds a whole block of p rows (408 MB at K = 4096 over 8 ranks),
  which the (2, K / p, slot) all-gather inbox would hold K / p times over.
  Each inbox is sized by what goes through it (``spawn_peers``'
  ``inbox_bytes`` and ``ring_bytes``).  Rows never leave the device.

``spawn_peers(fn, K, device, ...)`` starts the K ranks (``spawn``), gives each
a ``PeerGroup`` and returns what each rank's ``fn(group, *args)`` returned.
The rendezvous is a ``file://`` store in a temporary directory (no port to
collide on), every process group has a timeout, and the parent joins with a
deadline: a rank that raises makes ``spawn_peers`` raise, and a rank that
hangs makes it raise ``TimeoutError`` within the group's timeout of the first
exit (the others fail at their next collective within the timeout).  Each
rank runs one CPU thread with TF32 off; on a card the parent builds the
consensus kernels first, so the ranks load them and none runs ``nvcc``.
"""
from __future__ import annotations

import datetime
import gc
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from repro_torch import pytree

BACKENDS = ("gloo", "cuda_ipc")
TIMEOUT_SECONDS = 60.0  # every process group's, and the parent's grace after a first exit


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's storage as a flat uint8 view (a contiguous copy if needed)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def exchange_destinations(lanes, rank: int) -> list[int]:
    """The ranks ``rank`` sends its row to in an exchange along ``lanes``
    (one send a lane that names it as a source)."""
    return [dst for lane in lanes for src, dst in lane.perm if src == rank]


class PeerGroup:
    """A rank of a run of K processes, one peer each (see the module)."""

    def __init__(self, rank: int, size: int, device: torch.device | str, backend: str,
                 inboxes: Sequence[torch.Tensor] | None = None,
                 ring_inboxes: Sequence[torch.Tensor] | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        if backend == "gloo" and self.device.type != "cpu":
            raise ValueError("the gloo transport carries CPU tensors; K ranks on a card take "
                             "'cuda_ipc'")
        if backend == "cuda_ipc":
            if self.device.type != "cuda":
                raise ValueError("the cuda_ipc transport carries CUDA tensors")
            if inboxes is None or len(inboxes) != self.size:
                raise ValueError("cuda_ipc needs every rank's inbox")
        self.inboxes, self.ring_inboxes = inboxes, ring_inboxes
        self._calls = 0  # cuda_ipc: the buffer of the next call is _calls % 2
        self._shifts = 0  # the same for the ring inboxes
        # exchange(), all_gather() and ring_shift() calls, their host seconds
        # (copies, syncs and barriers), the bytes this rank sent in exchanges
        # and in shifts
        self.stats = {"exchanges": 0, "exchange_seconds": 0.0, "bytes_sent": 0,
                      "gathers": 0, "gather_seconds": 0.0, "shifts": 0, "shift_seconds": 0.0,
                      "shift_bytes": 0}

    # -- the cuda_ipc transport ---------------------------------------------

    def _post(self, payload: torch.Tensor, dsts: Sequence[int]) -> int:
        """Copy ``payload`` into slot [rank] of each destination's inbox and
        wait until every rank has posted; returns the buffer used."""
        buf = self._calls % 2
        self._calls += 1
        raw = _as_bytes(payload)
        n = raw.numel()
        slot = self.inboxes[0].shape[-1]
        if n > slot:
            raise ValueError(f"a {n}-byte row does not fit the {slot}-byte inbox slots "
                             "(spawn_peers(inbox_bytes=...))")
        for dst in dsts:
            self.inboxes[dst][buf, self.rank, :n].copy_(raw)
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier()
        return buf

    def _read(self, buf: int, src: int, out: torch.Tensor) -> None:
        raw = out.view(-1).view(torch.uint8)
        raw.copy_(self.inboxes[self.rank][buf, src, :raw.numel()])

    # -- the collectives ------------------------------------------------------

    def exchange(self, block: torch.Tensor, lanes) -> torch.Tensor:
        """(1, ...) block -> (K, ...) stack: this rank's row at its index,
        each in-neighbor's row (one per lane that names one) at its index,
        zeros elsewhere (the reference's ``gather_peer_leaf``)."""
        if block.shape[0] != 1:
            raise ValueError(f"exchange takes a (1, ...) block, got {tuple(block.shape)}")
        start = time.perf_counter()
        k = self.size
        full = block.new_zeros((k, *block.shape[1:]))
        full[self.rank] = block[0]
        dsts = exchange_destinations(lanes, self.rank)
        srcs = [lane.src_for_dst[self.rank] for lane in lanes
                if lane.src_for_dst[self.rank] != k]
        if self.backend == "cuda_ipc":
            buf = self._post(block, dsts)
            for src in srcs:
                self._read(buf, src, full[src])
        else:
            row = block[0].contiguous()
            for lane in lanes:
                ops = [dist.P2POp(dist.isend, row, dst) for src, dst in lane.perm
                       if src == self.rank]
                src = lane.src_for_dst[self.rank]
                if src != k:
                    ops.append(dist.P2POp(dist.irecv, full[src], src))
                if ops:
                    for req in dist.batch_isend_irecv(ops):
                        req.wait()
        self.stats["exchanges"] += 1
        self.stats["exchange_seconds"] += time.perf_counter() - start
        self.stats["bytes_sent"] += len(dsts) * block.numel() * block.element_size()
        return full

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(...) on every rank -> (K, ...), row r from rank r."""
        start = time.perf_counter()
        out = t.new_empty((self.size, *t.shape))
        if self.backend == "cuda_ipc":
            buf = self._post(t, range(self.size))
            for src in range(self.size):
                self._read(buf, src, out[src])
        else:
            dist.all_gather(list(out.unbind(0)), t.contiguous())
        self.stats["gathers"] += 1
        self.stats["gather_seconds"] += time.perf_counter() - start
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, in rank order (the same bits on every rank)."""
        return self.all_gather(t).sum(dim=0)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to rank - 1 and return rank + 1's tensor of the same
        shape and type (mod the size; the reference's ``ppermute`` with
        ``perm = [(i, i - 1)]``).  A group of one rank returns a copy."""
        start = time.perf_counter()
        n = self.size
        out = torch.empty_like(t)
        if n == 1:
            out.copy_(t)
        elif self.backend == "cuda_ipc":
            if self.ring_inboxes is None:
                raise ValueError("this group has no ring inboxes (spawn_peers(ring_bytes=...))")
            buf = self._shifts % 2
            self._shifts += 1
            raw = _as_bytes(t)
            slot = self.ring_inboxes[0].shape[-1]
            if raw.numel() > slot:
                raise ValueError(f"a {raw.numel()}-byte block does not fit the {slot}-byte ring "
                                 "inboxes (spawn_peers(ring_bytes=...))")
            self.ring_inboxes[(self.rank - 1) % n][buf, 0, :raw.numel()].copy_(raw)
            torch.cuda.current_stream(self.device).synchronize()
            dist.barrier()
            out.view(-1).view(torch.uint8).copy_(
                self.ring_inboxes[self.rank][buf, 0, :raw.numel()])
        else:
            ops = [dist.P2POp(dist.isend, t.contiguous(), (self.rank - 1) % n),
                   dist.P2POp(dist.irecv, out, (self.rank + 1) % n)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.stats["shifts"] += 1
        self.stats["shift_seconds"] += time.perf_counter() - start
        self.stats["shift_bytes"] += t.numel() * t.element_size() if n > 1 else 0
        return out

    def barrier(self) -> None:
        """Wait until every rank (and, on a card, its stream) got here."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dist.barrier()


def _to_cpu(tree):
    return pytree.tree_map(lambda v: v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                           tree)


def check_rank(group: PeerGroup, mode: str):
    """A rank program that checks the launcher's failure paths: "raise"
    raises on the last rank and "hang" sleeps there, while the others wait
    at a barrier (the launcher must fail, not hang)."""
    if mode not in ("raise", "hang"):
        raise ValueError(f"unknown check {mode!r}")
    if group.rank == group.size - 1:
        if mode == "raise":
            raise RuntimeError(f"rank {group.rank} raises")
        time.sleep(3600)
    group.barrier()


def _rank_main(rank: int, fn: Callable, shared: list, size: int, device: str, backend: str,
               rundir: str, timeout: float) -> None:
    """A spawned rank: per-process settings, the process group, ``fn``, its
    result saved for the parent.  ``shared`` = [args, inboxes, ring
    inboxes], emptied here: a spawned process ends without freeing what it
    still holds, and a CUDA tensor it opened by IPC stays allocated in its
    launcher until the rank frees it, so the rank drops every reference
    before it returns."""
    args, inboxes, ring_inboxes = shared
    shared.clear()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rundir}/store", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=timeout))
    group = PeerGroup(rank, size, dev, backend, inboxes, ring_inboxes)
    del inboxes, ring_inboxes
    try:
        out = fn(group, *args)
        torch.save(_to_cpu(out), os.path.join(rundir, f"rank{rank}.pt"))
        del out
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        del group, args
        gc.collect()  # the IPC tensors freed: the launcher's ipc_collect takes them back
        dist.destroy_process_group()


def _shareable(make: Callable[[], Any]):
    """``make()``'s CUDA allocations, from the allocator's fixed segments
    even where expandable segments are on: only those can be handed to
    another process (CUDA IPC of an expandable segment needs the pidfd_open
    system call, which a host's kernel may lack)."""
    expandable = "expandable_segments:True" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None) or \
        torch.cuda.memory._set_allocator_settings  # the name before torch 2.9
    if expandable:
        setting("expandable_segments:False")
    try:
        return make()
    finally:
        if expandable:
            setting("expandable_segments:True")


def _ipc_buffers(count: int, shape: tuple, device: torch.device) -> list[torch.Tensor]:
    """``count`` zeroed uint8 buffers that other processes can open."""
    return _shareable(lambda: [torch.zeros(shape, dtype=torch.uint8, device=device)
                               for _ in range(count)])


def shared_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that ``spawn_peers`` can pass to its ranks: on a card
    in memory other processes can open (``_shareable``), on the CPU as it
    is (it travels in shared memory)."""
    if t.device.type != "cuda":
        return t
    return _shareable(lambda: t.clone())


def _join(ctx, timeout: float) -> bool:
    """``ctx.join(timeout)``, whose error names the first failed rank it
    saw, re-raised with the traceback of every rank that raised (the one
    that raised first and the ones that failed waiting for it)."""
    try:
        return ctx.join(timeout=timeout)
    except ProcessException as err:
        for p in ctx.processes:
            p.join(timeout=5)
        failed = []
        for rank, path in enumerate(ctx.error_files):
            if os.path.exists(path) and os.path.getsize(path):
                with open(path, "rb") as f:
                    failed.append(f"-- rank {rank}:\n{pickle.load(f)}")
        raise RuntimeError("ranks of the run failed:\n" + "\n".join(failed or [str(err)])) \
            from err


def _build_kernels() -> None:
    """Build (or load) the consensus kernels once, before the ranks start."""
    from repro_torch.kernels.consensus_mix import dequant, ops, segment
    ops.load_kernel()
    dequant.load_kernel()
    segment.load_kernel()


def check_num_peers(num_peers: int) -> None:
    """The rule on a group's size K: at least one rank (``spawn_peers``'s,
    and a peer layout's, ``repro_torch.launch.mesh.make_peer_mesh``)."""
    if num_peers < 1:
        raise ValueError(f"need at least one peer, got {num_peers}")


def spawn_peers(
    fn: Callable[..., Any],
    num_peers: int,
    device: torch.device | str,
    *,
    args: tuple = (),
    inbox_bytes: int = 0,
    ring_bytes: int = 0,
    timeout: float = TIMEOUT_SECONDS,
    deadline: float | None = None,
) -> list:
    """Run ``fn(group, *args)`` in ``num_peers`` spawned ranks and return
    their results in rank order (tensors moved to the CPU).

    ``fn`` must be importable (a module-level function of a package) and
    ``args`` picklable (CPU tensors travel in shared memory, CUDA tensors by
    CUDA IPC: ``shared_copy``).  ``device`` "cpu" takes the gloo transport,
    a CUDA device the ``cuda_ipc`` one, whose inbox slots hold
    ``inbox_bytes`` bytes (the largest row a rank exchanges or gathers) and
    whose ring inboxes, where ``ring_bytes`` > 0, that many (the largest
    block a rank ring-shifts).
    ``timeout`` is every process group's, and the seconds the parent waits
    for the other ranks once one has exited; ``deadline`` (seconds,
    optional) bounds the whole run.  A rank that raises makes this raise
    (with every failed rank's traceback); past a deadline the ranks are
    killed and ``TimeoutError`` is raised.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # the ranks set this card
        device = torch.device("cuda", torch.cuda.current_device())
    check_num_peers(num_peers)
    backend = "cuda_ipc" if device.type == "cuda" else "gloo"
    inboxes = ring_inboxes = None
    if backend == "cuda_ipc":
        _build_kernels()
        if inbox_bytes < 1:
            raise ValueError("cuda_ipc ranks need inbox_bytes >= 1 (their largest row)")
        slot = -(-int(inbox_bytes) // 16) * 16
        inboxes = _ipc_buffers(num_peers, (2, num_peers, slot), device)
        if ring_bytes > 0:
            ring_inboxes = _ipc_buffers(num_peers, (2, 1, -(-int(ring_bytes) // 16) * 16), device)
    rundir = tempfile.mkdtemp(prefix="repro-peers-")
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved or "expandable_segments:True"
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, [tuple(args), inboxes, ring_inboxes], num_peers, str(device),
                              backend, rundir, float(timeout)),
            nprocs=num_peers, join=False, start_method="spawn")
    finally:
        if saved is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    try:
        start = time.monotonic()
        first_exit = None
        while not _join(ctx, 0.2):
            now = time.monotonic()
            if first_exit is None and any(not p.is_alive() for p in ctx.processes):
                first_exit = now
            late = first_exit is not None and now - first_exit > timeout
            if late or (deadline is not None and now - start > deadline):
                alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"ranks {alive} of {num_peers} did not finish "
                                   + (f"within {timeout:.0f} s of the first exit" if late
                                      else f"within the {deadline:.0f} s deadline"))
        return [torch.load(os.path.join(rundir, f"rank{r}.pt"), weights_only=False)
                for r in range(num_peers)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        shutil.rmtree(rundir, ignore_errors=True)
        del inboxes, ring_inboxes
        if device.type == "cuda":  # the blocks the ranks opened by CUDA IPC and freed
            torch.cuda.ipc_collect()
