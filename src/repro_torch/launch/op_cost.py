"""Op-level cost of one step: the port's counterpart of the reference's
``repro.launch.hlo_cost``.

The reference reads FLOPs and bytes off compiled HLO text and scales loop
bodies by their trip counts.  The port has no HLO: its steps run eagerly,
op by op, so ``OpCost`` (a ``TorchDispatchMode``) counts the aten ops of a
step as they are dispatched.  A layer stack dispatches each layer's ops once
a layer, so no trip count is needed.  Under ``FakeTensorMode`` (the dry run,
``launch.dryrun_lib``) the ops run on stand-ins with no data, at any size.

Per op, as ``hlo_cost`` counts per HLO op:

- FLOPs of matmuls, convolutions and the attention ops: 2 x the result's
  elements x the contracted size (``torch.utils.flop_counter``'s formulas,
  which count so), by the type of the operands (``bf16`` at the dense bf16
  tensor rate; ``float32`` at the float32 pipes' rate, since TF32 stays off
  as the port runs).  Elementwise ops count no FLOPs, as in ``hlo_cost``;
- bytes: each tensor operand read plus each output written; views
  (an output that aliases an operand, and ``_unsafe_view``, a view its
  schema does not mark) and ``empty`` allocations move none; an in-place
  write into part of its first operand (``index_put_`` and the scatters:
  the KV cache's update) reads its other operands and writes its values,
  not the whole first operand.

A hand kernel's wrapper, given fake operands, does not launch: it records
the call (``kernels.fake.record``), and ``OpCost`` counts it by the
kernel's own work (``roofline.kernel_work``) under ``kernel_calls``, never
by the ops of its plain version.

The peak of live bytes: every storage an op creates counts from its
creation until it is freed (a weak reference to the storage), rounded up to
the 512 bytes the CUDA caching allocator rounds a block to, on top of the
state registered with ``track`` (``tracked_bytes``, rounded alike);
``peak_bytes`` is the most live at any point.  This is the count
``torch.cuda.max_memory_allocated`` keeps, less what the card holds beside
the step's state (the cuBLAS workspaces, say), which no count of the step
can know.  (The
``torch.distributed._tools.mem_tracker.MemTracker`` of this build also works
under fake tensors, but its per-module bookkeeping serves ``nn.Module``
models, and the port's are functions; one mode counts both here.)
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import fake
from repro_torch.launch import roofline

BLOCK = 512  # bytes: the CUDA caching allocator rounds each block up to this
# allocations that write nothing, and a view whose schema marks no alias
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "_unsafe_view")
# in-place writes into part of the first operand, the values the last operand
_PARTIAL_WRITES = ("index_put_", "index_copy_", "index_add_", "scatter_", "scatter_add_",
                   "scatter_reduce_", "masked_scatter_")


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flop_kind(dtype: torch.dtype) -> str:
    """The rate a matmul of ``dtype`` operands runs at: bf16 (and fp16) on
    the dense tensor rate, anything else on the float32 pipes."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "float32"


class OpCost(TorchDispatchMode):
    """Counts the aten ops dispatched under it and the hand kernels' fake
    calls (see the module): ``flops`` (by kind in ``flops_by``), ``bytes``,
    ``kernel_calls`` and ``kernel_work`` (each call's ``roofline.Work``),
    ``live_bytes`` and ``peak_bytes``."""

    def __init__(self):
        super().__init__()
        self.flops_by: collections.Counter = collections.Counter()
        self.op_bytes = 0
        self.kernel_calls: collections.Counter = collections.Counter()
        self.kernel_work: list[tuple[str, roofline.Work]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.tracked_bytes = 0
        self._seen = WeakIdKeyDictionary()

    # -- the kernels' fake calls --------------------------------------------

    def _record(self, name: str, shapes: dict) -> None:
        self.kernel_calls[name] += 1
        self.kernel_work.append((name, roofline.kernel_work(name, **shapes)))

    def __enter__(self):
        fake.sinks.append(self._record)
        return super().__enter__()

    def __exit__(self, *exc):
        fake.sinks.remove(self._record)
        return super().__exit__(*exc)

    # -- memory ---------------------------------------------------------------

    def _hold(self, storage) -> None:
        if storage in self._seen:
            return
        n = -(-storage.nbytes() // BLOCK) * BLOCK
        self._seen[storage] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def track(self, *trees) -> int:
        """Count the tensors of ``trees`` (the step's state, made before it)
        as live; returns their bytes (each storage once, unrounded)."""
        total = 0
        for t in _tensors(trees):
            st = t.untyped_storage()
            if st not in self._seen:
                total += st.nbytes()
                self._hold(st)
                self.tracked_bytes += self._seen[st]
        return total

    # -- the ops ----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        if packet in flop_registry and ins:
            self.flops_by[_flop_kind(ins[0].dtype)] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        returns = func._schema.returns
        view = bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                     for r in returns)
        outs = _tensors(out)
        name = packet.__name__
        if name in _PARTIAL_WRITES and len(ins) > 1:
            self.op_bytes += sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
        elif not view and name not in _NO_TRAFFIC:
            self.op_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if not view:
            for t in outs:
                self._hold(t.untyped_storage())
        return out

    # -- the totals -------------------------------------------------------------

    @property
    def flops(self) -> float:
        """Every FLOP counted: the ops' and the kernels' (a kernel with two
        counts by its float32 one, ``roofline.Work.flops``)."""
        return float(sum(self.flops_by.values()) + sum(w.flops for _, w in self.kernel_work))

    @property
    def bytes(self) -> float:
        return float(self.op_bytes + sum(w.bytes for _, w in self.kernel_work))

    def flops_by_kind(self) -> dict[str, float]:
        """FLOPs by the rate they run at; the kernels' under ``kernels``."""
        out = {k: float(v) for k, v in self.flops_by.items()}
        out["kernels"] = float(sum(w.flops for _, w in self.kernel_work))
        return out

    def compute_seconds(self, card) -> float:
        """The compute term on ``card`` (a ``mesh.Card``): each kind's FLOPs
        at its rate, each kernel call at ``card.seconds``."""
        return (sum(v / card.rate(k) for k, v in self.flops_by.items())
                + sum(card.seconds(w) for _, w in self.kernel_work))
