"""The fake route of the hand kernels: what a kernel wrapper does with
``FakeTensor`` operands (``torch._subclasses.fake_tensor``), the stand-ins of
the dry run (``repro_torch.launch.dryrun_lib``), which have a shape, a type
and a device but no data.

A wrapper follows its CUDA branch up to the launch itself: it checks the
operands and allocates its outputs and scratch (fake too, so the dry run's
memory count sees them), then its ``launch`` function, given fake tensors,
calls ``record`` with the call's shapes and returns instead of building,
loading or launching the kernel.  ``record`` hands the shapes to every
listening counter (``repro_torch.launch.op_cost.OpCost``), which counts the
call by the kernel's own work (``repro_torch.launch.roofline.kernel_work``),
not by the operations of its plain version.  The route fires only on fake
tensors: a real CPU tensor takes the plain version and a real CUDA tensor
launches the kernel or raises, as before, and the launch counters count no
fake call.

A fake tensor may stand for a CUDA tensor on the ``meta`` device: a build of
PyTorch without CUDA has no device guard for fake CUDA tensors (it can
neither index them nor run autograd over them), so the dry run places its
stand-ins there on such a build.  ``check_device`` lets such a tensor through the
wrappers' device checks, and ``address`` gives the byte offset of a fake
tensor from its storage's start in place of a pointer, for the wrappers'
alignment rules (a real allocation's start is aligned).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch._subclasses import fake_tensor

# the counters listening for fake kernel calls: (name, shapes) -> None
sinks: list[Callable[[str, dict], None]] = []


def is_fake(t: torch.Tensor | None) -> bool:
    """Whether ``t`` is a fake tensor (no data: the fake route's operands),
    seen through ``torch.func`` wrappers (a vmapped call's operands)."""
    return fake_tensor.is_fake(t)


def check_device(t: torch.Tensor, what: str) -> None:
    """The wrappers' device rule: CPU and CUDA tensors, or a fake tensor on
    any device; anything else raises."""
    if t.device.type not in ("cpu", "cuda") and not is_fake(t):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {t.device}")


def address(t: torch.Tensor) -> int:
    """``t.data_ptr()``, or for a fake tensor its byte offset from its
    storage's start (which an allocation aligns)."""
    return t.storage_offset() * t.element_size() if is_fake(t) else t.data_ptr()


def record(name: str, **shapes) -> None:
    """One fake call of kernel ``name`` with ``shapes`` (the arguments of
    ``roofline.kernel_work``), handed to every listening counter."""
    for sink in sinks:
        sink(name, shapes)
