"""One step of a loop captured as a CUDA graph and replayed: the port's
counterpart of the reference's ``lax.scan`` bodies (the round driver,
``core.p2p.make_scan_driver``, and the scanned decode,
``launch.steps.make_decode_scan``).

A loop body is a Python function of no arguments that reads and writes
tensors at fixed addresses (its static buffers); the driver refreshes those
buffers between steps.  ``capture(fn, device)`` runs ``fn`` eagerly
``warmup`` times on a side stream (the loop's first steps, which also make
every one-time call outside the capture: the hand kernels' shared-memory
attributes and occupancy queries, cuBLAS's workspace for that stream,
autograd's first use), then records one more call under ``torch.cuda.graph``
on the same stream, which launches nothing.  Between the two the allocator's
cached free blocks are released (``torch.cuda.empty_cache``): the graph
records into a private pool, which cannot reuse them, so a body whose
warm-up leaves a round's activations cached (an LM round: tens of GB) would
otherwise hold them twice.  ``replay()`` relaunches the
recorded work on the current stream and returns the recorded call's outputs;
their memory belongs to the graph, so the next replay overwrites them.

A capture or replay that fails raises; there is no fallback to the eager
loop on a CUDA device.  On a CPU device there is no graph: the warm-up calls
run as they are, and ``replay()`` calls ``fn``.

The kernel wrappers count a launch at Python call time
(``kernels.build.LaunchCounter``), so a capture would count launches that
never ran and a replay none.  ``capture`` takes back what each counter
gained while it recorded and ``replay`` adds it again, so the counters keep
meaning "kernel launches since reset" whichever driver ran.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable

import torch

from repro_torch.kernels.build import LaunchCounter


class Captured:
    """``fn`` warmed up and, on a CUDA device, captured (see the module's
    docstring).  ``warmup_outputs`` is the last warm-up call's return value,
    ``outputs`` the captured call's (None on the CPU), ``seconds`` the wall
    time of the warm-up and the capture, device work included."""

    def __init__(self, fn: Callable[[], Any], device: torch.device | str, *, warmup: int = 1):
        if warmup < 1:
            raise ValueError(f"capture needs at least one warm-up call, got {warmup}")
        self.fn = fn
        self.device = torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: Any = None
        self._deltas: list[tuple[LaunchCounter, int]] = []
        if self.device.type != "cuda":
            start = time.perf_counter()
            for _ in range(warmup):
                self.warmup_outputs = fn()
            self.seconds = time.perf_counter() - start
            return
        torch.cuda.synchronize(self.device)
        start = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                self.warmup_outputs = fn()
        stream.synchronize()
        torch.cuda.empty_cache()  # the warm-up's freed blocks: the graph's pool is its own
        before = [c.count for c in LaunchCounter.instances]
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while recording: a dead reference cycle that
        # holds another graph would destroy it mid-capture, an API call a
        # capture does not allow (it fails the capture)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                self.outputs = fn()
        finally:
            if collecting:
                gc.enable()
        for counter, count in zip(LaunchCounter.instances, before):
            if counter.count != count:  # recorded, not launched
                self._deltas.append((counter, counter.count - count))
                counter.count = count
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.seconds = time.perf_counter() - start

    def replay(self) -> Any:
        """Run the body once more: the graph on a CUDA device, ``fn`` on the CPU."""
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        for counter, delta in self._deltas:
            counter.count += delta
        return self.outputs


def capture(fn: Callable[[], Any], device: torch.device | str, *, warmup: int = 1) -> Captured:
    """Warm ``fn`` up ``warmup`` times and capture it (see ``Captured``)."""
    return Captured(fn, device, warmup=warmup)
