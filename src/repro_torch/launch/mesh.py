"""The card and the layouts of the port (the counterpart of the reference's
``repro.launch.mesh``, whose TPU mesh and peaks it replaces).

``PEAKS`` holds each part's published rates, from NVIDIA's H100 data sheet:
memory bytes/s, float32 FLOP/s outside the tensor cores, the dense bf16 and
TF32 tensor FLOP/s (TF32 half of bf16's), the NVLink bytes/s a card sends
(the data sheet's 900 GB/s on the SXM part and 600 GB/s through the PCIe
part's bridge count both directions of all its links: half of it goes
out, and a rank's exchange sends one way) and the card's memory.  ``Card`` picks the part from the card's name as ``nvidia-smi``
prints it (``card_line``), or from the part's name where no card is read (a
dry run on the CPU reckons for ``"H100 SXM"`` by default), and gives the
least time of a piece of work on it (``bound``, ``work_bound``,
``seconds``).  ``PEAK_FLOPS_BF16``, ``HBM_BW`` and ``ICI_BW`` are the H100
SXM's counterparts of the reference's constants: its dense bf16 rate, its
memory rate and its NVLink rate.

The layouts stand where the reference's meshes stand.  The port places a
peer on one card and does not split a peer over cards, so a layout is a
number of peers of one card each:

- ``make_production_mesh()``: one card, one peer (the reference's
  single-pod case);
- ``make_production_mesh(multi_pod=True)``: two peers, one a rank and a
  card (the sharded runtime, ``core.peer_group``; the reference's
  multi-pod case, pod = 2);
- ``make_peer_mesh(K)``: K peers, one a rank and a card, K checked as
  ``core.peer_group.spawn_peers`` checks it (the reference's peer axis,
  "pod", is the port's only one).
"""
from __future__ import annotations

import dataclasses
import subprocess

from repro_torch.core import peer_group


@dataclasses.dataclass(frozen=True)
class Peaks:
    bytes_per_s: float  # memory
    flop_per_s: float  # float32, outside the tensor cores
    bf16_flop_per_s: float  # dense bf16 tensor
    tf32_flop_per_s: float  # dense TF32 tensor
    link_bytes_per_s: float  # NVLink, all links, one direction
    memory_bytes: float


PEAKS = {"H100 SXM": Peaks(3.35e12, 67e12, 989e12, 495e12, 450e9, 80e9),
         "H100 PCIe": Peaks(2.0e12, 51e12, 756e12, 378e12, 300e9, 80e9)}
DEFAULT_PART = "H100 SXM"
RATE_NAMES = {"float32": "float32", "bf16": "bf16", "tf32": "TF32"}

PEAK_FLOPS_BF16 = PEAKS[DEFAULT_PART].bf16_flop_per_s  # FLOP/s
HBM_BW = PEAKS[DEFAULT_PART].bytes_per_s  # B/s
ICI_BW = PEAKS[DEFAULT_PART].link_bytes_per_s  # B/s: NVLink, one direction


def part_of(name: str) -> str:
    """The part of ``PEAKS`` a card's name (``nvidia-smi``'s) names; raises
    on a card whose peaks are not known."""
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return "H100 SXM"
    if "H100" in name and "PCIe" in name:
        return "H100 PCIe"
    raise RuntimeError(f"no peak rates known for the card {name!r}")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


class Card:
    """The card's name and power limit (``card_line``), its part and that
    part's peaks."""

    def __init__(self, line: str, part: str | None = None):
        self.line = line
        self.part = part or part_of(line.split(",")[0])
        self.peaks = PEAKS[self.part]
        (self.bytes_per_s, self.flop_per_s, self.bf16_flop_per_s, self.tf32_flop_per_s,
         self.link_bytes_per_s, self.memory_bytes) = dataclasses.astuple(self.peaks)

    @classmethod
    def for_part(cls, part: str = DEFAULT_PART) -> "Card":
        """The peaks of ``part`` where no card is read (a reckoning)."""
        if part not in PEAKS:
            raise ValueError(f"unknown part {part!r}; one of {sorted(PEAKS)}")
        return cls(f"{part} (reckoned: no card read)", part)

    def rate(self, kind: str) -> float:
        """FLOP/s of ``kind``: "float32" (the float32 pipes), "bf16" or
        "tf32" (the dense tensor rates)."""
        return {"float32": self.flop_per_s, "bf16": self.bf16_flop_per_s,
                "tf32": self.tf32_flop_per_s}[kind]

    def bound(self, nbytes: float, flops: float, kind: str = "float32") -> dict:
        """The least time for ``nbytes`` and ``flops`` at ``kind``'s rate
        (``rate``) on this card, and which bounds it."""
        rate = self.rate(kind)
        t_bytes, t_flops = nbytes / self.bytes_per_s * 1e3, flops / rate * 1e3
        return {"bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                "bound_card": f"{self.line} ({self.part} peaks: {self.bytes_per_s / 1e12} TB/s, "
                              f"{rate / 1e12} TFLOP/s {RATE_NAMES[kind]})"}

    def work_bound(self, work) -> dict:
        """``bound`` of a kernel call's ``roofline.Work``.  A call whose
        operations can run on the float32 pipes or on the tensor cores (the
        scan kernels) has both bounds, under ``bound_ms_fma`` /
        ``bound_ms_tensor`` (and ``bound_by_*``); its headline is the
        smaller, the least time the card could take."""
        one = self.bound(work.bytes, work.flops, work.kind)
        if work.tensor_kind is None:
            return one
        tensor = self.bound(work.bytes, work.tensor_flops, work.tensor_kind)
        return {**min(one, tensor, key=lambda bd: bd["bound_ms"]),
                **{f"{key}_{kind}": bd[key] for kind, bd in (("fma", one), ("tensor", tensor))
                   for key in ("bound_ms", "bound_by")},
                "bound_tensor_type": RATE_NAMES[work.tensor_kind]}

    def seconds(self, work) -> float:
        """The compute time of a ``roofline.Work`` at this card's rates: the
        smaller of its two counts' where it has two."""
        t = work.flops / self.rate(work.kind)
        if work.tensor_kind is not None:
            t = min(t, work.tensor_flops / self.rate(work.tensor_kind))
        return t


@dataclasses.dataclass(frozen=True)
class Layout:
    """``peers`` peers, one a card (a rank of the sharded runtime where
    there are several): the port's counterpart of a mesh."""

    name: str
    peers: int


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """One card (one peer), or with ``multi_pod`` two peers of a card each."""
    return make_peer_mesh(2) if multi_pod else Layout("1card", 1)


def make_peer_mesh(num_peers: int) -> Layout:
    """``num_peers`` peers, one a rank and a card, ``num_peers`` checked by
    ``core.peer_group.check_num_peers`` (``spawn_peers``' rule)."""
    peer_group.check_num_peers(num_peers)
    return Layout(f"{num_peers}x1card", num_peers)


def num_chips(mesh: Layout) -> int:
    """The cards of a layout: one a peer."""
    return mesh.peers
