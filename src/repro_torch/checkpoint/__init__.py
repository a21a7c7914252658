"""Checkpointing: tree <-> .npz with path-flattened keys + JSON metadata (the
port's ``repro.checkpoint``).

Keys are the reference's: the nested keys of a leaf joined by ``/``, ``#i``
for a list or tuple item (``repro_torch.pytree``), so the port's dotted
name ``fc1.w`` is written under ``fc1/w`` and a file written by either
package is read by the other.  A bfloat16 leaf is written as the reference
writes one (numpy has no bf16 type): its bits as a two-byte ``|V2`` record.
``restore`` rebuilds the leaf from those bits, where the reference's
``restore`` raises (numpy has no cast from ``V2``; ROADMAP.md section 3).
``restore`` puts each leaf on the device, and in the type, of the matching
leaf of ``like``, and raises on a missing key or a shape that differs.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch import pytree

PyTree = Any
_SEP = "/"
_BF16_DESCR = "<V2"  # numpy's descr of an ml_dtypes bfloat16 array, as the reference writes


def _array_of(leaf) -> np.ndarray:
    """A leaf as a numpy array, bit for bit (bf16 as two-byte void records)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _array_of(leaf) for path, leaf in pytree.leaves_with_path(tree)}


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def _savez(path: str, flat: dict[str, np.ndarray]) -> None:
    """``np.savez``'s archive, a bf16 leaf's header under the reference's
    descr (numpy would write a void array's as ``|V2``)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fp:
                if arr.dtype.kind == "V":
                    np.lib.format.write_array_header_1_0(
                        fp, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
                    fp.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(fp, arr, allow_pickle=False)


def save(path: str, tree: PyTree, *, step: int | None = None, extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    _savez(_npz_path(path), flat)
    meta = {"step": step, "extra": extra or {}, "keys": sorted(flat)}
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def _leaf_of(arr: np.ndarray, like):
    """The stored array as a leaf like ``like`` (its type, its device)."""
    if not isinstance(like, torch.Tensor):
        return arr.astype(like.dtype) if hasattr(like, "dtype") else arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # the bits of a bf16 leaf
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (shape checked)."""
    with np.load(_npz_path(path)) as npz:
        def leaf(p, want):
            key = _SEP.join(p)
            if key not in npz:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = npz[key]
            want_shape = tuple(want.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"{key}: shape {arr.shape} != expected {want_shape}")
            return _leaf_of(arr, want)

        return pytree.map_with_path(leaf, like)


def load_metadata(path: str) -> dict:
    with open(_meta_path(path)) as f:
        return json.load(f)
