"""Per-leaf checkpoint I/O, manifest format 2 (port of
``repro.checkpoint.sharded``).

The bytes on disk are the JAX package's: one ``.npy`` per leaf (on one
card every leaf is one shard; a checkpoint the JAX package saved under a
mesh, with several shard files per leaf, is reassembled on read), bf16
stored as a ``uint16`` view with the dtype tag ``"bfloat16"``, 0-d scalars
as 0-d arrays, the same file names, and a manifest written last::

    {"format": 2, "step": 4, "meta": {...}, "leaves": {"a::b": {
        "dtype": "bfloat16", "shape": [512, 64], "spec": null,
        "shards": [{"file": "a__b.npy", "index": [[0, 512], [0, 64]],
                    "bytes": 65536, "crc32": 1234}]}}}

``spec`` records the PartitionSpec a leaf was saved under; one card writes
``null``, and a JAX spec is read and ignored (restore places every leaf on
one device).

**Snapshots are copies.** :func:`snapshot_leaf` copies a tensor to host
memory at once, so the caller may hand the result to a writer thread while
the next training step updates the live tensors in place (``optim/adamw.py``
updates params, master, m and v in place). On a CPU tensor ``.cpu()`` and
``.numpy()`` alias the live storage; the copy is explicit.

**Restores memory-map.** :func:`read_leaf` reads each shard through
``np.load(mmap_mode="r")`` and copies it to the target device; a bf16 leaf
is reinterpreted from its ``uint16`` bits, never through a float.

**Integrity.** Every shard record carries a CRC32 of the bytes the file
stores and the payload size; :func:`verify_checkpoint` re-validates a step
structurally (every file present and at least payload-sized) or deeply
(full re-read and CRC). Shard reads and writes go through bounded retry
(:func:`repro_torch.resilience.recovery.retry_io`), and the fault sites
``ckpt.shard_write`` / ``ckpt.shard_read`` sit on this exact path.
"""
from __future__ import annotations

import json
import os
import warnings
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.params import resolve_device
from repro_torch.resilience import faults
from repro_torch.resilience.recovery import InjectedFault, ShardCorruptionError, retry_io

_SEP = "::"

MANIFEST = "manifest.json"
FORMAT = 2


def spec_to_json(spec: Optional[Sequence]) -> Optional[list]:
    """A PartitionSpec-like sequence (entries None, an axis name or a tuple
    of names) as JSON; a copy of ``repro.sharding.rules.spec_to_json``."""
    if spec is None:
        return None
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def spec_from_json(obj: Optional[Sequence]) -> Optional[tuple]:
    """Inverse of :func:`spec_to_json`, as a plain tuple (the port has no
    mesh to apply it to)."""
    if obj is None:
        return None
    return tuple(tuple(p) if isinstance(p, list) else p for p in obj)


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> flat ``a::b::c`` keys (leaves = anything non-dict)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{_SEP}{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def unflatten_tree(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host_copy(leaf) -> Tuple[str, np.ndarray]:
    """(dtype tag, a numpy copy holding the bytes the file stores)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
        a = t.to("cpu", copy=True).numpy()
    else:
        a = np.array(leaf)
        if a.dtype.name == "bfloat16":  # a JAX bf16 leaf through np.asarray
            return "bfloat16", a.view(np.uint16)
    return str(a.dtype), a


def snapshot_leaf(leaf) -> Tuple[Dict[str, Any], List[Tuple[List[List[int]], np.ndarray]]]:
    """Host-copy a leaf (torch tensor, numpy array or scalar): returns
    ``(manifest entry sans files, [(index, numpy copy)])`` with one shard
    covering the whole leaf and no spec (one card). bf16 leaves come back
    as their ``uint16`` bits."""
    dtype, a = _host_copy(leaf)
    entry = {"dtype": dtype, "shape": list(a.shape), "spec": None}
    return entry, [([[0, d] for d in a.shape], a)]


def _crc(data: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(data))


def _save_shard(path: str, fname: str, data: np.ndarray) -> None:
    """Write one shard file, then apply any injected write fault to the
    bytes on disk."""
    fp = os.path.join(path, fname)
    np.save(fp, data)
    for spec in faults.fire("ckpt.shard_write"):
        if spec.kind == "write_fail":
            if os.path.exists(fp):
                os.remove(fp)
            raise InjectedFault(f"injected shard write failure: {fname}")
        if spec.kind == "torn":
            faults.truncate_file(fp, spec.args.get("keep_fraction", 0.5))
        elif spec.kind == "bitflip":
            inj = faults.active()
            faults.flip_bit(fp, inj.rng if inj is not None else None)


def write_leaf(path: str, key: str, entry: Dict[str, Any],
               shards: List[Tuple[List[List[int]], np.ndarray]]) -> Dict[str, Any]:
    """Write a snapshot's shard files under ``path``; returns the manifest
    entry with file names, payload bytes and CRC32s. Each shard write is
    retried with backoff."""
    base = key.replace(_SEP, "__")
    recs = []
    for i, (index, data) in enumerate(shards):
        fname = f"{base}__s{i}.npy" if len(shards) > 1 else f"{base}.npy"
        retry_io(_save_shard, path, fname, data, what=f"ckpt write {fname}")
        recs.append({"file": fname, "index": index, "bytes": int(data.nbytes), "crc32": _crc(data)})
    return {**entry, "shards": recs}


def _load_shard(path: str, fname: str) -> np.ndarray:
    """Memory-map one shard file (bf16 shards stay ``uint16``)."""
    def load():
        for spec in faults.fire("ckpt.shard_read"):
            if spec.kind == "read_fail":
                raise InjectedFault(f"injected shard read failure: {fname}")
        return np.load(os.path.join(path, fname), mmap_mode="r")

    return retry_io(load, what=f"ckpt read {fname}")


def verify_shard(path: str, entry: Dict[str, Any], rec: Dict[str, Any]) -> None:
    """Deep-validate one shard file against its manifest record; raises
    :class:`ShardCorruptionError` naming the file and the mismatch."""
    fp = os.path.join(path, rec["file"])
    if not os.path.exists(fp):
        raise ShardCorruptionError(f"{fp}: shard file missing")
    try:
        arr = np.load(fp)  # full read, no mmap: the CRC covers every byte
    except Exception as e:  # noqa: BLE001 — any parse failure is corruption
        raise ShardCorruptionError(f"{fp}: unreadable shard ({e})") from e
    want_shape = tuple(hi - lo for lo, hi in rec["index"])
    if tuple(arr.shape) != want_shape:
        raise ShardCorruptionError(f"{fp}: shard shape {tuple(arr.shape)} != manifest index extent {want_shape}")
    if "crc32" in rec and _crc(arr) != rec["crc32"]:
        raise ShardCorruptionError(
            f"{fp}: content checksum mismatch (bit corruption) — expected crc32 {rec['crc32']}, "
            "file hashes differently"
        )


def verify_checkpoint(path: str, deep: bool = True) -> Dict[str, Any]:
    """Validate a committed step directory; returns the manifest.
    ``deep=False``: the manifest parses and every shard file exists and
    holds at least its recorded payload bytes (catches torn writes).
    ``deep=True`` also re-reads every shard and checks its CRC32 (catches
    bit flips). Raises :class:`ShardCorruptionError` on the first bad
    shard."""
    try:
        manifest = read_manifest(path)
    except Exception as e:  # noqa: BLE001
        raise ShardCorruptionError(f"{path}: unreadable manifest ({e})") from e
    for entry in manifest["leaves"].values():
        for rec in entry.get("shards", ()):
            fp = os.path.join(path, rec["file"])
            if not os.path.exists(fp):
                raise ShardCorruptionError(f"{fp}: shard file missing")
            if "bytes" in rec and os.path.getsize(fp) < rec["bytes"]:
                raise ShardCorruptionError(
                    f"{fp}: file holds {os.path.getsize(fp)} bytes < recorded payload {rec['bytes']} (torn write)"
                )
            if deep:
                verify_shard(path, entry, rec)
    return manifest


def to_tensor(a: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    """A host array holding a leaf's stored bytes -> a tensor of its own on
    ``device`` (bf16 reinterpreted from the ``uint16`` bits). A memory-mapped
    ``a`` is read-only; the copy is what the caller may update in place."""
    a = np.asarray(a)
    if dtype == "bfloat16":
        a = a.view(np.int16)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(a)
    t = t.to(device, copy=True)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _assemble(path: str, entry: Dict[str, Any]) -> np.ndarray:
    """A leaf's stored bytes as one host array: the memory map itself for a
    one-shard leaf, else the shards copied into place."""
    shards = entry["shards"]
    if len(shards) == 1:
        return _load_shard(path, shards[0]["file"])
    storage = np.uint16 if entry["dtype"] == "bfloat16" else np.dtype(entry["dtype"])
    out = np.empty(entry["shape"], dtype=storage)
    covered = 0
    for rec in shards:
        dst = tuple(slice(lo, hi) for lo, hi in rec["index"])
        out[dst] = _load_shard(path, rec["file"])
        covered += int(np.prod([hi - lo for lo, hi in rec["index"]]))
    assert covered == out.size, f"checkpoint shards cover {covered}/{out.size} elements of {entry['shape']}"
    return out


def read_leaf(path: str, entry: Dict[str, Any], device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Reassemble a saved leaf as a tensor on ``device``."""
    return to_tensor(_assemble(path, entry), entry["dtype"], resolve_device(device))


def read_tree(path: str, manifest: Dict[str, Any], device: Union[str, torch.device] = "cuda"):
    """Manifest -> nested dict of tensors on ``device``; shared by the flat
    loader and the step-directory manager."""
    dev = resolve_device(device)
    return unflatten_tree({key: read_leaf(path, entry, dev) for key, entry in manifest["leaves"].items()})


def write_manifest(path: str, step: int, leaves: Dict[str, Any], meta: Optional[Dict] = None):
    """Manifest is written LAST: a directory with a manifest is complete."""
    manifest = {"format": FORMAT, "step": step, "meta": meta or {}, "leaves": leaves}
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)
