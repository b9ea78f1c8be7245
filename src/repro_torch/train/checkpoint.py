"""Checkpointing with atomic commit and restart support (the counterpart
of ``repro.train.checkpoint``), over trees of dicts, lists and tuples of
tensors.

Layout:  <dir>/step_<n>/
            manifest.json        (step, and each leaf's path, shape, dtype)
            arr_<i>.npy          (one file a leaf)
         <dir>/LATEST            (atomic pointer, written through a rename)

The layout, the leaf order and each manifest ``path`` are the reference's:
leaves in ``jax.tree_util.tree_flatten_with_path`` order (dict keys
sorted, sequences in order) and paths spelled as ``jax.tree_util.keystr``
spells them (``['b'][1]['c']``), so each package restores the other's
checkpoints.

Fault-tolerance contract: ``save`` is atomic (a temporary directory, then
a rename, then the ``LATEST`` flip), ``restore`` reads ``LATEST``,
``restore_or_init`` is the restart entry point after a preemption, and a
half-written step directory (no manifest) counts as absent.  A bfloat16
leaf is written as the reference writes one (numpy has no bfloat16: the
manifest says ``"bfloat16"`` and the ``.npy`` holds the bits as ``|V2``
voids) and read back bit for bit.

On the training mesh a checkpoint holds the whole state
(``save_gathered``: rank 0 writes ``gather_tree``'s leaves), so it does
not depend on the mesh; ``resharded`` cuts a restored state for this
rank of any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import exec as exec_mod


def _leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in the reference's order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


BF16_BITS = np.dtype("V2")


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to write, the manifest's dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_BITS), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf of {arr.dtype} items")
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Atomically write a checkpoint for ``step``; prunes old steps."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    flat = [(p, *_to_numpy(leaf)) for p, leaf in _leaves_with_paths(tree)]
    tmp = Path(tempfile.mkdtemp(dir=d, prefix=".tmp_"))
    manifest = {"step": step, "leaves": []}
    for i, (path, arr, dtype) in enumerate(flat):
        np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append({"path": path, "shape": list(arr.shape),
                                   "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = d / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = d / ".LATEST_tmp"
    latest_tmp.write_text(str(step))
    os.replace(latest_tmp, d / "LATEST")          # atomic pointer flip
    _prune(d, keep)
    return str(final)


def _prune(d: Path, keep: int):
    steps = sorted((int(p.name.split("_")[1]) for p in d.glob("step_*")),
                   reverse=True)
    for s in steps[keep:]:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    step = int(p.read_text().strip())
    if not (Path(ckpt_dir) / f"step_{step}" / "manifest.json").exists():
        return None  # torn write; treat as absent
    return step


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None):
    """Restore into the structure of ``like``: each leaf comes back as a
    tensor of ``like``'s leaf's dtype on its device (a leaf of ``like``
    that is not a tensor gives a CPU tensor of the saved dtype).  The
    paths and shapes must be ``like``'s.  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = _leaves_with_paths(like)
    if [p for p, _ in flat] != [m["path"] for m in manifest["leaves"]]:
        raise ValueError(f"checkpoint {d} holds the leaves "
                         f"{[m['path'] for m in manifest['leaves']]}, the "
                         f"tree to restore {[p for p, _ in flat]}")
    leaves = []
    for i, ((path, leaf), meta) in enumerate(zip(flat, manifest["leaves"])):
        arr = np.load(d / f"arr_{i}.npy")
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if list(arr.shape) != meta["shape"] or tuple(arr.shape) != want:
            raise ValueError(f"checkpoint leaf {path}: shape {arr.shape}, "
                             f"manifest {meta['shape']}, tree {want}")
        t = _from_numpy(arr, meta["dtype"])
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        leaves.append(t)
    return _unflatten(like, iter(leaves)), step


def restore_or_init(ckpt_dir: str, init_fn: Callable[[], Any]):
    """The restart entry point: resume from LATEST if present, else init.
    Returns (state, start_step)."""
    step = latest_step(ckpt_dir)
    template = init_fn()
    if step is None:
        return template, 0
    return restore(ckpt_dir, template, step)


def resharded(tree: Any, mesh, spec_tree=None):
    """Place a restored (global, host) tree on this rank of a mesh: the
    elastic-scaling path, since checkpoints do not depend on the mesh.
    ``mesh`` is a ``launch.mesh.Mesh`` and ``spec_tree`` the tree's specs
    (the reference's form; ``launch.shardings.shard_tree``), or the rank's
    ``ShardedGraph`` of the sharded executor (of any world size) and
    ``spec_tree`` ``exec.place_args``'s ``is_sharded`` rule."""
    if hasattr(mesh, "axis_names"):
        from repro_torch.launch import shardings
        return shardings.shard_tree(tree, spec_tree, mesh)
    return exec_mod.place_args(mesh, tree, spec_tree)


def save_gathered(ckpt_dir: str, step: int, tree: Any, specs, mesh,
                  keep: int = 3) -> Optional[str]:
    """A checkpoint of a state on the mesh: every rank gathers its leaves
    whole (``gather_tree``), rank 0 writes them with ``save``, and every
    rank waits for the write.  Returns the step directory on rank 0, None
    elsewhere."""
    import torch.distributed as dist
    from repro_torch.launch import shardings
    whole = shardings.gather_tree(tree, specs, mesh)
    path = save(ckpt_dir, step, whole, keep) if mesh.rank == 0 else None
    if mesh.size > 1:
        dist.barrier()
    return path
