"""Checkpoint save/restore — params + optimizer + extras + config.

Port of ``recbole_gnn_tpu/train/checkpoint.py`` in the same on-disk
format: a pickle holding a flat npz of the arrays, keyed by tree path,
and the non-array leaves, so checkpoints cross-load between the two
packages.  ``load_checkpoint`` reads a checkpoint written by the JAX
trainer; :func:`params_from_numpy` carries its arrays onto a device.

Only load checkpoints this program or a trusted trainer wrote: the
outer container is a pickle.
"""

from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch


def _to_host(tree):
    """Nested dict/list/tuple with tensors replaced by numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__seqtype__"] = type(tree).__name__
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree) if tree is not None else None
    return out


def _unflatten(flat: dict):
    # rebuild nested structure from path keys
    root: dict = {}
    seq_markers = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[-1] == "__seqtype__":
            seq_markers["/".join(parts[:-1])] = value
            continue
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix(node, path=""):
        if not isinstance(node, dict):
            return node
        fixed = {k: fix(v, f"{path}{k}/".lstrip("/")) for k, v in node.items()}
        marker = seq_markers.get(path.rstrip("/"))
        if marker in ("list", "tuple"):
            items = [fixed[str(i)] for i in range(len(fixed))]
            return items if marker == "list" else tuple(items)
        return fixed

    return fix(root)


def save_checkpoint(path: str, state: dict):
    """state: any nested dict/list/tuple of tensors, arrays + scalars.

    The write is atomic (tmp file in the same dir + os.replace), so a
    concurrent reader never sees a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(_to_host(state))
    arrays = {k: v for k, v in flat.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in flat.items() if not isinstance(v, np.ndarray)}
    buf = io.BytesIO()
    np.savez_compressed(buf, **{k.replace("/", "||"): v
                                for k, v in arrays.items()})
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump({"npz": buf.getvalue(), "meta": meta}, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str) -> dict:
    """Nested dict of numpy arrays and scalars, as saved."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    with np.load(io.BytesIO(blob["npz"]), allow_pickle=False) as z:
        arrays = {k.replace("||", "/"): z[k] for k in z.files}
    flat = dict(arrays)
    flat.update(blob["meta"])
    return _unflatten(flat)


def params_from_numpy(params: dict, device: torch.device | str
                      ) -> dict:
    """Carry a (nested) dict of numpy arrays onto ``device`` as tensors
    of their own (0-d arrays become 0-d tensors; other leaves pass
    through)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device)
        elif isinstance(v, np.ndarray):
            out[k] = torch.tensor(v, device=device)   # a copy: v may be read-only
        else:
            out[k] = v
    return out
