"""Checkpoint and resume of state trees (counterpart of
``beamforming_lk_tpu.io.checkpoint``).

A tree of NamedTuples, dicts, lists and tuples round-trips through one
``.npz`` keyed by the JAX package's tree paths: a NamedTuple field is
``.name``, a dict key ``['key']``, a sequence index ``[i]``, joined by
``/`` (``.history``, ``.swarm/.seekers/.theta``, ...), so a file that
either package writes names the same leaves.  Host ints, such as
``AwpuState.block_index`` and ``SwarmState.reset_count``, are saved as
0-d arrays and come back as ints; tensors come back on the template's
device with its dtype.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves(tree, path=()):
    """(key, leaf) pairs of ``tree`` in the JAX package's order."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, tree: Any, extra: Optional[dict] = None) -> None:
    """Write ``tree``'s leaves to ``path`` (.npz), and the arrays of
    ``extra`` under their own keys."""
    arrays = {key: _numpy(leaf) for key, leaf in _leaves(tree)}
    np.savez_compressed(path, **arrays, **(extra or {}))


def _rebuild(template, path, data):
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, n), path + (f".{n}",), data)
                                for n in template._fields))
    if isinstance(template, dict):
        return {k: _rebuild(v, path + (f"[{k!r}]",), data)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, path + (f"[{i}]",), data)
                              for i, v in enumerate(template))
    key = "/".join(path)
    if key not in data:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    saved = data[key]
    want = (tuple(template.shape) if isinstance(template, torch.Tensor)
            else np.shape(template))
    if tuple(saved.shape) != tuple(want):
        raise ValueError(f"checkpoint leaf {key!r} shape {saved.shape} != {want}")
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(saved, dtype=template.dtype, device=template.device)
    if isinstance(template, (bool, int, float)):
        return type(template)(saved)
    return saved


def load_state(path: str, template: Any) -> Any:
    """The tree saved at ``path``, shaped like ``template``: leaves matched
    by key; raises ``KeyError`` for a leaf the file lacks and
    ``ValueError`` for one whose shape differs.  Keys the template does
    not name are not read."""
    with np.load(path) as data:
        return _rebuild(template, (), data)
