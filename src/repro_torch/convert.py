"""Carry host state into the port: numpy trees → torch tensors.

:func:`state_from_numpy` is how the same state reaches both packages (the
reference takes the numpy arrays, the port their tensors);
:func:`params_from_numpy` carries a model's parameter tree and holds it to
the port's own tree for the configuration.  Dtypes torch
has but numpy names only through ``ml_dtypes`` (``bfloat16``, the
``float8_*`` family) are carried through a same-width unsigned view of the
bytes, so no value is converted.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core import storage


def tensor_from_numpy(arr: np.ndarray, device="cuda") -> torch.Tensor:
    """A tensor on ``device`` with ``arr``'s dtype name, shape and bits."""
    arr = np.asarray(arr)
    name = arr.dtype.name
    if name in storage._EXTENDED:
        width = arr.dtype.itemsize
        arr = arr.view(np.dtype(f"uint{8 * width}"))
    return storage.as_tensor(arr.copy(), name).to(device)


def state_from_numpy(tree, device="cuda"):
    """``tree`` with every numpy array leaf replaced by its tensor on
    ``device`` (other leaves and the structure unchanged)."""
    return pytree.tree_map(
        lambda x: tensor_from_numpy(x, device) if isinstance(x, np.ndarray)
        else x, tree)


def params_from_numpy(tree, cfg, device="cuda"):
    """A model parameter tree (numpy leaves, e.g. the reference's
    ``init_params`` turned into numpy) as tensors on ``device``.  Every leaf
    is checked against the port's ``init_params`` tree for ``cfg`` (built on
    the meta device): the same key paths, shapes and dtypes, or ValueError.
    """
    from repro_torch.models import model as M

    want = pytree.tree_flatten_with_path(
        M.init_params(None, cfg, device="meta"))[0]
    got = pytree.tree_flatten_with_path(tree)[0]
    want_map = {pytree.keystr(k): v for k, v in want}
    got_map = {pytree.keystr(k): v for k, v in got}
    if set(want_map) != set(got_map):
        raise ValueError(
            f"parameter tree of {cfg.arch_id} does not match: missing "
            f"{sorted(set(want_map) - set(got_map))}, unexpected "
            f"{sorted(set(got_map) - set(want_map))}")
    out = state_from_numpy(tree, device)
    for key, t in pytree.tree_flatten_with_path(out)[0]:
        ref = want_map[pytree.keystr(key)]
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(
                f"{cfg.arch_id} parameter {pytree.keystr(key)}: got "
                f"{tuple(t.shape)} {t.dtype}, expected {tuple(ref.shape)} "
                f"{ref.dtype}")
    return out
