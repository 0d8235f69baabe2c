"""Carry host state into the port: numpy trees → torch tensors.

:func:`state_from_numpy` is how the same state reaches both packages (the
reference takes the numpy arrays, the port their tensors).  Dtypes torch
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
