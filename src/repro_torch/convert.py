"""Carry host state into the port: numpy trees → torch tensors.

:func:`state_from_numpy` is how the same state reaches both packages (the
reference takes the numpy arrays, the port their tensors);
:func:`params_from_numpy` carries a model's parameter tree and holds it to
the port's own tree for the configuration; :func:`opt_state_from_numpy`
does the same for an AdamW state (the reference's ``adamw_init`` /
``adamw_update`` layout, 32-bit or 8-bit moments, with or without the
master copy).  Dtypes torch
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


def lanczos_init_from_numpy(eps: np.ndarray, v0: np.ndarray,
                            device="cuda"):
    """The ``init=`` pair of ``apps.lanczos.run_lanczos``: another
    package's on-site term and unnormalized start vector (e.g. the
    reference's ``onsite(cfg)`` and its ``PRNGKey(cfg.seed + 1)`` normal
    draw, as numpy), float32 (nx, ny, 2) each, as tensors on ``device``."""
    eps, v0 = np.asarray(eps), np.asarray(v0)
    if eps.shape != v0.shape or eps.ndim != 3 or eps.shape[-1] != 2:
        raise ValueError(f"a Lanczos problem is two (nx, ny, 2) arrays, got "
                         f"{eps.shape} and {v0.shape}")
    return (tensor_from_numpy(eps.astype(np.float32), device),
            tensor_from_numpy(v0.astype(np.float32), device))


def params_from_numpy(tree, cfg, device="cuda"):
    """A model parameter tree (numpy leaves, e.g. the reference's
    ``init_params`` turned into numpy) as tensors on ``device``.  Every leaf
    is checked against the port's ``init_params`` tree for ``cfg`` (built on
    the meta device): the same key paths, shapes and dtypes, or ValueError.
    """
    from repro_torch.models import model as M

    out = state_from_numpy(tree, device)
    _match(out, M.init_params(None, cfg, device="meta"),
           f"{cfg.arch_id} parameter")
    return out


def opt_state_from_numpy(tree, cfg, device="cuda"):
    """An AdamW state of the reference (``m``, ``v``, ``count`` and
    optionally ``master``; 8-bit moments as ``{"q": int8, "scale":
    float32}``), numpy leaves, as the port's state on ``device`` (``count``
    on the host, as ``optim.adamw`` keeps it).  Held to the port's
    ``adamw_init`` of ``cfg``'s parameters in the same layout, or
    ValueError."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptimConfig, adamw_init

    def eight(t) -> bool:
        return isinstance(t, dict) and (set(t) == {"q", "scale"} or any(
            eight(v) for v in t.values()))

    ocfg = OptimConfig(state_bits=8 if eight(tree["m"]) else 32,
                       master_fp32="master" in tree)
    want = adamw_init(M.init_params(None, cfg, device="meta"), ocfg)
    out = {k: state_from_numpy(v, device) for k, v in tree.items()
           if k != "count"}
    out["count"] = tensor_from_numpy(np.asarray(tree["count"]), "cpu")
    _match(out, want, f"{cfg.arch_id} optimizer state")
    return out


def _match(got, want, what: str) -> None:
    """``got`` has ``want``'s key paths, shapes and dtypes, or ValueError."""
    want_map = {pytree.keystr(k): v
                for k, v in pytree.tree_flatten_with_path(want)[0]}
    got_map = {pytree.keystr(k): v
               for k, v in pytree.tree_flatten_with_path(got)[0]}
    if set(want_map) != set(got_map):
        raise ValueError(
            f"{what} tree does not match: missing "
            f"{sorted(set(want_map) - set(got_map))}, unexpected "
            f"{sorted(set(got_map) - set(want_map))}")
    for key, t in got_map.items():
        ref = want_map[key]
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(
                f"{what} {key}: got {tuple(t.shape)} {t.dtype}, expected "
                f"{tuple(ref.shape)} {ref.dtype}")
