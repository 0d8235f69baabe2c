"""Bytes of a Lanczos iteration on the graphene lattice, from its sizes:
the least an iteration must move, each vector read once or written once
(the current and the previous vector and the on-site term read, the new
vector written), float32."""
from __future__ import annotations


def sites(lat: dict) -> int:
    return lat["nx"] * lat["ny"] * 2


def iteration_bytes(lat: dict) -> float:
    return 4.0 * 4 * sites(lat)


def version_bytes(lat: dict) -> float:
    """The two live vectors a checkpoint version holds."""
    return 2.0 * 4 * sites(lat)
