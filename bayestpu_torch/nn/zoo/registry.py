"""Model registry — name → model constructor (counterpart of
``bayestpu/nn/zoo/registry.py``)."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def get_model(name: str, **kwargs):
    try:
        make = _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return make(**kwargs)


def available_models() -> list[str]:
    return sorted(_REGISTRY)
