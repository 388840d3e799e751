"""How the port's parameter names map onto the JAX package's parameter tree.

The port names a parameter as ``LM.named_parameters()`` does (``embed``,
``blocks.3.attn.wq``, ``shared.attn.wq``, ...); the JAX tree stacks the
per-layer leaves of ``blocks`` and ``enc_blocks``, so the port's
``blocks.<i>.<rest>`` is row i of JAX's ``blocks.<rest>`` (and likewise for
``enc_blocks``). Every other leaf — ``shared`` (zamba2's one shared block),
``vit_proj``, ``enc_ln_f`` — is unstacked.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

__all__ = ["jax_leaf", "jax_leaves", "tree_map_with_path"]

_STACKED = ("blocks", "enc_blocks")  # the module lists JAX stacks along a layer axis


def jax_leaf(name: str) -> Tuple[str, int | None]:
    """The JAX leaf (dotted path) of a port parameter name, and the layer
    (its row in that stacked leaf), or None for an unstacked leaf."""
    head, _, rest = name.partition(".")
    if head in _STACKED:
        i, rest = rest.split(".", 1)
        return f"{head}.{rest}", int(i)
    return name, None


def _order(name: str) -> Tuple[List[str], int]:
    key, layer = jax_leaf(name)
    return key.split("."), -1 if layer is None else layer


def jax_leaves(names: Iterable[str]) -> Dict[str, List[str]]:
    """The port's parameter names grouped by the JAX leaf they are part of,
    in that tree's order (keys sorted at every level), each group in layer
    order: a stacked ``blocks`` or ``enc_blocks`` leaf of JAX is one group
    of per-layer names."""
    groups: Dict[str, List[str]] = {}
    for name in sorted(names, key=_order):
        groups.setdefault(jax_leaf(name)[0], []).append(name)
    return groups


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists (kept),
    the path "/"-joined from dict keys and sequence indices, as JAX's
    ``tree_map_with_path`` + ``_path_str`` write it ("kv/0/1": how
    ``launch.sharding.cache_spec`` names a cache leaf)."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)
