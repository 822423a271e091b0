"""A minimal pytree for payloads, flattening in the JAX package's order.

``jax.tree.flatten`` visits dict keys in sorted order; PyTorch's own pytree
keeps insertion order.  The codec's packed stream and its per-leaf metas
follow the leaf order, so the port flattens exactly as JAX does: dicts by
sorted key, lists and tuples in order, a NamedTuple (the optimizer's state)
by field and rebuilt as its own type, ``None`` as an empty subtree, and
anything else as a leaf.  ``tree_paths`` names each leaf as
``jax.tree_util.keystr`` does (``[0]['runs'][0]['attn']['wq']``,
``[1].m['embed']``), the names a checkpoint's manifest carries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Tuple


@dataclass(frozen=True)
class TreeDef:
    kind: str                           # "leaf" | "none" | "dict" | "list" | "tuple" | "namedtuple"
    keys: Tuple[Any, ...] = ()          # a dict's keys, a NamedTuple's fields
    children: Tuple["TreeDef", ...] = ()
    node_type: Any = None               # a NamedTuple's class

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def unflatten(self, leaves) -> Any:
        """Rebuild the tree from ``leaves`` (the method name JAX's
        ``PyTreeDef`` uses, so decoders can take either)."""
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"treedef has {self.num_leaves} leaves, "
                             f"got {len(leaves)}")
        return self._build(iter(leaves))

    def _build(self, it: Iterator[Any]) -> Any:
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        built = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, built))
        if self.kind == "namedtuple":
            return self.node_type(*built)
        return built if self.kind == "list" else tuple(built)

    def paths(self, prefix: str = "") -> List[str]:
        """Each leaf's key path in ``jax.tree_util.keystr``'s spelling."""
        if self.kind == "leaf":
            return [prefix]
        names = ([f"[{k!r}]" for k in self.keys] if self.kind == "dict" else
                 [f".{k}" for k in self.keys] if self.kind == "namedtuple"
                 else [f"[{i}]" for i in range(len(self.children))])
        return [p for name, c in zip(names, self.children)
                for p in c.paths(prefix + name)]


def _flatten_into(node: Any, leaves: List[Any]) -> TreeDef:
    """Append ``node``'s leaves to ``leaves``; return its TreeDef.  A
    module-level function: a nested one that calls itself would close over
    its own cell, a reference cycle that keeps ``leaves`` (the tensors) alive
    until the garbage collector runs."""
    if node is None:
        return TreeDef("none")
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys,
                       tuple(_flatten_into(node[k], leaves) for k in keys))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return TreeDef("namedtuple", tuple(node._fields),
                       tuple(_flatten_into(c, leaves) for c in node),
                       type(node))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, (), tuple(_flatten_into(c, leaves) for c in node))
    leaves.append(node)
    return TreeDef("leaf")


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    treedef = _flatten_into(tree, leaves)
    return leaves, treedef


def tree_paths(tree: Any) -> List[str]:
    """Each leaf's key path, in leaf order (``jax.tree_util.keystr``)."""
    return tree_flatten(tree)[1].paths()


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, td in others:
        if td != treedef:
            raise ValueError("tree_map over trees of different structure")
    return treedef.unflatten(
        [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))])


def spec_map(fn: Callable[..., Any], spec: Any, *rest: Any) -> Any:
    """Apply ``fn`` over a spec tree (dicts, lists and NamedTuples whose
    leaves are plain tuples, e.g. of logical axis names) and trees of its
    structure, each leaf of ``rest`` taken at the spec leaf's place."""
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return type(spec)(*(spec_map(fn, s, *(r[i] for r in rest))
                            for i, s in enumerate(spec)))
    if isinstance(spec, tuple):
        return fn(spec, *rest)
    if isinstance(spec, dict):
        return {k: spec_map(fn, spec[k], *(r[k] for r in rest)) for k in spec}
    if isinstance(spec, list):
        return [spec_map(fn, s, *(r[i] for r in rest))
                for i, s in enumerate(spec)]
    raise TypeError(f"a spec tree holds dicts, lists and tuples; got "
                    f"{type(spec).__name__}")
