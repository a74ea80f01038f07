"""Parameter sharding rulesets.

Port of ``repro/dist/sharding.py``.  ``param_specs(params, ruleset,
mesh_axis_names)`` walks nested dicts (and lists) of tensors and gives
each leaf a ``PartitionSpec`` from one of four rulesets:

  * ``"lm"``     decoder LMs: the token table row-sharded (vocab on
                 "model", dim on "data"), the stacked ``layers/...`` params
                 keep their leading L axis unsharded and TP-shard the
                 output feature dim, norms and biases replicated.
  * ``"lm_ep"``  as "lm", but MoE expert tensors (E, d, f) shard the
                 expert axis on "model" and d on "data".
  * ``"recsys"`` embedding and wide tables row-sharded on "model"; the
                 dense net replicated.
  * ``"gnn"``    the node-id table row-sharded, the rest replicated.

Axes absent from ``mesh_axis_names`` degrade to ``None``.
``zero1_specs`` adds the "data" axis to each spec's first divisible free
dimension (ZeRO-1 optimizer state); ``validate_divisibility`` lists every
(leaf, dim, axis) that does not divide.  The port's param trees keep the
reference's names and the LMs' stacked ``layers`` layout, so the rules
read the same paths.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.dist.ctx import PartitionSpec as P


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over nested dicts (keys sorted, as
    JAX's dict order), lists, tuples and NamedTuples; a ``PartitionSpec``
    and ``None`` are leaves.  ``path`` is a tuple of keys, indices and
    field names."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        fields = getattr(tree, "_fields", None)
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  path=path + ((fields[i] if fields else i),))
               for i, v in enumerate(tree)]
        if fields:
            return type(tree)(*out)
        return type(tree)(out)
    if tree is None:
        return None
    return fn(path, tree, *rest)


def tree_leaves_with_path(tree: Any) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in ``tree_map_with_path``'s order."""
    out: list = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def pathstr(path) -> str:
    return "/".join(str(k) for k in path)


def _finish(entries) -> P:
    """Full-rank tuple -> spec; fully replicated collapses to P()."""
    if all(e is None for e in entries):
        return P()
    return P(*entries)


def _is_norm(parts) -> bool:
    last = parts[-1]
    if last in ("g", "b", "bias"):
        return True
    return any("norm" in p or p.startswith("ln") for p in parts)


def _lm_body(parts, shape, model, data, ep: bool):
    """Spec entries of one (unstacked) layer-body tensor."""
    nd = len(shape)
    if nd <= 1 or _is_norm(parts):
        return (None,) * nd
    if ep and "moe" in parts and nd >= 3:
        # (E, d, f) / (E, f, d): expert parallelism + ZeRO-style d shard
        return (model, data) + (None,) * (nd - 2)
    if nd == 2:
        return (data, model)
    # non-EP expert stacks (E, d, f): TP on the feature dim only
    return (None,) * (nd - 2) + (data, model)


def _lm_spec(path, shape, model, data, ep: bool) -> P:
    parts = pathstr(path).split("/")
    nd = len(shape)
    if parts[0] == "embed":
        return _finish((model, data) + (None,) * (nd - 2))
    if parts[0] == "layers":
        # stacked: the leading L axis is never sharded
        return _finish((None,) + _lm_body(parts[1:], shape[1:], model,
                                          data, ep))
    return _finish(_lm_body(parts, shape, model, data, ep))


def _table_spec(path, shape, model) -> P:
    parts = pathstr(path).lower()
    if len(shape) == 2 and ("table" in parts or "embed" in parts):
        return _finish((model, None))
    return P()


def param_specs(params, ruleset: str,
                mesh_axis_names=("data", "model")):
    """The ``PartitionSpec`` tree matching ``params`` under ``ruleset``."""
    model = "model" if "model" in mesh_axis_names else None
    data = "data" if "data" in mesh_axis_names else None

    if ruleset in ("lm", "lm_ep"):
        ep = ruleset == "lm_ep"

        def assign(path, leaf):
            return _lm_spec(path, tuple(leaf.shape), model, data, ep)
    elif ruleset in ("recsys", "gnn"):

        def assign(path, leaf):
            return _table_spec(path, tuple(leaf.shape), model)
    else:
        raise KeyError(f"unknown ruleset {ruleset!r}; "
                       "have lm, lm_ep, recsys, gnn")

    return tree_map_with_path(assign, params)


def zero1_specs(pspec, params, data_size: int):
    """Add the "data" axis to each spec's first divisible free dimension
    (ZeRO-1: optimizer state sharded over data parallelism)."""

    def add(_, spec, leaf):
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        if any(e == "data" or (isinstance(e, tuple) and "data" in e)
               for e in entries):
            return spec
        for i, (ax, dim) in enumerate(zip(entries, leaf.shape)):
            if ax is None and dim % data_size == 0:
                entries[i] = "data"
                return P(*entries)
        return spec

    return tree_map_with_path(add, pspec, params)


def validate_divisibility(params, specs, mesh) -> list[str]:
    """Every (dim, mesh-axis) pair that does not divide, as messages.  An
    empty list means the layout places on this mesh."""
    sizes = dict(mesh.shape)
    problems: list[str] = []

    def check(path, leaf, spec):
        for i, ax in enumerate(tuple(spec)):
            if ax is None or not isinstance(ax, (str, tuple)):
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = 1
            for a in axes:
                n *= sizes.get(a, 1)
            if n > 1 and leaf.shape[i] % n:
                problems.append(
                    f"{pathstr(path)}: dim {i} of shape "
                    f"{tuple(leaf.shape)} not divisible by {ax} (={n})")
        return spec

    tree_map_with_path(check, params, specs)
    return problems


def shard_shape(shape, spec, mesh_shape: dict) -> tuple[int, ...]:
    """One device's block of a ``shape`` array placed by ``spec``: each
    sharded dimension divided by the product of its axes, rounded up (a
    partitioner pads a dimension its axes do not divide)."""
    out = list(shape)
    for i, ax in enumerate(tuple(spec)):
        if ax is None or not isinstance(ax, (str, tuple)):
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= mesh_shape.get(a, 1)
        out[i] = -(-out[i] // n)
    return tuple(out)
