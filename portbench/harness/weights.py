"""Weights drawn on the device from the seed, in a few large calls.

The tree of parameter descriptors is the port's own layout (its input
format).  Every leaf drawn from a normal distribution is a slice of one
buffer per storage dtype, filled by one `torch.randn` call from a
`torch.Generator` on the device, in the dtype the leaf is stored in, then
scaled in place as the descriptor says (1 / sqrt(fan-in) unless given);
`ones` and `zeros` leaves are constant.  Program and reference get the
same tensors; neither changes them.
"""
from __future__ import annotations

import math

import torch


def _walk(tree, path, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (k,), out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _walk(t, path + (i,), out)
    elif tree is not None:
        out.append((path, tree))
    return out


def _rebuild(tree, made):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, made) for t in tree)
    return None if tree is None else made[id(tree)]


def storage_dtype(desc, dtype):
    """The dtype a leaf is stored in: `dtype` (the serving dtype) for
    floating leaves, f32 for the leaves the model reads in f32."""
    own = desc.dtype if desc.dtype is not None else torch.float32
    if own.is_floating_point and not desc.f32:
        return dtype
    return own


def _special(rule: dict, shape, generator, device):
    """A leaf drawn by a named rule of the configuration file's `init`:

    * {"rule": "log_arange"}: log(1), ..., log(n) along the last dim, the
      same in every row (Mamba's S4D-real A_log);
    * {"rule": "inv_softplus_log_uniform", "min", "max", "floor"}: x with
      softplus(x) = dt, dt log-uniform in [min, max], at least `floor`
      (Mamba's dt bias).
    """
    kind = rule["rule"]
    if kind == "log_arange":
        n = shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        return row.expand(shape).contiguous()
    if kind == "inv_softplus_log_uniform":
        lo, hi = math.log(rule["min"]), math.log(rule["max"])
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        dt = torch.exp(u * (hi - lo) + lo).clamp(min=rule["floor"])
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"no init rule {kind!r}")


def make(descs, generator: torch.Generator, device, dtype, contracted=None, rules=None):
    """The parameter tree of `descs` (a tree of descriptors with `shape`,
    `init`, `scale`, `dtype`, `f32`), drawn from `generator` on `device`.

    A leaf under "blocks" stacks a layer group along its leading dim.  Its
    scale, unless the descriptor gives one, is 1 / sqrt(fan-in), the
    fan-in being the product of the leading dims of one layer's shape that
    the product contracts: `contracted[name]` of them for the leaf `name`,
    all but the last by default.  `rules` maps a leaf name to a rule of
    `_special` that replaces its descriptor's draw.
    """
    contracted, rules = contracted or {}, rules or {}
    made, normal = {}, {}
    for path, d in _walk(descs, (), []):
        dt = storage_dtype(d, dtype)
        if path[-1] in rules:
            made[id(d)] = _special(rules[path[-1]], d.shape, generator, device).to(dt)
        elif d.init == "zeros":
            made[id(d)] = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            made[id(d)] = torch.ones(d.shape, dtype=dt, device=device)
        elif d.init == "normal":
            normal.setdefault(dt, []).append((path, d))
        else:
            raise ValueError(f"no draw for init {d.init!r}")
    for dt, ds in normal.items():
        total = sum(math.prod(d.shape) for _, d in ds)
        buf = torch.randn(total, generator=generator, device=device, dtype=dt)
        off = 0
        for path, d in ds:
            n = math.prod(d.shape)
            t = buf[off:off + n].view(d.shape)
            off += n
            one = d.shape[1:] if "blocks" in path else d.shape
            k = contracted.get(path[-1], len(one) - 1)
            scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(1, math.prod(one[:k])))
            made[id(d)] = t.mul_(scale)
    return _rebuild(descs, made)
