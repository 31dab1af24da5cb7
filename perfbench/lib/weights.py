"""Random weights of a dense decoder, made on the device from the run's
seed, in the layout the port's models take (``embed``, ``ln_f``,
``head``, ``layers``: one dict a layer).

The normals come from one ``torch.Generator`` on the device, drawn in
chunks of ``CHUNK`` float32 values and handed out to the leaves in a
fixed order, each scaled and cast to the type it is served in: a few
large calls, never leaf by leaf.  Every matrix is N(0, fan_in^-1/2), the
embeddings N(0, 1), the norm weights zero (the port scales by ``1 + w``).  The same seed
gives the same values, so the plain reference draws its own copy after
the program's state is gone (:func:`iter_leaves` with
``dtype=torch.float32`` upcasts the very same bf16 values).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch

CHUNK = 1 << 27

Path = Tuple  # ("layers", i, "wq"), ("embed",), ...


def seed64(seed: int) -> int:
    """Any whole number as a generator seed (below 2**64)."""
    return int(seed) % (1 << 64)


def leaf_specs(arch: dict) -> List[Tuple[Path, tuple, Optional[float],
                                        str]]:
    """(path, shape, scale, dtype) of every leaf in drawing order; a
    scale of None is a zero-initialised norm weight."""
    d, v, h, kv = (arch["d_model"], arch["vocab_size"], arch["num_heads"],
                   arch["num_kv_heads"])
    hd = arch.get("head_dim") or d // h
    f = arch["d_ff"]
    act = arch.get("dtype", "bfloat16")
    if arch["family"] != "dense":
        raise ValueError(f"no weights for family {arch['family']!r}")
    specs = [(("embed",), (v, d), 1.0, act),
             (("ln_f",), (d,), None, act),
             (("head",), (d, v), d ** -0.5, act)]
    for i in range(arch["num_layers"]):
        layer = [("ln1", (d,), None, act), ("ln2", (d,), None, act),
                 ("wq", (d, h * hd), d ** -0.5, act),
                 ("wk", (d, kv * hd), d ** -0.5, act),
                 ("wv", (d, kv * hd), d ** -0.5, act),
                 ("wo", (h * hd, d), (h * hd) ** -0.5, act),
                 ("wg", (d, f), d ** -0.5, act),
                 ("wu", (d, f), d ** -0.5, act),
                 ("wd", (f, d), f ** -0.5, act)]
        specs += [(("layers", i, name), shape, scale, dt)
                  for name, shape, scale, dt in layer]
    return specs


def iter_leaves(arch: dict, seed: int, device,
                dtype: Optional[torch.dtype] = None
                ) -> Iterator[Tuple[Path, torch.Tensor]]:
    """Every leaf in drawing order, made one at a time; ``dtype`` (the
    reference's float32) casts each after it is made in its own type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    buf = torch.empty(0, device=device)
    pos = 0
    for path, shape, scale, dt in leaf_specs(arch):
        own = getattr(torch, dt)
        n = 1
        for s in shape:
            n *= s
        if scale is None:
            leaf = torch.zeros(shape, dtype=own, device=device)
        else:
            leaf = torch.empty(n, dtype=own, device=device)
            done = 0
            while done < n:
                if pos == buf.numel():
                    buf = torch.randn(CHUNK, generator=gen, device=device)
                    pos = 0
                k = min(n - done, buf.numel() - pos)
                leaf[done:done + k] = (buf[pos:pos + k] * scale).to(own)
                done += k
                pos += k
            leaf = leaf.view(shape)
        if dtype is not None and leaf.dtype != dtype:
            leaf = leaf.to(dtype)
        yield path, leaf


def make_tree(arch: dict, seed: int, device,
              dtype: Optional[torch.dtype] = None) -> Dict:
    """The whole tree (see the module docstring)."""
    tree: Dict = {"layers": [dict() for _ in range(arch["num_layers"])]}
    for path, leaf in iter_leaves(arch, seed, device, dtype):
        if path[0] == "layers":
            tree["layers"][path[1]][path[2]] = leaf
        else:
            tree[path[0]] = leaf
    return tree


def name(path: Path) -> str:
    """A leaf's name, ``layers.3.wq`` style."""
    return ".".join(str(p) for p in path)


def change_norms(arch: dict, seed: int, device, current) -> Dict[str, float]:
    """Each leaf's change from the seed's weights: the norm of
    ``current(path)`` less the weight drawn at the start, in float32,
    the start drawn again leaf by leaf."""
    out = {}
    for path, w0 in iter_leaves(arch, seed, device, torch.float32):
        out[name(path)] = float((current(path).float() - w0).norm())
    return out


def get(tree: Dict, path: Path) -> torch.Tensor:
    node = tree
    for p in path:
        node = node[p]
    return node
