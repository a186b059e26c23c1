"""The weights, made by the benchmark from the seed and handed alike to
the port and to the plain reference.

``leaf_table`` lists every parameter of a configuration in the tree the
port takes (``embed``, ``stack`` with one period of stacked layers,
``ln_f``, ``unembed`` where the embeddings are not tied) with its shape and
fan-in; ``make`` draws them on the device in bf16, N(0, 1/fan_in) and norm
scales of 1, from one generator seeded from ``--seed``, a few large draws
into one buffer of which every normal leaf is a view. Nothing here reads
the port; the drivers compare the port's blueprint with the table.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: elements of one draw
DRAW = 1 << 30


def arch(config: dict) -> Dict[str, int]:
    """The sizes the table and the reference read from a configuration."""
    V = config["vocab_size"]
    m = config["assumed"]["vocab_pad_multiple"]
    H = config["num_attention_heads"]
    return {"L": config["num_hidden_layers"], "d": config["hidden_size"],
            "H": H, "Hkv": config["num_key_value_heads"],
            "D": config.get("head_dim") or config["hidden_size"] // H,
            "ff": config["intermediate_size"], "V": V,
            "Vp": (V + m - 1) // m * m,
            "E": config.get("num_experts", 0),
            "k": config.get("num_experts_per_tok", 0),
            "tied": bool(config["tie_word_embeddings"])}


def leaf_table(config: dict) -> List[Tuple[tuple, tuple, str, int]]:
    """(path, shape, init, fan_in) of every leaf, in a fixed order."""
    a = arch(config)
    L, d, H, Hkv, D, ff = a["L"], a["d"], a["H"], a["Hkv"], a["D"], a["ff"]
    lay = ("stack", 0)
    out = [(("embed",), (a["Vp"], d), "normal", d),
           (lay + ("ln1", "scale"), (L, d), "ones", 0),
           (lay + ("attn", "wq"), (L, d, H, D), "normal", d),
           (lay + ("attn", "wk"), (L, d, Hkv, D), "normal", d),
           (lay + ("attn", "wv"), (L, d, Hkv, D), "normal", d),
           (lay + ("attn", "wo"), (L, H, D, d), "normal", H * D),
           (lay + ("ln2", "scale"), (L, d), "ones", 0)]
    if a["E"]:
        E = a["E"]
        out += [(lay + ("moe", "router"), (L, d, E), "normal", d),
                (lay + ("moe", "wi"), (L, E, d, 2 * ff), "normal", d),
                (lay + ("moe", "wo"), (L, E, ff, d), "normal", ff)]
    else:
        out += [(lay + ("mlp", "wi"), (L, d, 2 * ff), "normal", d),
                (lay + ("mlp", "wo"), (L, ff, d), "normal", ff)]
    out.append((("ln_f", "scale"), (d,), "ones", 0))
    if not a["tied"]:
        out.append((("unembed",), (d, a["Vp"]), "normal", d))
    return out


def count(config: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in leaf_table(config))


def _put(tree, path, value) -> None:
    for i, k in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(tree, list):
            while len(tree) <= k:
                tree.append({})
            tree = tree[k]
        else:
            tree = tree.setdefault(k, [] if isinstance(nxt, int) else {})
    tree[path[-1]] = value


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def make(config: dict, seed: int, device) -> dict:
    """The weights tree on ``device``, bf16."""
    device = torch.device(device)
    table = leaf_table(config)
    n = sum(math.prod(s) for _, s, init, _ in table if init == "normal")
    g = torch.Generator(device).manual_seed(seed)
    buf = torch.empty(n, dtype=torch.bfloat16, device=device)
    for i in range(0, n, DRAW):
        buf[i:i + DRAW].normal_(generator=g)
    tree: dict = {}
    off = 0
    for path, shape, init, fan_in in table:
        if init == "ones":
            t = torch.ones(shape, dtype=torch.bfloat16, device=device)
        else:
            m = math.prod(shape)
            t = buf[off:off + m].view(shape)
            t.mul_(1.0 / math.sqrt(fan_in))
            off += m
        _put(tree, path, t)
    return tree


def named_leaves(tree: dict, config: dict) -> List[Tuple[str, torch.Tensor]]:
    return [(".".join(str(k) for k in path), get(tree, path))
            for path, _, _, _ in leaf_table(config)]
