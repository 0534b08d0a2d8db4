"""Random weights from a seed, made by the benchmark on the device in one
draw, and handed alike to the system under test and to the reference.

A configuration's "init" rules (first match wins) set each leaf from the
one standard-normal draw: {"match": regex, "std": s} scales it,
{"match": regex, "fan_in": true} scales it by fan_in ** -0.5 (dim 0 is the
output, or dim 1 for a transposed conv named by "transposed"), and
{"match": regex, "fill": v} sets it to v (a number, or a list laid over the
leaf's first elements, the rest 0); {"match": regex, "glorot": true}
scales it by (2 / (fan_in + fan_out)) ** 0.5 (a matrix [out, in] or a
conv kernel [out, in, k, k, k]).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch


def _fan_in(name: str, shape: Tuple[int, ...], rule: dict) -> int:
    if rule.get("transposed") and re.search(rule["transposed"], name):
        return shape[0] * math.prod(shape[2:])
    return math.prod(shape[1:])


def make(shapes: Dict[str, Tuple[int, ...]], rules: List[dict], seed: int,
         device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    compiled = [(re.compile(r["match"]), r) for r in rules]
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        n = math.prod(shape)
        leaf = flat[offset:offset + n].view(shape)
        offset += n
        rule = next((r for rx, r in compiled if rx.search(name)), None)
        if rule is None:
            raise KeyError(f"no init rule matches {name}")
        if isinstance(rule.get("fill"), list):
            leaf.zero_().view(-1)[:len(rule["fill"])] = torch.tensor(rule["fill"], device=device)
        elif "fill" in rule:
            leaf.fill_(rule["fill"])
        elif rule.get("glorot"):
            field = math.prod(shape[2:])
            leaf.mul_((2.0 / ((shape[0] + shape[1]) * field)) ** 0.5)
        elif rule.get("fan_in"):
            leaf.mul_(_fan_in(name, shape, rule) ** -0.5)
        else:
            leaf.mul_(rule["std"])
        out[name] = leaf
    return out
