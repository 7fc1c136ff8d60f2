"""Semiring algebra underlying blocked Floyd-Warshall, as torch ops.

The five f32 semirings of ``repro.core.semiring`` with the same names and
identities:

  * ``MIN_PLUS``  — all-pairs shortest paths
  * ``MAX_PLUS``  — critical / longest paths
  * ``MAX_MIN``   — maximum-capacity (bottleneck) paths
  * ``OR_AND``    — transitive closure on {0,1} (kept arithmetic: max/min)
  * ``PLUS_MUL``  — ordinary linear algebra

``relax(acc, a, b)`` is the one step every kernel chain is built from,
``add(acc, mul(a, b))``.  For plus_mul it is ``torch.addcmul``: a single
rounded fused multiply-add.  That is what the reference computes — XLA
contracts ``c + a*b`` into one FMA inside ``jit`` — and what the CUDA
kernels compute with ``__fmaf_rn``.  Two roundings would differ from the
reference in the last bit.  min/max are ``torch.minimum``/``torch.maximum``,
which propagate NaN as ``jnp.minimum``/``jnp.maximum`` do.

The int16 / bit-packed storage lowerings are not ported yet (ROADMAP A.4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A semiring (⊕, ⊗, 0̄, 1̄) with broadcasting torch operators.

    name: identifier shared with the reference package.
    add / mul: the ⊕ / ⊗ combiners.
    zero: identity of ⊕ (annihilator of ⊗); one: identity of ⊗.
    relax: ``acc ⊕ (a ⊗ b)`` in one step (an FMA for plus_mul).
    """

    name: str
    add: Callable[[Tensor, Tensor], Tensor]
    mul: Callable[[Tensor, Tensor], Tensor]
    zero: float
    one: float
    relax: Callable[[Tensor, Tensor, Tensor], Tensor]


def _relax_with(add, mul):
    def relax(acc: Tensor, a: Tensor, b: Tensor) -> Tensor:
        return add(acc, mul(a, b))

    return relax


MIN_PLUS = Semiring(
    "min_plus", torch.minimum, torch.add, float("inf"), 0.0,
    _relax_with(torch.minimum, torch.add),
)
MAX_PLUS = Semiring(
    "max_plus", torch.maximum, torch.add, float("-inf"), 0.0,
    _relax_with(torch.maximum, torch.add),
)
MAX_MIN = Semiring(
    "max_min", torch.maximum, torch.minimum, float("-inf"), float("inf"),
    _relax_with(torch.maximum, torch.minimum),
)
OR_AND = Semiring(
    "or_and", torch.maximum, torch.minimum, 0.0, 1.0,
    _relax_with(torch.maximum, torch.minimum),
)
PLUS_MUL = Semiring(
    "plus_mul", torch.add, torch.mul, 0.0, 1.0, torch.addcmul,
)

SEMIRINGS = {s.name: s for s in (MIN_PLUS, MAX_PLUS, MAX_MIN, OR_AND, PLUS_MUL)}

# Names of the reference's storage lowerings, which the port does not have yet.
LOWERED_SEMIRINGS = (
    "or_and_packed", "min_plus_i16", "max_plus_i16", "max_min_i16", "or_and_i16",
)


def dtype_name(dtype) -> str:
    """'float32' for torch.float32, np.float32, np.dtype('float32') or the
    string; likewise for other dtypes."""
    name = getattr(dtype, "__name__", None) or getattr(dtype, "name", None)
    return str(name or dtype).removeprefix("torch.")


def lower_semiring(sr: Semiring, dtype=None, *, packed: bool = False) -> Semiring:
    """The storage-lowering map; only the f32 identity lowering is ported."""
    if packed or (dtype is not None and dtype_name(dtype) != "float32"):
        raise NotImplementedError(
            f"storage lowering dtype={dtype!r}, packed={packed} is not ported "
            f"yet (ROADMAP A.4); the port solves in float32"
        )
    return sr


def resolve_semiring(semiring: Semiring | str) -> Semiring:
    """A ``Semiring`` or its name → the ``Semiring``."""
    if not isinstance(semiring, str):
        return semiring
    if semiring in LOWERED_SEMIRINGS:
        raise NotImplementedError(
            f"semiring {semiring!r} is a storage lowering, not ported yet "
            f"(ROADMAP A.4)"
        )
    try:
        return SEMIRINGS[semiring]
    except KeyError:
        raise ValueError(
            f"unknown semiring {semiring!r}; have {sorted(SEMIRINGS)}"
        ) from None
