"""Semiring algebra underlying blocked Floyd-Warshall, as torch ops.

The five semirings of ``repro.core.semiring`` with the same names and
identities:

  * ``MIN_PLUS``  — all-pairs shortest paths
  * ``MAX_PLUS``  — critical / longest paths
  * ``MAX_MIN``   — maximum-capacity (bottleneck) paths
  * ``OR_AND``    — transitive closure on {0,1} (kept arithmetic: max/min)
  * ``PLUS_MUL``  — ordinary linear algebra

and their storage lowerings (``lower_semiring``): the saturating int16
tropical ones (``MIN_PLUS_I16`` …, sentinels ``I16_INF`` / ``I16_NINF``),
the bit-packed transitive closure ``OR_AND_PACKED`` (32 graphs per int32
word, ⊕ = OR, ⊗ = AND) and the identity lowering of every float dtype.

Integer storage.  or_and and plus_mul have finite identities, so the
reference keeps an integer input's dtype for them (bool, int8, uint8,
int16, int32, uint32; int64 arrives as int32).  The port computes those on
an int32 carrier (``int_carrier``, ``to_carrier``, ``from_carrier``) and
converts back, which is exact: or_and's max / min only select values, and
plus_mul's wrapping add and multiply mod 2³² truncate to mod 2⁸ / 2¹⁶.
Two storages need care: uint32 or_and flips bit 31 on the way in and out
(signed order on the carrier = unsigned order on the storage, and the
identities flip with it), and bool plus_mul runs as or_and (XLA's bool add
and multiply are OR and AND).

``relax(acc, a, b)`` is the one step every kernel chain is built from,
``add(acc, mul(a, b))``.  For plus_mul in f32 it is ``torch.addcmul``: a
single rounded fused multiply-add, as XLA contracts ``c + a*b`` inside
``jit`` and the CUDA kernels compute with ``__fmaf_rn``.  In bf16 XLA does
not contract: ⊗ rounds to the storage type and ⊕ rounds again, and so does
the port (``acc + a * b`` in torch's 16-bit ops, which compute in f32 and
round each result).  In f16 it is one f16 FMA again, rounded once from
the exact ``c + a*b``: what XLA's CPU backend makes of the reference's
jitted f16 ``c + a*b`` on a CPU with AVX-512 FP16, and ``__hfma`` on the
card.

min and max are XLA's: NaN propagates, and between equal operands the
result's sign bit is the OR of the two sign bits for min and their AND for
max (min(+0, -0) = -0 and max(+0, -0) = +0 in either argument order).
``torch.minimum`` / ``torch.maximum`` on the CPU return the sign of one
fixed argument instead, so the float ones fix the sign through the bit
view.  Integers have no signed zero.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

Tensor = torch.Tensor

# int16 tropical sentinels: ⊕-identities of min_plus / max_plus.  The
# saturating ⊗ clamps finite sums into [I16_NINF, I16_INF] and propagates
# the sentinels exactly, so no sum wraps past them.
I16_INF = 32767
I16_NINF = -32768

# Graphs per element of the bit-packed or_and lowering (int32 lanes).
PACK_LANES = 32

_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _signed(x: Tensor, y: Tensor, combine) -> Tensor:
    """Where x == y, the float whose bits are combine(bits x, bits y)."""
    ix, iy = (t.view(_BITS[t.element_size()]) for t in (x, y))
    return combine(ix, iy).view(x.dtype)


def minimum(x: Tensor, y: Tensor) -> Tensor:
    """XLA's min: NaN propagates; min(+0, -0) = -0 in either order."""
    m = torch.minimum(x, y)
    if not m.is_floating_point():
        return m
    x, y = torch.broadcast_tensors(x, y)
    return torch.where(x == y, _signed(x, y, torch.bitwise_or), m)


def maximum(x: Tensor, y: Tensor) -> Tensor:
    """XLA's max: NaN propagates; max(+0, -0) = +0 in either order."""
    m = torch.maximum(x, y)
    if not m.is_floating_point():
        return m
    x, y = torch.broadcast_tensors(x, y)
    return torch.where(x == y, _signed(x, y, torch.bitwise_and), m)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A semiring (⊕, ⊗, 0̄, 1̄) with broadcasting torch operators.

    name: identifier shared with the reference package.
    add / mul: the ⊕ / ⊗ combiners.
    zero: identity of ⊕ (annihilator of ⊗); one: identity of ⊗.
    relax: ``acc ⊕ (a ⊗ b)`` in one step.
    dtype: the storage dtype a lowering is pinned to ("int16", "int32"),
      None for the float semirings, which take any float dtype.
    lanes: graphs carried per element (32 for the packed or_and lowering).
    """

    name: str
    add: Callable[[Tensor, Tensor], Tensor]
    mul: Callable[[Tensor, Tensor], Tensor]
    zero: float | int
    one: float | int
    relax: Callable[[Tensor, Tensor, Tensor], Tensor]
    dtype: str | None = None
    lanes: int = 1

    @property
    def packed(self) -> bool:
        """True iff this lowering bit-packs several graphs per element."""
        return self.lanes > 1


def _relax_with(add, mul):
    def relax(acc: Tensor, a: Tensor, b: Tensor) -> Tensor:
        return add(acc, mul(a, b))

    return relax


def _round_f16(x: Tensor) -> Tensor:
    """f64 → f16 rounded once, to nearest even.  ``x.to(torch.float16)``
    rounds through f32 (twice, which can land on an f16 tie that x is not
    on), so round to odd at f32 first: 24 bits, at least two more than
    f16's 11, make the second rounding the correct one."""
    r = x.to(torch.float32)
    inexact = (r.to(torch.float64) != x) & ~torch.isnan(x)
    bits = r.view(torch.int32)
    # r even and inexact: the odd neighbour on x's side (bits count up
    # with the magnitude in either sign).
    toward = torch.where(r.abs().to(torch.float64) > x.abs(), -1, 1).to(torch.int32)
    bits = torch.where(inexact & (bits & 1 == 0), bits + toward, bits)
    return bits.view(torch.float32).to(torch.float16)


def _plus_mul_relax(acc: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """One FMA in f32 (and f64) and in f16; two rounded ops in bf16.

    f16: round(c + a·b) from the exact value, as XLA's CPU backend
    contracts the reference's jitted f16 ``c + a*b`` into one f16 FMA on a
    CPU with AVX-512 FP16 (and HFMA does on the card).  In f64 the product
    of two f16 values is exact and so is the sum wherever the f16 rounding
    can tell (the f16 range spans fewer than 53 bits), so one correct
    rounding of the f64 result is that FMA."""
    if acc.element_size() >= 4:
        return torch.addcmul(acc, a, b)
    if acc.dtype == torch.float16:
        return _round_f16(acc.double() + a.double() * b.double())
    return acc + a * b


MIN_PLUS = Semiring(
    "min_plus", minimum, torch.add, float("inf"), 0.0, _relax_with(minimum, torch.add),
)
MAX_PLUS = Semiring(
    "max_plus", maximum, torch.add, float("-inf"), 0.0, _relax_with(maximum, torch.add),
)
MAX_MIN = Semiring(
    "max_min", maximum, minimum, float("-inf"), float("inf"), _relax_with(maximum, minimum),
)
OR_AND = Semiring(
    "or_and", maximum, minimum, 0.0, 1.0, _relax_with(maximum, minimum),
)
PLUS_MUL = Semiring("plus_mul", torch.add, torch.mul, 0.0, 1.0, _plus_mul_relax)

SEMIRINGS = {s.name: s for s in (MIN_PLUS, MAX_PLUS, MAX_MIN, OR_AND, PLUS_MUL)}

# Bit-packed transitive closure: bit g of element [i, j] is "edge i→j in
# graph g" for 32 independent graphs; OR / AND relax all 32 lanes at once.
# ⊕-identity 0 = no edge in any graph; ⊗-identity -1 = all bits set.
OR_AND_PACKED = Semiring(
    "or_and_packed", torch.bitwise_or, torch.bitwise_and, 0, -1,
    _relax_with(torch.bitwise_or, torch.bitwise_and), dtype="int32", lanes=PACK_LANES,
)


def _sat_tropical_mul(dominant: int, other: int):
    """Saturating int16 ⊗: widen to int32, add, clamp to [I16_NINF,
    I16_INF], then the sentinels override — ``other`` first, ``dominant``
    (the lowering's ⊕-identity) last, so INF ⊗ NINF is the ⊕-identity and
    a missing edge never turns into a finite path."""

    def mul(a: Tensor, b: Tensor) -> Tensor:
        s = (a.to(torch.int32) + b.to(torch.int32)).clamp(I16_NINF, I16_INF).to(torch.int16)
        s = torch.where((a == other) | (b == other), other, s)
        return torch.where((a == dominant) | (b == dominant), dominant, s)

    return mul


def _lowered(sr: Semiring, name: str, *, mul=None, zero, one) -> Semiring:
    mul = mul or sr.mul
    return dataclasses.replace(sr, name=name, mul=mul, zero=zero, one=one,
                               relax=_relax_with(sr.add, mul), dtype="int16")


MIN_PLUS_I16 = _lowered(MIN_PLUS, "min_plus_i16", mul=_sat_tropical_mul(I16_INF, I16_NINF),
                        zero=I16_INF, one=0)
MAX_PLUS_I16 = _lowered(MAX_PLUS, "max_plus_i16", mul=_sat_tropical_mul(I16_NINF, I16_INF),
                        zero=I16_NINF, one=0)
# max_min / or_and need no arithmetic: int16 min/max cannot overflow.
MAX_MIN_I16 = _lowered(MAX_MIN, "max_min_i16", zero=I16_NINF, one=I16_INF)
OR_AND_I16 = _lowered(OR_AND, "or_and_i16", zero=0, one=1)

_I16_LOWERINGS = {
    "min_plus": MIN_PLUS_I16,
    "max_plus": MAX_PLUS_I16,
    "max_min": MAX_MIN_I16,
    "or_and": OR_AND_I16,
}

LOWERED_SEMIRINGS = {
    s.name: s for s in (OR_AND_PACKED, MIN_PLUS_I16, MAX_PLUS_I16, MAX_MIN_I16, OR_AND_I16)
}

FLOAT_DTYPES = ("float32", "float64", "bfloat16", "float16")


def dtype_name(dtype) -> str:
    """'float32' for torch.float32, np.float32, np.dtype('float32') or the
    string; likewise for other dtypes."""
    name = getattr(dtype, "__name__", None) or getattr(dtype, "name", None)
    return str(name or dtype).removeprefix("torch.")


@functools.cache
def lower_semiring(sr: Semiring, dtype=None, *, packed: bool = False) -> Semiring:
    """The storage-lowering map: (semiring, dtype, packed) → the semiring
    the kernels run; cached, so one request always returns one object.

      * ``packed=True`` — or_and only → ``OR_AND_PACKED`` (int32 words).
      * int16 → the saturating lowerings (plus_mul has none).
      * float dtypes and ``dtype=None`` → the semiring itself.
    """
    if packed:
        if sr.name not in ("or_and", "or_and_packed"):
            raise ValueError(
                f"packed=True is the bit-packed transitive-closure lowering; "
                f"it requires the or_and semiring, not {sr.name!r}"
            )
        if dtype is not None and dtype_name(dtype) != "int32":
            raise ValueError(
                f"the packed or_and lowering stores int32 bit lanes, got dtype={dtype!r}"
            )
        return OR_AND_PACKED
    if dtype is None or sr.dtype is not None:
        return sr
    name = dtype_name(dtype)
    if name in FLOAT_DTYPES:
        return sr
    if name == "int16":
        try:
            return _I16_LOWERINGS[sr.name]
        except KeyError:
            raise ValueError(
                f"no int16 lowering for semiring {sr.name!r} (plus_mul needs true "
                f"ring arithmetic; 16-bit overflow is unsound)"
            ) from None
    raise ValueError(
        f"no {name} lowering for semiring {sr.name!r}; supported narrow dtypes: "
        f"int16 (saturating tropical), bfloat16, float16, and packed int32 or_and "
        f"(packed=True)"
    )


def resolve_semiring(semiring: Semiring | str) -> Semiring:
    """A ``Semiring`` or its name (a lowering's too) → the ``Semiring``."""
    if not isinstance(semiring, str):
        return semiring
    sr = SEMIRINGS.get(semiring) or LOWERED_SEMIRINGS.get(semiring)
    if sr is None:
        raise ValueError(
            f"unknown semiring {semiring!r}; have "
            f"{sorted(SEMIRINGS) + sorted(LOWERED_SEMIRINGS)}"
        )
    return sr


# ------------------------------------------------------- integer storage
_SIGN = -(1 << 31)  # bit 31 of an int32

# uint32 or_and on its carrier: bit 31 flipped, so are the identities.
_OR_AND_FLIPPED = dataclasses.replace(OR_AND, zero=_SIGN, one=_SIGN + 1)


def int_storage(dtype: torch.dtype, semiring: Semiring) -> bool:
    """True for an integer (or bool) storage of a float semiring: or_and or
    plus_mul in the reference's integer storage, run on an int32 carrier."""
    return semiring.dtype is None and not dtype.is_floating_point


def int_carrier(semiring: Semiring, dtype: torch.dtype) -> Semiring:
    """The semiring the int32 carrier of a ``dtype`` storage runs."""
    if dtype == torch.bool and semiring.name == "plus_mul":
        return OR_AND
    if dtype == torch.uint32 and semiring.name == "or_and":
        return _OR_AND_FLIPPED
    return semiring


def to_carrier(t: Tensor, semiring: Semiring) -> Tensor:
    """The int32 carrier of an integer storage tensor (a new tensor)."""
    if t.dtype == torch.uint32:
        c = t.contiguous().view(torch.int32)
        return c ^ _SIGN if semiring.name == "or_and" else c.clone()
    return t.to(torch.int32)


def from_carrier(c: Tensor, dtype: torch.dtype, semiring: Semiring) -> Tensor:
    """Inverse of ``to_carrier``: the carrier's values in ``dtype`` (wrapping
    truncation for the narrow integers, nonzero for bool)."""
    if dtype == torch.uint32:
        c = c ^ _SIGN if semiring.name == "or_and" else c
        return c.contiguous().view(torch.uint32)
    if dtype == torch.bool:
        return c != 0
    return c.to(dtype)
