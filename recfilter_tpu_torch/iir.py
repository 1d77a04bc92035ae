"""IIR coefficient derivation (host-side scalar math, float64).

Van Vliet–Young pole rescaling for the recursive Gaussian approximation,
iterated-box width selection, integral-image binomial coefficients and the
z-domain polynomial multiply that merges two cascaded filters.
"""

from __future__ import annotations

import math
from typing import List, Sequence


def _binomial_coeff(n: int, i: int, r: float) -> float:
    """i-th coefficient of the expansion of (1 - r·x)^n."""
    return ((-r) ** i) * float(math.comb(n, i))


def qs(s: float) -> float:
    """Recursive-filter scaling factor for Gaussian sigma ``s``."""
    return 0.00399341 + 0.4715161 * s


def pole_rescale(d: complex, s: float) -> complex:
    """Rescale a complex z-plane pole for sigma ``s``."""
    q = qs(s)
    r = abs(d) ** (1.0 / q)
    th = math.atan2(d.imag, d.real) / q
    return complex(r * math.cos(th), r * math.sin(th))


def pole_rescale_real(d: float, s: float) -> float:
    """Rescale a real z-plane pole for sigma ``s``."""
    return d ** (1.0 / qs(s))


def weights1(s: float) -> "tuple[float, float]":
    """First-order recursive Gaussian weights (b0, a1)."""
    d = pole_rescale_real(1.86543, s)
    return -(1.0 - d) / d, -1.0 / d


def weights2(s: float) -> "tuple[float, float, float]":
    """Second-order recursive Gaussian weights (b0, a1, a2)."""
    d = pole_rescale(complex(1.41650, 1.00829), s)
    n2 = abs(d) ** 2
    re = d.real
    return (1.0 - 2.0 * re + n2) / n2, -2.0 * re / n2, 1.0 / n2


def weights3(s: float) -> "tuple[float, float, float, float]":
    """Third-order weights = first-order ∘ second-order."""
    b10, a11 = weights1(s)
    b20, a21, a22 = weights2(s)
    return b10 * b20, a11 + a21, a11 * a21 + a22, a11 * a22


def gaussian_weights(sigma: float, order: int) -> List[float]:
    """[b0, a1..ak] for a recursive Gaussian of the given order, with the
    feedback signs that plug directly into ``add_filter`` scans
    ``v[x] = b0 v[x] + Σ a_j v[x-j-1]``."""
    if order == 1:
        w = list(weights1(sigma))
    elif order == 2:
        w = list(weights2(sigma))
    else:
        w = list(weights3(sigma))
    return [w[0]] + [-a for a in w[1:]]


def gaussian_box_filter(k: int, sigma: float) -> int:
    """Width of a box filter so that k iterated applications approximate a
    Gaussian of the given sigma."""
    total = 0.0
    alpha = 0.005
    for i in range(int(math.floor((float(k) - 1.0) / 2.0)) + 1):
        f = float(math.comb(k, i))
        p = ((-1.0) ** i) / float(math.factorial(k - 1))
        total += p * f * ((float(k) / 2.0 - i) ** (k - 1))
    total = math.sqrt(2.0 * math.pi) * (total + alpha) * sigma
    return int(math.ceil(total))


def integral_image_coeff(n: int) -> List[float]:
    """[b0=1, a1..an] for an n-th order integral image: feedback is the
    negated binomial expansion of (1-x)^n."""
    return [1.0] + [-_binomial_coeff(n, i, 1.0) for i in range(1, n + 1)]


def overlap_feedback_coeff(a: Sequence[float],
                           b: Sequence[float]) -> List[float]:
    """Merge two cascaded filters' feedback coefficient lists into one: the
    negated tail of the product of the denominator polynomials
    (1 - Σ a_j z^-j)(1 - Σ b_j z^-j)."""
    pa = [1.0] + [-float(x) for x in a]
    pb = [1.0] + [-float(x) for x in b]
    c = [0.0] * (len(pa) + len(pb) - 1)
    for i in range(len(c)):
        for j in range(i + 1):
            if j < len(pa) and i - j < len(pb):
                c[i] += pa[j] * pb[i - j]
    return [-x for x in c[1:]]
