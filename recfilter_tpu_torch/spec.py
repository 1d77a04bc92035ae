"""Declarative filter IR: dimensions, scans, and the FilterSpec.

A recursive filter is a pure initialization plus an ordered list of
causal/anticausal scans, each with a feedforward coefficient and ``order``
feedback coefficients. The spec is immutable, hashable data; the JSON form
is the same one ``recfilter_tpu.spec.spec_to_json`` writes, so a filter
built in the JAX package runs unchanged here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence, Tuple

import numpy as np


class BorderMode:
    """Boundary handling for scans.

    ZERO   — samples before the array start contribute nothing.
    CLAMP  — out-of-range taps clamp to the array edge.
    """

    ZERO = "zero"
    CLAMP = "clamp"


@dataclasses.dataclass(frozen=True)
class Dim:
    """A named filter dimension with a static extent. Unary ``+``/``-``
    select the causal/anticausal scan direction."""

    name: str
    extent: int

    def __pos__(self) -> "DimAndCausality":
        return DimAndCausality(self, True)

    def __neg__(self) -> "DimAndCausality":
        return DimAndCausality(self, False)

    def __repr__(self) -> str:
        return f"Dim({self.name}, {self.extent})"


@dataclasses.dataclass(frozen=True)
class DimAndCausality:
    """A dimension paired with a scan direction."""

    dim: Dim
    causal: bool

    def __repr__(self) -> str:
        sign = "+" if self.causal else "-"
        return f"{sign}{self.dim.name}"


@dataclasses.dataclass(frozen=True)
class Scan:
    """One recursive scan: v[x] = b0*v[x] + sum_j a_j * v[x -/+ (j+1)].

    ``feedfwd`` is b0 and ``feedback`` is (a_1 .. a_k); ``order`` == k.
    ``axis`` is the index of the scanned dimension in the filter's dims.
    """

    axis: int
    causal: bool
    feedfwd: float
    feedback: Tuple[float, ...]

    @property
    def order(self) -> int:
        return len(self.feedback)

    def __repr__(self) -> str:
        sign = "+" if self.causal else "-"
        fb = ",".join(f"{a:g}" for a in self.feedback)
        return f"Scan({sign}axis{self.axis}, b0={self.feedfwd:g}, a=[{fb}])"


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Complete static description of a recursive filter: name, dims,
    ordered scans, border mode, dtype name, and per-dim tile widths once
    ``split`` has been applied (0 = untiled)."""

    name: str
    dims: Tuple[Dim, ...]
    scans: Tuple[Scan, ...]
    border: str = BorderMode.ZERO
    dtype: str = "float32"
    tile_widths: Tuple[int, ...] = ()  # per-dim; () means untiled
    tuple_width: int = 0  # >0: Tuple output with that many components

    def __post_init__(self):
        if self.tile_widths and len(self.tile_widths) != len(self.dims):
            raise ValueError("tile_widths must match number of dims")

    def stacked(self) -> "FilterSpec":
        """Executor view of a Tuple filter: the components ride a leading
        channel dimension (every scan applies identically to each
        component, as Halide Tuples do) and scan axes shift by one."""
        if not self.tuple_width:
            return self
        return FilterSpec(
            name=self.name,
            dims=(Dim("__tuple__", self.tuple_width),) + self.dims,
            scans=tuple(dataclasses.replace(s, axis=s.axis + 1)
                        for s in self.scans),
            border=self.border,
            dtype=self.dtype,
            tile_widths=((0,) + self.tile_widths) if self.tile_widths else (),
            tuple_width=0,
        )

    @property
    def tiled(self) -> bool:
        return any(t > 0 for t in self.tile_widths)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def axis_of(self, dim: Dim) -> int:
        for i, d in enumerate(self.dims):
            if d.name == dim.name:
                return i
        raise ValueError(
            f"Variable {dim.name} is not one of the dimensions of "
            f"the recursive filter {self.name}"
        )

    def scans_by_axis(self) -> "dict[int, list[int]]":
        """Group scan indices by dimension, preserving within-dim order
        (cross-dimension scans commute: they are tensor products of 1-D
        linear operators)."""
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(self.scans):
            groups.setdefault(s.axis, []).append(i)
        return groups

    def with_scan(self, scan: Scan) -> "FilterSpec":
        return dataclasses.replace(self, scans=self.scans + (scan,))

    def with_tiles(self, tile_widths: Tuple[int, ...]) -> "FilterSpec":
        return dataclasses.replace(self, tile_widths=tuple(tile_widths))

    def feedfwd_coeff(self) -> np.ndarray:
        """Per-scan feedforward coefficients, shape (num_scans,)."""
        return np.array([s.feedfwd for s in self.scans], dtype=np.float64)

    def feedback_coeff(self) -> np.ndarray:
        """Per-scan feedback coefficients, shape (num_scans, max_order),
        rows zero-padded to the max order."""
        max_order = max((s.order for s in self.scans), default=0)
        out = np.zeros((len(self.scans), max_order), dtype=np.float64)
        for i, s in enumerate(self.scans):
            out[i, : s.order] = s.feedback
        return out


def spec_to_json(spec: FilterSpec) -> str:
    """Serialize a FilterSpec to JSON (the JAX package's format)."""
    return json.dumps(
        {
            "name": spec.name,
            "dims": [[d.name, d.extent] for d in spec.dims],
            "scans": [
                {
                    "axis": s.axis,
                    "causal": s.causal,
                    "feedfwd": s.feedfwd,
                    "feedback": list(s.feedback),
                }
                for s in spec.scans
            ],
            "border": spec.border,
            "dtype": spec.dtype,
            "tile_widths": list(spec.tile_widths),
            "tuple_width": spec.tuple_width,
        }
    )


def spec_from_json(text: str) -> FilterSpec:
    """Inverse of :func:`spec_to_json`; reads the JAX package's JSON too."""
    d = json.loads(text)
    return FilterSpec(
        name=d["name"],
        dims=tuple(Dim(n, e) for n, e in d["dims"]),
        scans=tuple(
            Scan(s["axis"], s["causal"], s["feedfwd"], tuple(s["feedback"]))
            for s in d["scans"]
        ),
        border=d["border"],
        dtype=d["dtype"],
        tile_widths=tuple(d["tile_widths"]),
        tuple_width=d.get("tuple_width", 0),
    )


def spec_from_arrays(dims: Sequence[Dim], axes: Sequence[int],
                     causal: Sequence[bool], feedfwd: np.ndarray,
                     feedback: np.ndarray, border: str = BorderMode.ZERO,
                     tile_widths: Sequence[int] = (),
                     name: str = "RecFilter",
                     dtype: str = "float32") -> FilterSpec:
    """Build a FilterSpec from per-scan coefficient arrays — the layout of
    ``FilterSpec.feedfwd_coeff()`` (num_scans,) and ``feedback_coeff()``
    (num_scans, max_order). A scan's order is its row's length up to the
    last nonzero coefficient, so zero-padded rows round-trip."""
    ff = np.asarray(feedfwd, np.float64).reshape(-1)
    fb = np.asarray(feedback, np.float64)
    if fb.ndim != 2 or not (len(axes) == len(causal) == ff.size
                            == fb.shape[0]):
        raise ValueError(
            f"per-scan arrays disagree: axes {len(axes)}, causal "
            f"{len(causal)}, feedfwd {ff.shape}, feedback {fb.shape}")
    scans = []
    for i in range(ff.size):
        nz = np.flatnonzero(fb[i])
        k = int(nz[-1]) + 1 if nz.size else 0
        if k == 0:
            raise ValueError(f"scan {i} has no feedback coefficient")
        scans.append(Scan(int(axes[i]), bool(causal[i]), float(ff[i]),
                          tuple(float(c) for c in fb[i, :k])))
    dims = tuple(dims)
    return FilterSpec(name=name, dims=dims, scans=tuple(scans),
                      border=border, dtype=dtype,
                      tile_widths=tuple(tile_widths) or (0,) * len(dims))


def make_scan(spec: FilterSpec, dx: DimAndCausality, coeff) -> Scan:
    """Build a Scan from a (+dim / -dim) and a [b0, a1, ..., ak] list."""
    coeff = [float(c) for c in np.asarray(coeff).ravel()]
    if len(coeff) < 2:
        raise ValueError(
            f"Cannot add scan to recursive filter {spec.name} without "
            "feed forward and feedback coefficients"
        )
    axis = spec.axis_of(dx.dim)
    return Scan(
        axis=axis,
        causal=dx.causal,
        feedfwd=coeff[0],
        feedback=tuple(coeff[1:]),
    )
