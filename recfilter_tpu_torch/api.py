"""Public API: the RecFilter builder (the subset the port runs).

Declare dimensions, set the initialization, append causal/anticausal
scans, tile, then run:

    F[y, x] = image                      # F(x,y) = image(x,y)
    F.add_filter(+x, coeff)
    F.split(x, 128, y, 128)
    module = F.as_func()                 # an nn.Module, on the card
    out = F.realize()                    # on the card; device="cpu" asks

Routing follows the JAX package (:func:`.dimfuse.fused_filter_module`): a
tiled float filter goes to the fused executors —
:class:`.overlap2d.Fused2DPx` for the trailing two axes, the rows pass
:class:`.overlap2d.FusedRowsPx` then ``Fused2DPx`` for volumes, and one
stage per scanned axis otherwise (the rows pass on non-last axes,
:class:`.dimfuse.FusedLastAxis` on the last: 1-D signals such as
``F[x] = signal``, channels on leading axes). ``cascade`` splits a filter
into a chain of filters run one after another. ``as_func`` also takes the
JAX package's fused consumers — an elementwise ``epilogue``, a 1-D
``stencil`` under ``Plan.rotate_emit`` (``set_plan(rotate_emit=2)``: the
rotated emit, :class:`.dimfuse.RotatedPass`), a 2-D ``stencil2d`` bank.
What the port does not run yet raises ``NotImplementedError``.
``as_func``, ``realize`` and ``profile`` run on the card unless the caller
asks for the CPU; asking for ``"cuda"`` without a card raises, and nothing
moves to the CPU on its own.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from . import dimfuse, planner
from .spec import BorderMode, Dim, DimAndCausality, FilterSpec, make_scan
from .utils import timing


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false")
    return d


class RecFilter:
    """An n-D recursive filter under construction / ready to run."""

    def __init__(self, name: str = "RecFilter"):
        self._name = name
        self._spec: Optional[FilterSpec] = None
        self._image = None
        self._plan = planner.Plan()
        self._clamped_border = False
        self._module: Optional[nn.Module] = None
        # the previous filter of a cascade: realize() with no input runs
        # it first and filters its output
        self._chain_parent: Optional["RecFilter"] = None

    @property
    def name(self) -> str:
        return self._name

    @property
    def spec(self) -> FilterSpec:
        if self._spec is None:
            raise RuntimeError(
                f"Recursive filter {self._name} has no definition yet; "
                "set one with F[x, y] = image")
        return self._spec

    @property
    def plan(self) -> planner.Plan:
        return self._plan

    # ---------------------------------------------------------------- define
    def __setitem__(self, dims, value):
        """``F[y, x] = image`` — dims in array-axis order; ``value`` is an
        array (numpy or torch) of the dims' extents, or a callable taking
        one index grid per dim."""
        if not isinstance(dims, tuple):
            dims = (dims,)
        self.define(dims, value)

    def define(self, dims: Sequence[Dim], value):
        if self._spec is not None and self._spec.scans:
            raise RuntimeError(f"Recursive filter {self._name} already defined")
        dims = tuple(dims)
        if callable(value) and not hasattr(value, "shape"):
            grids = np.meshgrid(*[np.arange(d.extent) for d in dims],
                                indexing="ij")
            value = value(*grids)
        if isinstance(value, (tuple, list)):
            raise NotImplementedError(
                "Tuple filters are not ported yet (ROADMAP Queue 1 item 7)")
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        expect = tuple(d.extent for d in dims)
        if tuple(value.shape[: len(dims)]) != expect:
            raise ValueError(
                f"Initialization shape {tuple(value.shape)} does not match "
                f"dim extents {expect} for filter {self._name}")
        self._image = value
        self._spec = FilterSpec(
            name=self._name, dims=dims, scans=(),
            border=BorderMode.CLAMP if self._clamped_border else BorderMode.ZERO,
            dtype=str(value.dtype).replace("torch.", ""),
            tile_widths=(0,) * len(dims),
        )
        self._module = None
        return self

    def set_clamped_image_border(self):
        """Clamp out-of-range taps to the image edge. Must precede scans."""
        if self._spec is not None and self._spec.scans:
            raise RuntimeError(f"Recursive filter {self._name} already defined")
        self._clamped_border = True
        if self._spec is not None:
            self._spec = dataclasses.replace(self._spec,
                                             border=BorderMode.CLAMP)
        self._module = None

    def add_filter(self, x: Union[Dim, DimAndCausality], coeff):
        """Append a scan ``v[x] = b0 v[x] + Σ a_j v[x∓(j+1)]``; ``x`` is
        ``+dim``/``-dim`` or a bare Dim (causal)."""
        if isinstance(x, Dim):
            x = DimAndCausality(x, True)
        self._spec = self.spec.with_scan(make_scan(self.spec, x, coeff))
        self._module = None
        return self

    def split(self, *args):
        """Tile dimensions: ``split(x, 128, y, 128)`` or ``split({x: 128})``.
        Widths need not divide extents (zero borders pad)."""
        spec = self.spec
        tiles = list(spec.tile_widths or (0,) * spec.ndim)
        if len(args) == 1 and isinstance(args[0], dict):
            pairs = list(args[0].items())
        else:
            if len(args) % 2:
                raise ValueError("split expects (dim, width) pairs")
            pairs = list(zip(args[::2], args[1::2]))
        for d, t in pairs:
            tiles[spec.axis_of(d)] = int(t)
        self._spec = spec.with_tiles(tuple(tiles))
        self._module = None
        return self

    def split_all_dimensions(self, tile_width: int):
        """Tile every scanned dimension with one width."""
        spec = self.spec
        scanned = {s.axis for s in spec.scans}
        tiles = [tile_width if i in scanned else t
                 for i, t in enumerate(spec.tile_widths or (0,) * spec.ndim)]
        self._spec = spec.with_tiles(tuple(tiles))
        self._module = None
        return self

    def set_plan(self, **kw):
        """Set Plan fields (``backend=``, ``matmul_precision=``,
        ``rotate_emit=``)."""
        self._plan = self._plan.with_(**kw)
        self._module = None
        return self

    # ------------------------------------------------------------- execution
    def as_func(self, epilogue=None, stencil=None, stencil2d=None, *,
                device="cuda") -> nn.Module:
        """The filter as an ``nn.Module`` on ``device`` (the card unless
        the caller asks for the CPU); it holds its host-built matrices as
        buffers and runs ``module(x, *eaux)``.

        ``epilogue(out, *eaux)`` — an elementwise combine of the filter
        output (the reference's ``compute_at`` of a pointwise consumer);
        the eaux arrays share the OUTPUT layout (rotated when
        ``Plan.rotate_emit`` is set). ``stencil`` — a shifted-tap consumer
        along the scanned axis, ``{"taps": [(offset, coeff), ...],
        "start": "zero"|"clamp", "end": "zero"|"clamp"}`` (taps may be per
        leading slice), fused into the rotated completion kernel; it needs
        ``Plan.rotate_emit`` and applies before the epilogue. ``stencil2d``
        — per channel 2-D shifted-tap banks ``[[(dy, dx, coeff), ...],
        ...]`` over the trailing two axes (positive offsets clamp at the
        far edges, negative offsets read zero); the module then returns a
        tuple of channels. Exclusive with the other two and with
        ``rotate_emit``."""
        spec, plan = self.spec, self._plan
        if stencil is not None and not plan.rotate_emit:
            raise ValueError("stencil consumers require Plan.rotate_emit "
                             "(single-dimension filters)")
        if stencil2d is not None and (epilogue is not None
                                      or stencil is not None):
            raise ValueError(
                "stencil2d is mutually exclusive with epilogue/stencil")
        if stencil2d is not None and plan.rotate_emit:
            raise ValueError("stencil2d applies to the natural output "
                             "layout; unset Plan.rotate_emit")
        if plan.rotate_emit:
            mod = dimfuse.RotatedPass(spec, plan.rotate_emit,
                                      plan.matmul_precision, epilogue,
                                      stencil)
        else:
            if not spec.tiled:
                raise NotImplementedError(
                    "untiled filters run the JAX package's lax.scan "
                    "executor, not ported yet (ROADMAP Queue 1 item 15); "
                    "call split()")
            mod = dimfuse.fused_filter_module(spec, plan.matmul_precision,
                                              epilogue=epilogue,
                                              stencil2d=stencil2d)
        return mod.to(resolve_device(device))

    def _input(self, input, device: torch.device) -> torch.Tensor:
        x = self._image if input is None else input
        if x is None:
            raise RuntimeError(f"filter {self._name} has no bound image")
        return torch.as_tensor(x).to(device)

    def _func(self, device: torch.device) -> nn.Module:
        if self._module is None:
            self._module = self.as_func(device=device)
        return self._module.to(device)

    def realize(self, input=None, *, device="cuda") -> torch.Tensor:
        """Run the filter on the bound (or given) image on ``device``. A
        cascade stage given no input filters its parent's output."""
        d = resolve_device(device)
        if input is None and self._chain_parent is not None:
            input = self._chain_parent.realize(device=d)
        with torch.no_grad():
            return self._func(d)(self._input(input, d))

    def profile(self, iterations: int = 1, *, device="cuda") -> float:
        """Warm-up + ``iterations`` timed calls on a CUDA device (CUDA
        events); prints and returns the total ms. The rate is MiP/s for
        images and Msamples/s (10^6 samples per second) for 1-D signals;
        an integer filter's line adds its type and the GB/s of one read
        and one write of the array."""
        d = resolve_device(device)
        fn, x = self._func(d), self._input(None, d)
        with torch.no_grad():
            ms = timing.benchmark(fn, x, iterations=iterations)
        pixels = int(np.prod([e.extent for e in self.spec.dims])) * iterations
        rate = (f"{timing.mpix_per_sec(ms, pixels):.2f} Msamples/s"
                if self.spec.ndim == 1
                else f"{timing.throughput(ms, pixels):.2f} MiP/s")
        if self.spec.dtype in dimfuse._INT_DTYPES:
            nbytes = 2 * pixels * torch.iinfo(
                dimfuse._INT_DTYPES[self.spec.dtype]).bits // 8
            rate += (f", {self.spec.dtype}, "
                     f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s in + out")
        print(f"{self._name}: {ms:.3f} ms for {iterations} iterations "
              f"({rate}) on {torch.cuda.get_device_name(d)}")
        return ms

    # ------------------------------------------------------- reorder/cascade
    def cascade(self, *scan_groups) -> List["RecFilter"]:
        """Split this filter's scans into a chain of filters, one per group
        of scan indices, each realized on the previous one's output. Legal
        when every scan appears exactly once and the relative order of
        opposite-causality scans in one dimension is kept (``ValueError``
        otherwise)."""
        spec = self.spec
        if (len(scan_groups) == 1 and isinstance(scan_groups[0], (list, tuple))
                and scan_groups[0]
                and isinstance(scan_groups[0][0], (list, tuple))):
            scan_groups = tuple(scan_groups[0])
        groups = [list(g) for g in scan_groups]
        flat = [i for g in groups for i in g]
        if sorted(flat) != list(range(len(spec.scans))):
            raise ValueError(
                "cascade: each scan must appear in exactly one group")
        order_of = {s: gi for gi, g in enumerate(groups) for s in g}
        pos_in = {s: groups[order_of[s]].index(s) for s in flat}
        for i, si in enumerate(spec.scans):
            for j in range(i + 1, len(spec.scans)):
                sj = spec.scans[j]
                if (si.axis == sj.axis and si.causal != sj.causal
                        and (order_of[j], pos_in[j])
                        < (order_of[i], pos_in[i])):
                    raise ValueError(
                        "cascade: cannot swap opposite-causality scans "
                        f"{i} and {j} in the same dimension")
        out: List[RecFilter] = []
        for gi, g in enumerate(groups):
            f = RecFilter(f"{self._name}_{gi}")
            f._clamped_border = self._clamped_border
            f._image = self._image
            f._spec = dataclasses.replace(
                spec, name=f._name, scans=tuple(spec.scans[i] for i in g))
            f._plan = self._plan
            f._chain_parent = out[-1] if out else None
            out.append(f)
        return out

    def cascade_by_causality(self) -> List["RecFilter"]:
        """One filter per causality class: the causal scans, then the
        anticausal ones."""
        scans = self.spec.scans
        causal = [i for i, s in enumerate(scans) if s.causal]
        anticausal = [i for i, s in enumerate(scans) if not s.causal]
        return self.cascade(*[g for g in (causal, anticausal) if g])

    def cascade_by_dimension(self) -> List["RecFilter"]:
        """One filter per scanned dimension, in order of first
        appearance."""
        return self.cascade(*self.spec.scans_by_axis().values())
