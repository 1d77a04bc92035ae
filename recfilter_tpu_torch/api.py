"""Public API: the RecFilter builder (the subset the port runs).

Declare dimensions, set the initialization, append causal/anticausal
scans, tile, then run:

    F[y, x] = image                      # F(x,y) = image(x,y)
    F.add_filter(+x, coeff)
    F.split(x, 128, y, 128)
    module = F.as_func()                 # an nn.Module, on the card
    out = F.realize()                    # on the card; device="cpu" asks

``Plan.backend`` picks the executor as the JAX package's ``as_func``
does (``set_plan(backend=...)``, or the schedule directives of
``intra_schedule`` / ``inter_schedule`` / ``full_schedule``:
``compute_locally`` selects ``pallas``): ``auto`` runs the fused
executors for a tiled filter and the sequential core for an untiled one;
``pallas`` the strip kernels (:class:`.kernels.fused.StripFilter`),
``overlap`` / ``overlap_k`` the paired executors
(:class:`.overlap2d.OverlapFilter`), ``blocked`` the blocked algebra,
``scan`` the core, ``oracle`` the float64 oracle. On the fused
executors (:func:`.dimfuse.fused_filter_module`) a tiled float filter
goes to —
:class:`.overlap2d.Fused2DPx` for the trailing two axes, the rows pass
:class:`.overlap2d.FusedRowsPx` then ``Fused2DPx`` for volumes, and one
stage per scanned axis otherwise (the rows pass on non-last axes,
:class:`.dimfuse.FusedLastAxis` on the last: 1-D signals such as
``F[x] = signal``, channels on leading axes). ``cascade`` splits a filter
into a chain of filters run one after another, :func:`fuse_cascade` merges
such a chain back into one filter, and ``overlap_to_higher_order_filter``
merges two filters into one of higher order. ``as_func`` also takes the
JAX package's fused consumers — an elementwise ``epilogue`` (inside the
final kernel where its structure is affine, :mod:`.epilogue`), a 1-D
``stencil`` under ``Plan.rotate_emit`` (``set_plan(rotate_emit=2)``: the
rotated emit, :class:`.dimfuse.RotatedPass`), a 2-D ``stencil2d`` bank —
and ``compute_at`` dispatches a consumer to them. A Tuple definition
(``F[y, x] = (a, b)``) filters each component alike (:class:`TupleFilter`).
The filter's dtype is its image's: float32, an integer type, bf16 (bf16
storage, the JAX package's bf16 mode: every fused route at one product,
a bf16 output; ``as_func()``'s module casts its input to bf16; the other
backends run float32 cast in and out) or float16 (the float32 route, cast
in and out). ``Plan.matmul_dtype="bfloat16"`` gives the ``overlap``
backends' HIGHEST pair bf16 products (:mod:`.planner`).
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

from . import dimfuse, iir, planner, scan_core
from .epilogue import affine_form, arity, is_elementwise
from .spec import (BorderMode, Dim, DimAndCausality, FilterSpec, Scan,
                   make_scan)
from .utils import timing


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _stack_components(value):
    """A Tuple's components stacked on a leading axis (a tensor where any
    component is one, else a numpy array); they must agree in shape and
    dtype."""
    comps = [v if isinstance(v, torch.Tensor) else np.asarray(v)
             for v in value]
    if any(tuple(c.shape) != tuple(comps[0].shape)
           or _dtype_name(c) != _dtype_name(comps[0]) for c in comps):
        raise ValueError(
            "Tuple components must have identical shape and dtype")
    if any(isinstance(c, torch.Tensor) for c in comps):
        return torch.stack([torch.as_tensor(c) for c in comps])
    return np.stack(comps)


class TupleFilter(nn.Module):
    """A Tuple filter's executor (the JAX package's Tuple routes of
    ``as_func``): every scan applies alike to each of the k components.
    ``forward(value)`` takes a tuple or list of component tensors, or
    their stack on a leading axis, and ``tuple_route`` says how it runs:

      * ``"plain"`` — the stacked pass (``body`` on the stacked spec);
        returns the tuple of filtered components;
      * ``"linear-folded"`` — the epilogue ``Σᵢ cᵢ·uᵢ`` is linear by its
        structure (:func:`.epilogue.affine_form`, no bias), so it commutes
        with the filter: ``body`` is the single-component filter, run once
        on ``Σᵢ cᵢ·xᵢ``;
      * ``"staged"`` — the stacked pass, then ``epilogue(*components)``.
    """

    def __init__(self, body: nn.Module, k: int, route: str, epilogue=None,
                 weights=None):
        super().__init__()
        self.body, self.k, self.tuple_route = body, int(k), route
        self.epilogue, self.weights = epilogue, weights

    def forward(self, value):
        x = torch.as_tensor(_stack_components(value)
                            if isinstance(value, (tuple, list)) else value)
        if x.shape[0] != self.k:
            raise ValueError(f"expected {self.k} Tuple components, got "
                             f"{x.shape[0]}")
        if self.tuple_route == "linear-folded":
            xc = self.weights[0] * x[0]
            for c, v in zip(self.weights[1:], x[1:]):
                xc = xc + c * v
            return self.body(xc)
        y = self.body(x)
        comps = tuple(y[i] for i in range(self.k))
        return comps if self.epilogue is None else self.epilogue(*comps)


class EpilogueAfter(nn.Module):
    """``epilogue(body(x), *eaux)`` as torch ops — an epilogue on a
    backend whose executor takes none (the JAX package runs it after the
    filter there); the aux arrays moved to the output's device (and
    type, for a float output)."""

    epilogue_route = "torch"

    def __init__(self, body: nn.Module, epilogue):
        super().__init__()
        self.body, self.epilogue = body, epilogue

    def _combine(self, y, eaux):
        if y.is_floating_point():
            return dimfuse._epilogue(self.epilogue, y, eaux)
        return self.epilogue(y, *(torch.as_tensor(a).to(y.device)
                                  for a in eaux))

    def forward(self, x, *eaux):
        return self._combine(self.body(x), eaux)

    def forward_plain(self, x, *eaux):
        return self._combine(self.body.forward_plain(x), eaux)


def backend_module(spec: FilterSpec, plan: "planner.Plan") -> nn.Module:
    """The executor of a backend that takes no consumer (every backend
    but ``einsum`` and the rotated emit) for ``spec`` under ``plan``."""
    backend = planner.resolve_backend(spec, plan)
    if spec.dtype == "bfloat16":
        # the float32 route on the input cast to float32, the output cast
        # back (the JAX package's cdt on these backends)
        return dimfuse.StorageCast(backend_module(
            dataclasses.replace(spec, dtype="float32"), plan),
            torch.bfloat16)
    if (plan.matmul_precision in planner.SPLIT_GRADES
            and backend not in planner.SPLIT_BACKENDS):
        planner.refuse_split(plan.matmul_precision, f"the {backend} backend")
    if backend == "oracle":
        return scan_core.OracleFilter(spec)
    if backend == "scan":
        return scan_core.ScanFilter(spec)
    if backend == "pallas":
        from .kernels.fused import StripFilter

        return StripFilter(spec, plan.line_block)
    if backend in ("overlap", "overlap_k"):
        from .overlap2d import OverlapFilter

        return OverlapFilter(spec, use_kernels=backend == "overlap_k",
                             matmul_precision=plan.matmul_precision,
                             matmul_dtype=plan.matmul_dtype)
    if backend == "blocked":
        from .tiling import BlockedFilter

        return BlockedFilter(spec)
    raise ValueError(f"backend {backend!r} takes the fused executors")


class Composed(nn.Module):
    """``consumer(producer(x), *aux)``: a consumer run after the filter on
    its materialized output (``compute_at``'s composed route)."""

    def __init__(self, producer: nn.Module, consumer):
        super().__init__()
        self.producer, self.consumer = producer, consumer

    def forward(self, x, *aux):
        return self.consumer(self.producer(x), *aux)


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
        self._schedule_log: List[str] = []
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
        array (numpy or torch) of the dims' extents, a callable taking one
        index grid per dim, or a Tuple of such arrays (``F[y, x] = (a,
        b)``: components of one shape and dtype, filtered alike)."""
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
        tuple_width = 0
        if isinstance(value, (tuple, list)):
            tuple_width = len(value)
            value = _stack_components(value)
        elif not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        expect = tuple(d.extent for d in dims)
        got = value.shape[1:] if tuple_width else value.shape
        if tuple(got[: len(dims)]) != expect:
            raise ValueError(
                f"Initialization shape {tuple(value.shape)} does not match "
                f"dim extents {expect} for filter {self._name}")
        self._image = value
        self._spec = FilterSpec(
            name=self._name, dims=dims, scans=(),
            border=BorderMode.CLAMP if self._clamped_border else BorderMode.ZERO,
            dtype=_dtype_name(value),
            tile_widths=(0,) * len(dims),
            tuple_width=tuple_width,
        )
        self._module = None
        return self

    def set_image(self, image):
        """Bind (or rebind) the input image without redefining the filter
        (a Tuple filter's image: its components, or their stack)."""
        if isinstance(image, (tuple, list)):
            image = _stack_components(image)
        if self._spec is not None:
            expect = tuple(d.extent for d in self._spec.dims)
            shape = tuple(np.shape(image))
            got = shape[1:] if self._spec.tuple_width else shape
            if got[: len(expect)] != expect:
                raise ValueError(f"image shape {shape} does not match dim "
                                 f"extents {expect}")
        self._image = image
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
        """Set Plan fields (``backend=``, ``line_block=``, ``unroll=``,
        ``matmul_dtype=``, ``matmul_precision=``, ``rotate_emit=``)."""
        self._plan = self._plan.with_(**kw)
        self._module = None
        return self

    # ------------------------------------------------------------ scheduling
    def full_schedule(self) -> planner.RecFilterSchedule:
        if self.spec.tiled:
            raise RuntimeError(
                "Filter is tiled, use intra_schedule() and inter_schedule()")
        return planner.RecFilterSchedule(self, "full")

    def intra_schedule(self, id: int = 1) -> planner.RecFilterSchedule:
        if not self.spec.tiled:
            raise RuntimeError("Filter is not tiled, use full_schedule()")
        return planner.RecFilterSchedule(self, f"intra({id})")

    def inter_schedule(self) -> planner.RecFilterSchedule:
        if not self.spec.tiled:
            raise RuntimeError("Filter is not tiled, use full_schedule()")
        return planner.RecFilterSchedule(self, "inter")

    def auto_schedule(self, tile_width: int = 0):
        """The reference's auto scheduler: optionally tile every scanned
        dimension, and let the plan resolve the backend (``auto``)."""
        if tile_width:
            self.split_all_dimensions(tile_width)
        self.set_plan(backend="auto")
        self._schedule_log.append(f"auto_schedule({tile_width})")
        return self

    def gpu_auto_schedule(self, tile_width: int = 0):
        return self.auto_schedule(tile_width)

    def cpu_auto_schedule(self, tile_width: int = 0):
        return self.auto_schedule(tile_width)

    # Schedule-var handles (the reference's VarTag addressing).
    def full(self, i: Optional[int] = None):
        return planner.ScheduleVar("FULL", i)

    def inner(self, i: Optional[int] = None):
        return planner.ScheduleVar("INNER", i)

    def outer(self, i: Optional[int] = None):
        return planner.ScheduleVar("OUTER", i)

    def tail(self):
        return planner.ScheduleVar("TAIL")

    def inner_scan(self):
        return planner.ScheduleVar("INNER_SCAN")

    def outer_scan(self):
        return planner.ScheduleVar("OUTER_SCAN")

    def inner_channels(self):
        return planner.ScheduleVar("CHANNEL")

    @staticmethod
    def set_max_threads_per_cuda_warp(n: int):
        """Parity shim for the reference's setter: the value is checked as
        the reference checks it, and has no effect (the port's kernels fix
        their own thread counts)."""
        if n % 32:
            raise ValueError("max threads must be a multiple of 32")

    @staticmethod
    def set_vectorization_width(n: int):
        """Parity shim for the reference's setter: checked, no effect (the
        kernels pick their own vector loads)."""
        if not (0 < n <= 64 and n & (n - 1) == 0):
            raise ValueError("vectorization width must be a power of two "
                             "≤ 64")

    def print_schedule(self) -> str:
        """Print and return every schedule directive with its mapping
        note (the Plan field it set, or why it is a no-op on the card)."""
        s = "\n".join(self._schedule_log) or "(no schedule directives)"
        print(s)
        return s

    # ------------------------------------------------------------- execution
    def as_func(self, epilogue=None, stencil=None, stencil2d=None, *,
                device="cuda") -> nn.Module:
        """The filter as an ``nn.Module`` on ``device`` (the card unless
        the caller asks for the CPU); it holds its host-built matrices as
        buffers and runs ``module(x, *eaux)``.

        ``epilogue(out, *eaux)`` — an elementwise combine of the filter
        output (the reference's ``compute_at`` of a pointwise consumer);
        the eaux arrays share the OUTPUT layout (rotated when
        ``Plan.rotate_emit`` is set). Where its structure is affine,
        ``a·out + Σᵢ bᵢ·eauxᵢ + c`` (:func:`.epilogue.affine_form`, k ≤ 4),
        the final kernel applies it before its write; otherwise it runs
        as torch ops on the output. ``stencil`` — a shifted-tap consumer
        along the scanned axis, ``{"taps": [(offset, coeff), ...],
        "start": "zero"|"clamp", "end": "zero"|"clamp"}`` (taps may be per
        leading slice), fused into the rotated completion kernel; it needs
        ``Plan.rotate_emit`` and applies before the epilogue. ``stencil2d``
        — per channel 2-D shifted-tap banks ``[[(dy, dx, coeff), ...],
        ...]`` over the trailing two axes (positive offsets clamp at the
        far edges, negative offsets read zero); the module then returns a
        tuple of channels. Exclusive with the other two and with
        ``rotate_emit``.

        A Tuple filter returns a :class:`TupleFilter`: ``module(value)``
        on the components (a tuple, or their stack), and its
        ``epilogue(c_0, …, c_k-1)`` combines the filtered components —
        folded into the input where it is linear by its structure,
        ``tuple_route`` says which."""
        spec = self.spec
        if spec.tuple_width:
            if stencil is not None or stencil2d is not None:
                raise ValueError("a Tuple filter takes an epilogue over its "
                                 "components, no stencil consumer")
            return self._tuple_func(epilogue, device)
        return self._module_for(spec, epilogue, stencil, stencil2d, device)

    def _tuple_func(self, epilogue, device) -> "TupleFilter":
        spec, k = self.spec, self.spec.tuple_width
        if epilogue is not None:
            form = affine_form(epilogue, k)
            if form is not None and not form.bias:
                # a linear combine commutes with the (linear) filter: fold
                # it into the input and filter one component
                one = dataclasses.replace(spec, tuple_width=0)
                return TupleFilter(
                    self._module_for(one, device=device), k,
                    "linear-folded",
                    weights=(form.scale, *form.aux_weights))
        body = self._module_for(spec.stacked(), device=device)
        return TupleFilter(body, k, "plain" if epilogue is None else
                           "staged", epilogue=epilogue)

    def _module_for(self, spec: FilterSpec, epilogue=None, stencil=None,
                    stencil2d=None, device="cuda") -> nn.Module:
        """The executor of ``spec`` with its consumers, in the JAX
        package's ``_executor`` order: the rotated emit; the fused
        executors (``einsum``), which take every consumer; on every other
        backend a ``stencil2d`` bank (:class:`.dimfuse.Stencil2DAfter`) or
        an epilogue (:class:`EpilogueAfter`) after the filter; then the
        backend's own executor (:func:`backend_module`)."""
        plan = self._plan
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
        if plan.rotate_emit and plan.backend != "oracle":
            # the rotated contract holds on every backend, as in the JAX
            # package (its executor routes integers and no-plan axes)
            mod = dimfuse.RotatedPass(spec, plan.rotate_emit,
                                      plan.matmul_precision, epilogue,
                                      stencil)
        elif planner.resolve_backend(spec, plan) == "einsum":
            mod = dimfuse.fused_filter_module(spec, plan.matmul_precision,
                                              epilogue=epilogue,
                                              stencil2d=stencil2d)
        elif stencil is not None:
            raise ValueError("the oracle backend runs no stencil consumer")
        elif stencil2d is not None:
            # the bank after the filter: the stencil2d kernel on a 2-D
            # output, shifts otherwise
            mod = dimfuse.Stencil2DAfter(backend_module(spec, plan),
                                         stencil2d)
        elif epilogue is not None:
            mod = EpilogueAfter(backend_module(spec, plan), epilogue)
        else:
            mod = backend_module(spec, plan)
        return mod.to(resolve_device(device))

    def _input(self, input, device: torch.device) -> torch.Tensor:
        x = self._image if input is None else input
        if x is None:
            raise RuntimeError(f"filter {self._name} has no bound image")
        if isinstance(x, (tuple, list)):
            x = _stack_components(x)
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

    def compute_at(self, consumer, level=None, *, device="cuda"):
        """Fuse this filter into a consumer stage (the reference's
        ``RecFilter::compute_at``, which its unsharp mask uses to merge the
        blur's last kernel into the pointwise combine). The consumer is
        dispatched:

        * an elementwise callable ``consumer(filter_out, *aux)``
          (:func:`.epilogue.is_elementwise`: every node elementwise, the
          output's shape and dtype kept) becomes the executor's epilogue —
          inside the final kernel where its structure is affine;
        * a 2-D shifted-tap bank ``[[(dy, dx, coeff), ...], ...]`` fuses
          as ``stencil2d``;
        * anything else composes: the consumer runs on the filter's
          materialized output.

        ``level``: None or an inner/intra tag fuses at the final kernel;
        an outer, inter or root tag asks for the output materialized between
        the stages (composition); any other value raises ``ValueError``.
        Returns the module ``fn(input, *aux)``, its route in
        ``fn.fused_route`` ("epilogue", "stencil2d" or "composed")."""
        tag = None if level is None else str(getattr(level, "tag", level))
        if tag is not None:
            t = tag.lower()
            inner = any(k in t for k in ("intra", "inner", "thread",
                                         "vector"))
            outer = any(k in t for k in ("inter", "outer", "block", "root",
                                         "full"))
            if not inner and not outer:
                raise ValueError(
                    f"compute_at level {level!r}: expected an inner/intra "
                    "or outer/inter loop tag")
        else:
            inner, outer = True, False

        if isinstance(consumer, (list, tuple)):
            bank = [[(int(dy), int(dx), float(c)) for dy, dx, c in b]
                    for b in consumer]
            if outer:
                fn = dimfuse.Stencil2DAfter(self.as_func(device=device),
                                            bank)
                fn.fused_route = "composed"
                return fn
            fn = self.as_func(stencil2d=bank, device=device)
            fn.fused_route = "stencil2d"
            return fn

        n_aux = max((arity(consumer) or 1) - 1, 0)
        spec = self.spec
        if inner and is_elementwise(
                consumer, tuple(d.extent for d in spec.dims),
                getattr(torch, spec.dtype), n_aux):
            fn = self.as_func(epilogue=consumer, device=device)
            fn.fused_route = "epilogue"
            return fn
        fn = Composed(self.as_func(device=device), consumer)
        fn.fused_route = "composed"
        return fn

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
            name = f"{self._name}_{gi}"
            f = self._derived(name, dataclasses.replace(
                spec, name=name, scans=tuple(spec.scans[i] for i in g)))
            f._chain_parent = out[-1] if out else None
            out.append(f)
        return out

    def fuse_cascade(self, *others: "RecFilter", epilogue=None,
                     device="cuda") -> nn.Module:
        """Fuse this filter and the following cascade stages back into
        ONE executor (the module-level :func:`fuse_cascade`)."""
        return fuse_cascade([self, *others], epilogue=epilogue,
                            device=device)

    def overlap_to_higher_order_filter(self, other: "RecFilter",
                                       name: str = "O") -> "RecFilter":
        """Merge this filter with ``other`` into one higher-order filter:
        per scan (matched in dimension and causality) the feedforward
        coefficients multiply and the feedback polynomials convolve
        (:func:`.iir.overlap_feedback_coeff`)."""
        a, b = self.spec, other.spec
        if tuple(d.extent for d in a.dims) != tuple(d.extent for d in b.dims):
            raise ValueError("overlap: filters must have identical dims")
        if a.border != b.border:
            raise ValueError("overlap: filters must have identical border")
        if len(a.scans) != len(b.scans):
            raise ValueError("overlap: filters must have matching scan lists")
        merged = []
        for sa, sb in zip(a.scans, b.scans):
            if sa.axis != sb.axis or sa.causal != sb.causal:
                raise ValueError(
                    "overlap: scans must match in dimension and causality")
            fb = iir.overlap_feedback_coeff(list(sa.feedback),
                                            list(sb.feedback))
            merged.append(Scan(sa.axis, sa.causal, sa.feedfwd * sb.feedfwd,
                               tuple(fb)))
        return self._derived(name, dataclasses.replace(
            a, name=name, scans=tuple(merged)))

    def _derived(self, name: str, spec: FilterSpec) -> "RecFilter":
        """A new filter of ``spec`` with this one's border flag, image and
        plan."""
        f = RecFilter(name)
        f._clamped_border = self._clamped_border
        f._image = self._image
        f._spec = spec
        f._plan = self._plan
        return f

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


def fuse_cascade(filters: Sequence[RecFilter], epilogue=None, *,
                 device="cuda") -> nn.Module:
    """Fuse a cascade chain back into ONE executor.

    A filter is an ordered scan list, so the cascade Fk∘…∘F1 (each
    stage's input the previous stage's output) equals one filter whose
    scan list is the stages' concatenation. Run merged, the fused
    executors span what were stage boundaries: the cascade by dimension of
    the Gaussian runs as the 3-touch 2-D executor instead of two passes
    that each read and write the image. Stages must share dims, border,
    dtype and Tuple width. ``epilogue`` fuses a pointwise combine into the
    last pass (see :meth:`RecFilter.as_func`). The merged filter takes the
    first stage's plan without its rotated emit (it chains its layouts
    internally and emits naturally). Returns the module on ``device``."""
    fs = list(filters)
    if not fs:
        raise ValueError("fuse_cascade: no filters given")
    specs = [f.spec for f in fs]
    base = specs[0]
    for s in specs[1:]:
        if s.dims != base.dims:
            raise ValueError("fuse_cascade: stages must share dimensions")
        if s.border != base.border or s.dtype != base.dtype:
            raise ValueError("fuse_cascade: stages must share border/dtype")
        if s.tuple_width != base.tuple_width:
            raise ValueError("fuse_cascade: stages must share Tuple width")
    name = "_".join(f.name for f in fs)
    f = fs[0]._derived(name, dataclasses.replace(
        base, name=name, scans=tuple(sc for s in specs for sc in s.scans)))
    f._plan = f._plan.with_(rotate_emit=0)
    return f.as_func(epilogue, device=device)
