"""Execution plan and the schedule object.

The port runs the JAX package's executor backends, chosen by
``Plan.backend`` (``RecFilter.set_plan(backend=...)``, or a schedule
directive — ``compute_locally`` selects ``pallas``):

  * ``auto`` / ``einsum`` — the fused executors (``dimfuse``): the
    3-touch 2-D pair and the rows pass (``overlap2d``) on the fp32 kernels
    of ``kernels/final2d.py``, the last-axis passes and the rotation chain
    on those of ``kernels/completion.py``. ``auto`` resolves to ``scan``
    for an untiled filter (:func:`resolve_backend`);
  * ``pallas`` — the strip passes of ``kernels/fused.py``
    (``dim_pass_rows`` / ``dim_pass_cols``), one per scanned axis;
  * ``overlap`` / ``overlap_k`` — ``overlap2d.OverlapFilter``: scanned
    axes paired, both carries of a pair from one read; ``overlap_k`` runs
    the pair on the px pair where its gates hold at ``px6``, ``px4`` or
    ``px3``, else — ``default`` and every other grade too, as the JAX
    package's ``fused_2d_pass`` maps them — on ``moments2d_k`` /
    ``final2d_k`` (``final2d_k_bf16`` at ``matmul_dtype="bfloat16"``),
    ``overlap`` as float64 einsums;
  * ``blocked`` — the blocked algebra (``tiling.py``), float64 einsums;
  * ``scan`` — the sequential core (``scan_core.ScanFilter``);
  * ``oracle`` — the float64 numpy oracle (``scan_core.oracle_apply``).

The JAX package's precision names are kept: ``px6`` (its default) and
``highest`` both mean true-f32 products, which the fp32 kernels give on
Hopper without the TPU's bf16 chunk splitting. As in the JAX package, the
fused executors' px kernels (and the supertile hierarchy) run at ``px6``:
at ``highest`` every fused pass runs its einsum form in float64 and no
kernel launches, and ``overlap_k`` runs its HIGHEST kernel pair.

The reduced grades ``px3``, ``px4`` and ``default`` (the throughput mode)
are the JAX package's split-bf16 product counts 3, 4 and 1
(``kernels/split.py``), on bf16 tensor cores: the 3-touch 2-D executor
(``overlap2d.Fused2DPx`` on ``final2d_split``, ``final2d_split_epi`` with
an affine epilogue, ``final2d_stencil`` at the grade with a fused
``stencil2d`` bank), volumes (the rows pass
``overlap2d.FusedRowsPx`` on ``rows_final`` at the grade, then the 2-D
executor), the rows pass of the per-axis loop at px3 and px4 (at
``default`` the JAX package runs its einsum pass there), the unrotated
last-axis pass (``dimfuse.LastAxisPass`` on ``completion_split``,
``completion_split_epi``), the FIR band pass (``fir.FirPass`` on
``fir_band`` at the grade, ``tap_scale`` read), and
the rotated one — the rotation chain (a volume's trailing pair after its
rows pass included), the per-axis loop's non-last axes
(``dimfuse.FusedAxisPass``) and ``rotate_emit`` — on ``completion_rot``,
``completion_rot_epi`` and ``completion_rot_tails`` at the grade (at
``default`` only where the JAX package finds a structural win: a fused
stencil or chained tails); where a pass's kernels do not apply (fewer
than 8 lines, other tiles than 128, ΣK > 56, or at ``default`` no
structural win) it takes its einsum form at the grade's products, as in
the JAX package. The ``pallas`` backend's strip passes sum in fp64 at
every grade and run there as at px6 (the JAX package's strip kernels read
no grade); the ``overlap_k`` backend runs its HIGHEST pair at
``default`` (the JAX package's px pair takes px3, px4 and px6 only).
Every other route raises
``NotImplementedError`` at those grades, naming ROADMAP Queue 1 item 4;
no route runs another grade in their place. The routes are allowed where
the grade enters: ``dimfuse.fused_filter_module``,
``api.backend_module`` (:data:`SPLIT_BACKENDS`) and ``LastAxisPass``
admit those and refuse the rest.

The split-einsum grades ``f32x3``, ``f32x4``, ``f32x6`` and ``high`` (TPU
HIGH: three bf16 products) are the JAX package's ``_split_einsum``: with
no kernel product count (its ``_kernel_nprod`` is 0) every fused pass
takes its einsum form — the rotation chain and the per-axis loop, as at
``highest`` — its signal-sized products as that many bf16 chunk products
in float32 (``dimfuse.EINSUM_NPROD``), its carry solves and injections in
float64. ``f32x9`` (the integer limbs' drop-free grade) runs those
products in float64. The FIR band pass runs ``fir_band`` at ``f32x6`` as
at px6 and at ``f32x3`` and ``f32x4`` as at px3 and px4 (the JAX
package's product counts).

``matmul_dtype="bfloat16"`` (bf16 products), as in the JAX package, is
read by the ``overlap`` and ``overlap_k`` backends alone, and there by
the HIGHEST pair alone: ``final2d_k_bf16`` rounds x, the dim-A
completion Z and the image-sized constants to bf16, with fp32
accumulation and the carry rows in fp32; the px pair and the pair
fallback ignore it. ``fir.FirPass(matmul_dtype="bfloat16")`` on a
float32 image runs ``fir_band`` at one product (x rounded to bf16 on
chip), its einsum form on bf16-rounded operands with a float32 output.

Storage types (the filter's dtype): float32 runs the grades above. bf16
storage (the JAX package's production bf16 mode: the image in bf16
between passes, float32 sums and float64 solves) runs ONE product
whatever ``matmul_precision`` says (:func:`storage_nprod`, the JAX
package's ``_kernel_nprod``, without the structural rule of float32
``default``) on the 3-touch 2-D executor and volumes — ``moments2d``,
``final2d_split`` (``_epi``), ``rows_tails`` and ``rows_final`` reading
and writing bf16 — and on the rotation chain, the per-axis loop and
``rotate_emit`` — the rows pass on a non-last axis, ``tails``,
``completion_split`` (``_epi``), ``completion_rot`` (``_epi``) and
``completion_rot_tails`` reading and writing bf16, wherever their kernel
gates hold — and the stencil consumers on those routes: a fused
``stencil2d`` bank (``moments2d`` with its edge rows,
``final2d_stencil``), a rotated emit's fused stencil (``tails_extra``,
``completion_rot``'s stencil body, with and without its epilogue), a
``stencil2d`` bank after the filter (``stencil2d``), each reading bf16 and
writing bf16 rounded once; the stencil fallbacks take the taps in float32
on the bf16 output and round once. The FIR band pass reads a bf16 image on
``fir_band_bf16`` at one product (bf16 taps, fp32 sums, each output
rounded once), its einsum form past the kernel's gates on bf16 operands
with float32 sums, rounded once. Where a pass's kernels do not apply, its
einsum form (``dimfuse.LastAxisPass``: other tiles than 128, more than
256 tiles, ΣK > 56, fewer than 8 lines, a rotated leading group) runs
the image-sized products on bf16-rounded data and constants with float32
sums and rounds the output once; its carries (the tails' solve and
injection) stay float64, as on every bf16 kernel route of the port (the
JAX package rounds them to bf16: ROADMAP Queue 3). The sequential core
runs in float32 and casts back, and the other backends (``pallas``,
``overlap``, ``overlap_k``, ``blocked``, ``scan``, ``oracle``) run their
float32 route on the input cast to float32, the output cast to bf16 (the
JAX package's ``cdt``). float16 storage runs the float32 route at the
requested grade on the input cast to float32, and casts the output back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

_SUPPORTED_PRECISIONS = ("px6", "highest", "px3", "px4", "default",
                         "high", "f32x3", "f32x4", "f32x6", "f32x9")

# The reduced grades: split-bf16 products on the 2-D executor, the rows
# pass and the last-axis passes (module docstring).
SPLIT_GRADES = ("px3", "px4", "default")
SPLIT_ITEM = "ROADMAP Queue 1 item 4"
# The backends (besides ``einsum``) a reduced grade runs on: ``overlap_k``
# (its 3-touch executor, else a refusal) and those that read no grade,
# ``pallas`` among them (its strips sum in fp64 at every grade).
SPLIT_BACKENDS = ("overlap_k", "overlap", "pallas", "blocked", "scan",
                  "oracle")


def refuse_split(matmul_precision: str, route: str) -> None:
    """Raise ``NotImplementedError`` where ``route`` has no split-bf16 form
    and ``matmul_precision`` is a reduced grade (module docstring)."""
    if matmul_precision in SPLIT_GRADES:
        raise NotImplementedError(
            f"{route} has no split-bf16 form at matmul_precision="
            f"{matmul_precision!r}: {SPLIT_ITEM} (the reduced grades run "
            "the 3-touch 2-D executor, volumes, the rows pass at px3 and px4, "
            "the last-axis passes and the rotation chain)")


def storage_nprod(dtype: str, matmul_precision: str) -> int:
    """The kernels' product count for a filter of ``dtype`` at
    ``matmul_precision`` (module docstring): bf16 storage one, whatever
    the grade; float32 and float16 (which runs as float32) the grade's
    :data:`.kernels.split.NPROD`, 0 where no kernel grade applies."""
    from .kernels.split import NPROD

    if dtype == "bfloat16":
        return 1
    return NPROD.get(matmul_precision, 0)



BACKENDS = ("auto", "einsum", "pallas", "overlap", "overlap_k", "blocked",
            "scan", "oracle")


def check_precision(matmul_precision: str) -> None:
    """Raise unless the port runs ``matmul_precision``."""
    if matmul_precision not in _SUPPORTED_PRECISIONS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Static execution plan for a filter.

    ``backend``: one of :data:`BACKENDS` (module docstring).
    ``line_block``: lines per block of the ``pallas`` strip kernels; 0
    picks them from the line count (``kernels/fused.pick_line_block``), a
    request is quantised to the kernels' line quantum and clamped to what
    shared memory holds. Set by ``schedule.vectorize(var, width)``.
    ``unroll``: the JAX package's unroll of the ``pallas`` tile-carry
    loop; it changes no result, and on the card it has no effect (the
    CUDA tile loop is a runtime loop). Set by ``schedule.unroll(var,
    factor)``.
    ``matmul_dtype``: "float32" or "bfloat16" (bf16 products). As in the
    JAX package only the ``overlap`` and ``overlap_k`` backends read it,
    and of their executors only the HIGHEST pair (``overlap_k``'s
    ``final2d_k_bf16``); the px pair, the pair fallback and every other
    backend ignore it (module docstring).
    ``matmul_precision``: "px6" (default), "highest", a reduced grade
    "px3", "px4", "default", or a split-einsum grade "f32x3", "f32x4",
    "f32x6", "high", "f32x9" (module docstring).
    ``rotate_emit``: layout chaining for single-dimension filters (the
    reference's ``storage_layout`` directive): nonzero opts into the
    contract that the INPUT carries the scanned dimension as its LAST
    axis, and the result is emitted with the trailing ``rotate_emit`` axes
    rotated one step (``dimfuse.RotatedPass``) — an x-scan filter and a
    y-scan filter with ``rotate_emit=2`` chain with no relayout between
    them. 0 (default) emits in the natural layout."""

    backend: str = "auto"
    line_block: int = 0
    unroll: int = 1
    matmul_dtype: str = "float32"
    matmul_precision: str = "px6"
    rotate_emit: int = 0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of "
                             f"{BACKENDS}")
        if self.matmul_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown matmul_dtype {self.matmul_dtype!r}")
        check_precision(self.matmul_precision)
        for name in ("rotate_emit", "line_block"):
            v = getattr(self, name)
            if int(v) != v or v < 0:
                raise ValueError(f"{name} must be an int ≥ 0, got {v!r}")
        if int(self.unroll) != self.unroll or self.unroll < 1:
            raise ValueError(f"unroll must be an int ≥ 1, got "
                             f"{self.unroll!r}")

    def with_(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)


def resolve_backend(spec, plan: Plan) -> str:
    """The executor for ``plan.backend``; ``auto`` picks the fused
    (``einsum``) executors for a tiled filter, integers included, and the
    sequential core (``scan``) for an untiled one — the JAX package's
    rule."""
    if plan.backend != "auto":
        return plan.backend
    return "einsum" if spec.tiled else "scan"


def default_tile_width(extent: int, platform: str) -> int:
    """Auto tile width: 128 on the TPU and on CUDA (the kernels' tile is
    128 × 128), the reference's 32 elsewhere."""
    t = 128 if platform in ("tpu", "cuda") else 32
    return max(min(t, extent), 1)


def auto_tile_width(extent: int) -> int:
    """:func:`default_tile_width` for the port's platform: the kernels'
    tile of 128 wherever they run (the CPU runs their twins on the same
    tiles), so no card is probed."""
    return default_tile_width(extent, "cuda")


class ScheduleVar:
    """A tag-addressed loop variable handle (the reference's VarTag)."""

    def __init__(self, tag: str, index: Optional[int] = None):
        self.tag = tag
        self.index = index

    def split_var(self) -> "ScheduleVar":
        return ScheduleVar(self.tag + "_split", self.index)

    def __repr__(self) -> str:
        i = "" if self.index is None else f"({self.index})"
        return f"{self.tag}{i}"


class RecFilterSchedule:
    """Chainable, recorded schedule over a set of stages selected by tag:
    the reference's ``RecFilterSchedule`` directive API, kept for source
    parity as the JAX package keeps it.

    The reference places loops on GPU blocks, threads and registers by
    hand; here the CUDA kernels fix their own launch shapes, so a
    directive either sets a :class:`Plan` field — ``compute_locally`` →
    ``pallas`` (the strip kernels), ``compute_globally`` → ``einsum``,
    ``vectorize(width=)`` → ``line_block``, ``unroll(factor=)`` →
    ``unroll`` — or is a recorded no-op that says what does its job on
    the card. Every directive lands in the owner's schedule log with that
    note (``RecFilter.print_schedule``)."""

    def __init__(self, owner, selector: str):
        self._owner = owner  # RecFilter
        self._selector = selector  # "intra(1)" | "intra(2)" | "inter" | "full"
        self._log: List[str] = []

    def _rec(self, directive: str, mapping: str = "") -> "RecFilterSchedule":
        """Record ``directive`` with its mapping note: the Plan field it
        set, or why it is a no-op on the card."""
        self._log.append(directive)
        note = f"  # {mapping}" if mapping else ""
        self._owner._schedule_log.append(
            f"{self._selector}: {directive}{note}")
        return self

    def _set(self, **kw) -> None:
        self._owner.set_plan(**kw)

    def compute_locally(self) -> "RecFilterSchedule":
        """Keep the stage on chip next to its consumer (the reference's
        ``compute_at`` into gpu_blocks): selects the ``pallas`` strip
        kernels, whose intra-tile terms never touch device memory."""
        if self._selector.startswith("intra"):
            self._set(backend="pallas")
            return self._rec("compute_locally()", "-> Plan.backend='pallas'")
        return self._rec(
            "compute_locally()",
            "no-op: inter-tile carries live in device memory by "
            "construction")

    def compute_globally(self) -> "RecFilterSchedule":
        """Materialize the stage in device memory (``compute_root``): the
        fused einsum executors' behaviour."""
        if self._selector.startswith("intra"):
            self._set(backend="einsum")
            return self._rec("compute_globally()",
                             "-> Plan.backend='einsum'")
        return self._rec("compute_globally()",
                         "no-op: inter-tile stages already live in device "
                         "memory")

    def unroll(self, var=None, factor: int = 0) -> "RecFilterSchedule":
        if factor:
            self._set(unroll=factor)
            return self._rec(f"unroll({var})",
                             f"-> Plan.unroll={factor} (pallas backend; no "
                             "effect on the card's runtime tile loop)")
        return self._rec(
            f"unroll({var})",
            "no-op without factor: nvcc unrolls the kernels' inner loops; "
            "pass factor= to set Plan.unroll")

    def vectorize(self, var=None, width: int = 0) -> "RecFilterSchedule":
        if width:
            self._set(line_block=width)
            return self._rec(
                f"vectorize({var})",
                f"-> Plan.line_block={width} (pallas lines per block)")
        return self._rec(
            f"vectorize({var})",
            "no-op without width: the kernels load float4 vectors "
            "themselves; pass width= to set Plan.line_block for the pallas "
            "backend")

    def gpu_threads(self, *vars) -> "RecFilterSchedule":
        return self._rec(
            f"gpu_threads{vars}",
            "no-op: each CUDA kernel fixes its own thread layout (256 "
            "threads, a register tile each)")

    def gpu_blocks(self, *vars) -> "RecFilterSchedule":
        return self._rec(
            f"gpu_blocks{vars}",
            "no-op: each CUDA kernel's grid covers the tiles or line "
            "blocks; tile sizes come from RecFilter.split()")

    def parallel(self, var=None, factor: int = 0) -> "RecFilterSchedule":
        return self._rec(
            f"parallel({var})",
            "no-op on one card: the kernels' blocks run in parallel; "
            "multi-card sharding is ROADMAP Queue 1 item 14")

    def split(self, var, factor: int) -> "RecFilterSchedule":
        return self._rec(
            f"split({var}, {factor})",
            "no-op: loop splitting is tiling — use RecFilter.split(dim, w)")

    def fuse(self, a, b) -> "RecFilterSchedule":
        return self._rec(f"fuse({a}, {b})",
                         "no-op: each kernel fuses its own loops")

    def rename(self, a, b=None) -> "RecFilterSchedule":
        """Loop-variable rename (the reference builds gpu_blocks/threads
        as parallel().rename())."""
        return self._rec(f"rename({a}, {b})",
                         "no-op: the kernels name no loop variables")

    def reorder(self, *vars) -> "RecFilterSchedule":
        return self._rec(
            f"reorder{vars}",
            "no-op: each kernel fixes its loop order; pass order is the "
            "scan list order (see RecFilter.cascade)")

    def reorder_storage(self, *vars) -> "RecFilterSchedule":
        """Storage-order directive. The port's layout knob is
        ``Plan.rotate_emit`` (rotated-emit pipeline chaining, set via
        ``set_plan``); each kernel owns its intra-pass layout."""
        return self._rec(
            f"reorder_storage{vars}",
            "no-op: each kernel owns its intra-pass layout; inter-pass "
            "layout is Plan.rotate_emit (set_plan(rotate_emit=...))")

    def storage_layout(self, *args) -> "RecFilterSchedule":
        """See :meth:`reorder_storage` and ``Plan.rotate_emit``."""
        return self._rec(
            f"storage_layout{args}",
            "no-op: see reorder_storage — the layout knob is "
            "Plan.rotate_emit")

    def __repr__(self) -> str:
        body = "\n".join(f"    .{d}" for d in self._log)
        return f"RecFilterSchedule[{self._selector}]\n{body}"
