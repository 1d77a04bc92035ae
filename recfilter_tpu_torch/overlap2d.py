"""The 3-touch 2-D executor: both dimensions' carries from one read.

For a filter with scans on dims A (rows, axis -2) then B (columns, axis -1)
— cross-dimension scans commute — the dim-B local tails of the dim-A
completed image Z are carry-sized expressions:

    Gb ∘_B Z = Btot_A ∘_A (Gb ∘_B x) + Rhat_A ∘_A (Gb ∘_B N_A)

so the whole filter reads the image three times:

    pass 1 (read x):   dim-A tails b_A, dim-B term Btot_A·(x·G_Bᵀ)   kernel
    solves (tiny):     N_A = CM_A·b_A, then b_B → N_B = CM_B·b_B     torch
    pass 2 (read x):   Y = dim-B completion of the dim-A completion   kernel
                       (write Y; Z stays on chip)

The solves are carry-sized ``torch.matmul``/``einsum`` calls, as the JAX
package leaves them to XLA, in float64: the carries amplify rounding about
thirtyfold for the sigma=5 Gaussian, and fp32 glue left the filter at
7e-6 of the output peak against the f64 oracle where the px6 bound is 2e-6
(plain twins on the CPU, 512²). Each dimension's solve is banded from 64
tiles on, for a decaying filter, else the dense padded (n·8)² matmul —
``fused_2d_px``'s rule. Every host matrix is built once, at module
construction.

Two consumers ride :class:`Fused2DPx` as in the JAX package's
``fused_2d_px``: an elementwise ``epilogue(y, *eaux)`` — inside the final
kernel's store loop where its structure is affine (``final2d_epi``: the
unsharp mask's combine, :func:`.epilogue.affine_form`), as torch ops on
the kernel's output otherwise — and a ``stencil2d`` bank — per channel 2-D shifted taps —
fused into the final kernel (``final2d_stencil``), so the filter output
never reaches device memory: the moments kernel also emits each tile's
edge completion partials, and the glue completes them into the row-halo
strips above and below every tile (float64, :meth:`Fused2DPx.halo_strips`).

Two routes of :class:`Fused2DPx` fold parts of the glue into kernels, as
the JAX package's A/B switches do (both off by default there and here):
``RECFILTER_PXM_NAF=1`` — pass 1 emits the solved dim-A carries
(``moments2d_naf``, ``moments_route == "naf"``), and
``RECFILTER_PX2D_BK=1`` — the dim-B glue and its solve run as one kernel
(``bsolve``, ``carry_route == "bsolve"``); together, the carries take no
torch op between the three launches.

Both executors take bf16 storage (``dtype=torch.bfloat16``, the JAX
package's bf16 mode, at one product): the image is padded and tiled in
bf16, the kernels read it as bf16 and the final kernel writes bf16; pass
1's tails and every carry stay float32 / float64 as at float32.
``forward_plain`` is then the float32 plain path on ``x.float()`` with
one rounding to bf16 at the end of each executor.

:class:`FusedRowsPx` is the dim-A half on its own — the rows pass, for a
scan along any axis but the last, everything after that axis flattened
into lanes: tails kernel → float64 carry solve (banded from 64 tiles on)
→ completion kernel, the image read twice and written once. Volumes run
their leading scanned axis through it before :class:`Fused2DPx` takes the
trailing pair (``dimfuse.fused_filter_module``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import dimfuse
from .epilogue import kernel_form
from .kernels import final2d as k2d
from .kernels.completion import _SLOTS, _per_tile, pad_solve_matrix
from .kernels.stencil2d import stencil_reach
from .spec import BorderMode, Scan

TILE = k2d.TILE
# the grades whose product count the overlap_k backend's px pair takes:
# the JAX package's fused_2d_pass map (no ``default`` in it)
PX_NPROD = {"px3": 3, "px4": 4, "px6": 6}


def stencil2d_decline(wa: int, wb: int, stencil2d):
    """Why the JAX package's ``fused_2d_px`` declines a ``stencil2d`` bank
    on extents (wa, wb) (its gates: no pad, a row reach h8 = ⌈max|dy|/8⌉·8
    ≤ 128 and a column reach ≤ 128), or None where it fuses it."""
    up, down, left, right = stencil_reach(stencil2d)
    if wa % TILE or wb % TILE:
        return f"extents not multiples of {TILE}"
    if stencil_h8(stencil2d) > TILE or max(left, right) > TILE:
        return (f"reach {max(up, down)} rows, {max(left, right)} columns: "
                f"beyond {TILE}")
    return None


def fused2d_decline(scans_a: Sequence[Scan], scans_b: Sequence[Scan],
                    wa: int, wb: int, border: str, stencil2d=None):
    """Why the JAX package's ``fused_2d_px`` declines a filter with
    ``scans_a`` on axis -2 and ``scans_b`` on axis -1 of extents (wa, wb)
    (and a ``stencil2d`` bank), or None where it runs it. Its gates:
    extents of at least one tile, no pad under a clamp border, at most 256
    tiles and 8 carries per dimension, and :func:`stencil2d_decline`'s."""
    T, cap = TILE, dimfuse._CHAIN_MATMUL_MAX_TILES
    na, nb = -(-wa // T), -(-wb // T)
    Ka, Kb = (sum(s.order for s in sc) for sc in (scans_a, scans_b))
    if wa < T or wb < T:
        return f"extents ({wa}, {wb}) below the {T} tile"
    if border == BorderMode.CLAMP and (wa % T or wb % T):
        return (f"clamp border with extents ({wa}, {wb}) that are not "
                f"multiples of {T}")
    if na > cap or nb > cap:
        return f"{na} x {nb} tiles: more than {cap} per dimension"
    if Ka > _SLOTS or Kb > _SLOTS:
        return f"carries Ka={Ka}, Kb={Kb}: more than {_SLOTS} per dimension"
    if stencil2d is not None:
        return stencil2d_decline(wa, wb, stencil2d)
    return None


def stencil_h8(stencil2d) -> int:
    """The row-halo height: max|dy| rounded up to 8, at least 8."""
    up, down, _, _ = stencil_reach(stencil2d)
    return -(-max(up, down, 1) // 8) * 8


BK_MAX_BYTES = 6 * 1024 * 1024  # the JAX package's bound on bsolve's term1


def _route(name: str, asked: Optional[bool], env: str, why: Optional[str]):
    """Whether an optional route runs: ``asked`` None reads the variable
    ``env`` ("1" turns it on) and takes the route where its gate holds
    (``why`` None); True raises naming the gate that fails."""
    if asked is None:
        return why is None and os.environ.get(env, "0") == "1"
    if asked and why is not None:
        raise NotImplementedError(f"{name}: {why}")
    return bool(asked)


class Fused2DPx(nn.Module):
    """Executor for scans ``scans_a`` on axis -2 and ``scans_b`` on axis
    -1 of float32 arrays ``(..., wa, wb)``; leading axes are a batch.

    ``forward`` runs the CUDA kernels for CUDA tensors (their plain twins
    for CPU tensors); ``forward_plain`` runs the twins on any device — the
    all-PyTorch reference for the kernel path.

    ``epilogue(y, *eaux)``: an elementwise combine of the filter output
    (``forward(x, *eaux)``, the aux arrays in the output's layout, padded
    and tiled like x). Where :func:`.epilogue.affine_form` reads it as
    ``a·y + Σᵢ bᵢ·auxᵢ + c`` (k ≤ 4) the final kernel applies it in its
    store loop (``epilogue_route == "kernel"``); otherwise it runs as
    torch ops on the kernel's output (``"torch"``). ``stencil2d``: per channel
    ``[(dy, dx, coeff), ...]`` fused into the final kernel
    (``final2d_stencil``); ``forward`` then returns a tuple of C channels.

    Raises ``NotImplementedError`` where the JAX package's executor would
    decline the filter (:func:`fused2d_decline`: extents below one tile,
    clamp with extents that are not tile multiples, more than 256 tiles,
    more than 8 carries per dimension, a stencil bank past
    :func:`stencil2d_decline`'s gates): the router runs the rotation
    chain there (``dimfuse.RotationChain``).

    ``nprod``: the product grade of the final pass — 6 (px6) on
    ``final2d`` (``final2d_epi``, ``final2d_stencil``), or a reduced
    grade's 1, 3 or 4 (default, px3, px4) on ``final2d_split``
    (``final2d_split_epi`` with an affine epilogue; a stencil bank on
    ``final2d_stencil`` at the grade). Pass 1 and the carries run as at
    px6 (fp64 sums and solves, bound by bytes: fewer products buy no time
    there).

    ``naf`` / ``bsolve``: the optional routes of the module docstring.
    None (the default) reads ``RECFILTER_PXM_NAF`` / ``RECFILTER_PX2D_BK``
    once, here, and takes the route where the JAX package's gate holds
    (``naf_ok`` and ``use_bk`` of its ``fused_2d_px``); True asks for it
    and raises ``NotImplementedError`` naming the gate that fails; False
    keeps the glue. ``moments_route`` ("raw" or "naf") and
    ``carry_route`` ("glue" or "bsolve") say which runs.

    ``dtype``: the storage type, float32 or bf16 (module docstring; bf16
    at ``nprod`` 1, an epilogue's output rounded to bf16 as the JAX
    kernel stores it; a fused ``stencil2d`` bank runs ``moments2d_bf16``
    with its edge rows and ``final2d_stencil_bf16``, bf16 banks each
    rounded once). ``tile`` casts the input to it."""

    def __init__(self, scans_a: Sequence[Scan], scans_b: Sequence[Scan],
                 wa: int, wb: int, border: str, epilogue=None,
                 stencil2d=None, bsolve: Optional[bool] = None,
                 naf: Optional[bool] = None, nprod: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        T = TILE
        if stencil2d is not None and epilogue is not None:
            raise ValueError("stencil2d is mutually exclusive with epilogue")
        if nprod not in (1, 3, 4, 6):
            raise ValueError(f"nprod {nprod}: the 2-D executor runs 1, 3, 4 "
                             "or 6 products")
        self.dtype = _storage_type(dtype, nprod)
        self.nprod = nprod
        why = fused2d_decline(scans_a, scans_b, wa, wb, border, stencil2d)
        if why:
            raise NotImplementedError(
                f"{why}: the JAX package's 3-touch executor declines this "
                "filter, and dimfuse.fused_filter_module runs its rotation "
                "chain (dimfuse.RotationChain) instead")
        clamp = border == BorderMode.CLAMP
        na, nb = -(-wa // T), -(-wb // T)
        pad_a, pad_b = na * T - wa, nb * T - wb
        ma = dimfuse.prepare_dim_pass(scans_a, T, na, clamp, pad_slots=pad_a)
        mb = dimfuse.prepare_dim_pass(scans_b, T, nb, clamp, pad_slots=pad_b)
        Ka, Kb = int(sum(ma.orders)), int(sum(mb.orders))
        self.wa, self.wb, self.na, self.nb = wa, wb, na, nb
        self.pad_a, self.pad_b, self.Ka, self.Kb = pad_a, pad_b, Ka, Kb
        self.epilogue = epilogue
        self.affine = kernel_form(epilogue)
        self.epilogue_route = (None if epilogue is None else
                               "torch" if self.affine is None else "kernel")
        self.h8 = 0 if stencil2d is None else stencil_h8(stencil2d)

        Ga_cat = np.concatenate([np.asarray(g) for g in ma.G], axis=1)
        Gb_cat = np.concatenate([np.asarray(g) for g in mb.G], axis=1)
        Ra_cat = np.concatenate([np.asarray(r) for r in ma.Rhat], axis=2)
        Rb_cat = np.concatenate([np.asarray(r) for r in mb.Rhat], axis=2)

        def buf(name, a):  # glue constants stay float64 (module docstring)
            self.register_buffer(
                name, torch.from_numpy(np.ascontiguousarray(a, np.float64)))

        # each dimension's carry solve: banded from 64 tiles on (a decaying
        # filter), else the dense padded matmul — fused_2d_px's rule
        self.offsets, CMp = {}, {}
        for d, m, n, K in (("a", ma, na, Ka), ("b", mb, nb, Kb)):
            CM = dimfuse.combined_solve_matrix(m, n)
            bands = dimfuse.banded_solve_blocks(CM, n, K)
            self.offsets[d] = None if bands is None else [o for o, _ in bands]
            if bands is None:
                CMp[d] = pad_solve_matrix(CM, n, K)
                buf(f"CM{d}_p", CMp[d])
            else:
                buf(f"bands_{d}", np.stack([b for _, b in bands]))

        # the optional routes, on the JAX package's gates (the port always
        # folds term1 and has no sequence hook); why_* the failing gate
        why_naf = why_bk = "a fused stencil2d bank" if self.h8 else None
        if why_naf is None and self.offsets["a"] is not None:
            why_naf = "the dim-A solve is banded"
        if why_bk is None and self.offsets["b"] is not None:
            why_bk = "the dim-B solve is banded"
        # nb·8·W·4 ≤ 6 MiB is the JAX package's VMEM bound, kept so both
        # packages take the same route
        bk_bytes = nb * _SLOTS * nb * T * 4
        if why_bk is None and bk_bytes > BK_MAX_BYTES:
            why_bk = f"term1 of {bk_bytes} bytes exceeds {BK_MAX_BYTES}"
        self.moments_route = ("naf" if _route("naf", naf, "RECFILTER_PXM_NAF",
                                              why_naf) else "raw")
        self.carry_route = ("bsolve" if _route(
            "bsolve", bsolve, "RECFILTER_PX2D_BK", why_bk) else "glue")

        self.moments = k2d.Moments2D(
            Ga_cat, Gb_cat, ma.Btot, na, nb,
            edge=(ma.Btot, self.h8) if self.h8 else None,
            solve=CMp["a"] if self.moments_route == "naf" else None)
        self.bsolve = (k2d.BSolve(Gb_cat, Ra_cat, CMp["b"], na, nb)
                       if self.carry_route == "bsolve" else None)
        if self.h8:
            self.final = k2d.Final2DStencil(ma.Btot, Ra_cat, mb.Btot,
                                            Rb_cat, na, nb, stencil2d,
                                            self.h8, nprod)
        elif nprod != 6:
            self.final = k2d.Final2DSplit(ma.Btot, Ra_cat, mb.Btot, Rb_cat,
                                          na, nb, nprod, affine=self.affine)
        else:
            self.final = k2d.Final2D(ma.Btot, Ra_cat, mb.Btot, Rb_cat, na,
                                     nb, affine=self.affine)
        Gb8 = np.zeros((Gb_cat.shape[0], _SLOTS, T))
        Gb8[:, :Kb] = Gb_cat
        buf("Ran", _per_tile(Ra_cat, na))                     # (na, Ta, Ka)
        buf("Gb8n", _per_tile(Gb8, nb))                       # (nb, 8, Tb)
        if self.h8:  # the halo strips' dim-B completion
            buf("Bbn", _per_tile(mb.Btot, nb))                # (nb, Tb, Tb)
            buf("Rbn", _per_tile(Rb_cat, nb))                 # (nb, Tb, Kb)

    def forward(self, x: torch.Tensor, *eaux):
        return self._run(x, self.moments, self.final, self.bsolve, eaux)

    def forward_plain(self, x: torch.Tensor, *eaux):
        return self._run(x, self.moments.plain, self.final.plain,
                         self.bsolve and self.bsolve.plain, eaux)

    def tile(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """(..., wa, wb) float32 → the kernels' zero-padded (p, na, Ta, W);
        at bf16 storage any input, cast to bf16 and padded in bf16.
        ``dtype`` float32 tiles an epilogue's aux arrays, which stay
        float32 at every storage type."""
        x = dimfuse._storage_input(x, self.dtype if dtype is None else dtype)
        if x.ndim < 2 or tuple(x.shape[-2:]) != (self.wa, self.wb):
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"the filter's extents ({self.wa}, {self.wb})")
        if self.pad_a or self.pad_b:
            x = F.pad(x, (0, self.pad_b, 0, self.pad_a))
        return x.reshape(-1, self.na, TILE, self.nb * TILE).contiguous()

    def carries(self, X4: torch.Tensor, moments=None, bsolve=None):
        """Pass 1 and the carry solves: the solved carries ``(NA_t, NB_t)``
        of the tiled image X4, in the final kernel's float32 layouts."""
        NA_t, NB_t = self._carries(X4, moments, bsolve)[:2]
        return NA_t.float(), NB_t.float()

    def _carries(self, X4, moments=None, bsolve=None):
        """:meth:`carries` in float64 on the glue (float32 where a kernel
        emits them), followed by the moments kernel's edge partials where a
        stencil bank is fused."""
        if moments is None:
            moments = self.moments
        if bsolve is None:
            bsolve = self.bsolve
        T, na, nb, Ka = TILE, self.na, self.nb, self.Ka
        p, W = X4.shape[0], nb * T
        # pass 1: dim-A raw tails (or, "naf", the solved carries) + dim-B
        # term1 = Btot_a·(x·G_Bᵀ)
        bA_t, term1, *edges = moments(X4)
        # dim-A chain solve (slot-padded layout)
        NA_t = (bA_t if self.moments_route == "naf"
                else self._solve("a", bA_t.double(), Ka))
        if self.carry_route == "bsolve":
            # the dim-B glue and its solve in one launch
            NB_t = bsolve(NA_t.float(), term1)
        else:
            # dim-B raw tails from carry-sized data only, then their solve
            bB = k2d.carry_b_tails(self.Gb8n, self.Ran, NA_t, term1, Ka)
            NB_t = self._solve("b", bB, self.Kb)
        return (NA_t.reshape(p, na, _SLOTS, W),
                NB_t.reshape(p, na, nb * _SLOTS, T), *edges)

    def _solve(self, d: str, b, K: int):
        """Dimension ``d``'s carry solve of the slot-padded tails
        ``b`` (..., n, 8, lanes), leading axes a batch: banded or dense."""
        if self.offsets[d] is not None:
            return dimfuse._banded_solve_apply(
                list(zip(self.offsets[d], getattr(self, f"bands_{d}"))), b, K)
        lead, (n, sl, w) = b.shape[:-3], b.shape[-3:]
        N = torch.matmul(getattr(self, f"CM{d}_p"),
                         b.reshape(-1, n * sl, w))
        return N.reshape(*lead, n, sl, w)

    def halo_strips(self, ht, hb, NA_t, NB_t):
        """The row-halo strips of the fused stencil, in float64: the
        moments kernel's edge partials ``ht``/``hb`` (Btot_a's first/last
        h8 rows · x) completed with both dimensions' carries — the bottom
        h8 rows of each tile's upper neighbour (``top``) and the top h8
        rows of its lower neighbour (``bot``), (p, na, h8, W), zeros past
        the first/last tile. Returns float32 (top, bot)."""
        T, h8, na, nb, Ka, Kb = TILE, self.h8, self.na, self.nb, self.Ka, \
            self.Kb
        p, W = NA_t.shape[0], nb * T
        NAk = NA_t[:, :, :Ka]
        NBr = NB_t.reshape(p, na, nb, _SLOTS, T)[:, :, :, :Kb]
        Ztop = ht.double() + torch.einsum("ahk,pakw->pahw", self.Ran[:, :h8],
                                          NAk)
        Zbot = hb.double() + torch.einsum("ahk,pakw->pahw",
                                          self.Ran[:, T - h8:], NAk)

        zpad = Ztop.new_zeros((p, 1, h8, W))
        nbpad = NBr.new_zeros((p, 1, nb, Kb, h8))
        # tile a's top halo = tile a−1's bottom rows; bottom = a+1's top;
        # both strips' dim-B completion in one pair of products
        Z = torch.cat([torch.cat([zpad, Zbot[:, :na - 1]], 1),
                       torch.cat([Ztop[:, 1:], zpad], 1)], 2)
        NBrows = torch.cat([
            torch.cat([nbpad, NBr[:, :na - 1, ..., T - h8:]], 1),
            torch.cat([NBr[:, 1:, ..., :h8], nbpad], 1)], -1)
        y = (torch.einsum("bot,pahbt->pahbo", self.Bbn,
                          Z.reshape(p, na, 2 * h8, nb, T))
             + torch.einsum("bok,pabkh->pahbo", self.Rbn, NBrows))
        y = y.reshape(p, na, 2 * h8, W).float()
        return y[:, :, :h8].contiguous(), y[:, :, h8:].contiguous()

    def _run(self, x, moments, final, bsolve, eaux=()):
        lead = x.shape[:-2]
        X4 = self.tile(x)
        NA_t, NB_t, *edges = self._carries(X4, moments, bsolve)
        NA32, NB32 = NA_t.float(), NB_t.float()
        if self.h8:
            # passes 2+3 with the bank: C channels, the output unwritten
            outs = final(X4, NA32, NB32, *self.halo_strips(*edges, NA_t,
                                                           NB_t))
            return tuple(o.reshape(*lead, self.wa, self.wb) for o in outs)
        # the aux arrays padded and tiled like x (position-free), a
        # broadcast aux materialized
        aux = [self.tile(torch.as_tensor(a).to(device=x.device,
                                               dtype=torch.float32)
                         .expand(x.shape), torch.float32)
               for a in (eaux if self.epilogue is not None else ())]
        # passes 2+3: read x once, emit Y (or the affine epilogue's output)
        if self.affine is not None:
            Y4 = final(X4, NA32, NB32, *aux)
        else:
            Y4 = final(X4, NA32, NB32)
            if self.epilogue is not None:
                Y4 = self.epilogue(Y4, *aux)
                if self.dtype == torch.bfloat16:  # stored as the kernel's Y
                    Y4 = Y4.to(torch.bfloat16)
        y = Y4.reshape(*lead, self.na * TILE, self.nb * TILE)
        return y[..., :self.wa, :self.wb]


def _storage_type(dtype: torch.dtype, nprod: int) -> torch.dtype:
    """The executors' storage type: float32, or bf16 at one product."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"storage dtype {dtype}: the executors store "
                         "float32 or bf16")
    if dtype == torch.bfloat16 and nprod != 1:
        raise ValueError(f"bf16 storage runs one product, not {nprod}")
    return dtype


def _rows_decline(L: int, W: int, scans: Sequence[Scan]):
    """Why the rows kernels do not take a scan of extent ``L`` with ``W``
    lanes (the static gates of the JAX package's ``fused_rows_px``), or
    None where they do."""
    T = TILE
    if L < T or L % T or W % T:
        return (f"scanned extent {L} with {W} lanes: the rows kernels take "
                f"multiples of {T} in both")
    if L // T > dimfuse._CHAIN_MATMUL_MAX_TILES:
        return (f"{L // T} tiles: more than "
                f"{dimfuse._CHAIN_MATMUL_MAX_TILES} need the associative "
                "carry chain")
    K = sum(s.order for s in scans)
    if K > _SLOTS:
        return f"{K} carries: more than {_SLOTS}"
    return None


class FusedRowsPx(nn.Module):
    """Executor for ``scans`` along one axis that is not the last, of
    float32 arrays ``(..., L, *trailing)``: the JAX package's
    ``overlap2d.fused_rows_px``. The ``trailing`` extents are flattened
    into W lanes, the leading axes into a batch p, and the scanned axis is
    cut into n tiles of 128 rows:

        pass 1 (read x):  raw tails b = G·x per tile       rows_tails kernel
        solve (tiny):     N = CM·b — banded from 64 tiles  torch, float64
        pass 2 (read x):  y = Btot·x + Rhat·N, write y     rows_final kernel

    ``nprod`` is ``rows_final``'s grade (6, 4, 3 or 1:
    :class:`.kernels.final2d.RowsFinal`); ``rows_tails`` sums in fp64 at
    every grade, at least as close to the oracle as the JAX package's
    split tails. ``forward`` runs the CUDA kernels for CUDA tensors (their
    plain twins for CPU tensors); ``forward_plain`` runs the twins on any
    device. Raises ``NotImplementedError`` where the JAX package declines
    the rows kernels (:func:`_rows_decline`: extents that are not
    multiples of 128, more than 256 tiles, more than 8 carries): the
    router runs the einsum pass there (``dimfuse.FusedAxisPass``).
    ``dtype``: the storage type, float32 or bf16 at ``nprod`` 1 (module
    docstring); ``tile`` casts the input to it."""

    def __init__(self, scans: Sequence[Scan], L: int,
                 trailing: Sequence[int], border: str, nprod: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        T = TILE
        self.dtype = _storage_type(dtype, nprod)
        trailing = tuple(int(e) for e in trailing)
        if not trailing:
            raise NotImplementedError(
                "the rows pass scans a non-last axis; the last axis runs "
                "dimfuse.FusedLastAxis")
        W = int(np.prod(trailing, dtype=np.int64))
        why = _rows_decline(L, W, scans)
        if why:
            raise NotImplementedError(
                f"{why}: the JAX package declines its rows kernels here, "
                "and dimfuse.fused_filter_module runs the einsum pass on a "
                "non-last axis (dimfuse.FusedAxisPass) instead")
        n = L // T
        mats = dimfuse.prepare_dim_pass(scans, T, n,
                                        border == BorderMode.CLAMP)
        K = int(sum(mats.orders))
        self.L, self.trailing, self.n, self.W, self.K = L, trailing, n, W, K
        G_cat = np.concatenate([np.asarray(g) for g in mats.G], axis=1)
        R_cat = np.concatenate([np.asarray(r) for r in mats.Rhat], axis=2)
        self.tails = k2d.RowsTails(G_cat, n)
        self.final = k2d.RowsFinal(mats.Btot, R_cat, n, nprod)
        # carry solve, float64 (module docstring): banded where the chain
        # matrix is (n ≥ 64 tiles, a decaying filter), else dense
        CM = dimfuse.combined_solve_matrix(mats, n)
        bands = dimfuse.banded_solve_blocks(CM, n, K)
        self.offsets = None
        if bands is not None:
            self.offsets = [d for d, _ in bands]
            self.register_buffer("bands", torch.from_numpy(
                np.stack([b for _, b in bands])))
        else:
            self.register_buffer("CMp", torch.from_numpy(
                pad_solve_matrix(CM, n, K).astype(np.float64)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.tails, self.final)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.tails.plain, self.final.plain)

    def tile(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L, *trailing) float32 → the kernels' (p, n, 128, W); at
        bf16 storage any input, cast to bf16."""
        x = dimfuse._storage_input(x, self.dtype)
        ext = (self.L, *self.trailing)
        if x.ndim < len(ext) or tuple(x.shape[-len(ext):]) != ext:
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"the filter's extents {ext}")
        return x.reshape(-1, self.n, TILE, self.W).contiguous()

    def carries(self, X4: torch.Tensor, tails=None) -> torch.Tensor:
        """Pass 1 and the carry solve: the slot-padded carries
        (p, n, 8, W) of the tiled array X4, in float32."""
        b = (self.tails if tails is None else tails)(X4).double()
        if self.offsets is not None:
            N = dimfuse._banded_solve_apply(
                list(zip(self.offsets, self.bands)), b, self.K)
        else:
            p = b.shape[0]
            N = torch.matmul(self.CMp, b.reshape(p, self.n * _SLOTS, self.W))
        return N.reshape(b.shape).float().contiguous()

    def _run(self, x, tails, final):
        X4 = self.tile(x)
        return final(X4, self.carries(X4, tails)).reshape(x.shape)


def fused_rows_px(x: torch.Tensor, axis: int, scans: Sequence[Scan],
                  border: str) -> torch.Tensor:
    """Functional form of :class:`FusedRowsPx` (the JAX package's
    ``overlap2d.fused_rows_px`` without its precision/interpret
    arguments): all ``scans`` along ``axis`` of ``x``, which must not be
    the last axis."""
    if not 0 <= axis < x.ndim - 1:
        raise NotImplementedError(
            f"axis {axis} of a {x.ndim}-D array: the rows pass scans a "
            "non-last axis (the last axis runs dimfuse.FusedLastAxis)")
    mod = FusedRowsPx(scans, x.shape[axis], x.shape[axis + 1:], border)
    return mod.to(x.device)(x)


def fused_2d_px(x: torch.Tensor, axis_a: int, scans_a: Sequence[Scan],
                axis_b: int, scans_b: Sequence[Scan],
                border: str) -> torch.Tensor:
    """Functional form of :class:`Fused2DPx` (the JAX package's
    ``overlap2d.fused_2d_px`` without its precision/interpret arguments):
    the scanned dims must be the trailing two axes."""
    if (axis_a, axis_b) != (x.ndim - 2, x.ndim - 1):
        raise NotImplementedError(
            "the 2-D executor scans the trailing two axes; "
            "dimfuse.fused_filter_module routes any other pair")
    mod = Fused2DPx(scans_a, scans_b, x.shape[-2], x.shape[-1], border)
    return mod.to(x.device)(x)


# ---------------------------------------------------------------------------
# The overlap backends (``overlap``, ``overlap_k``): the JAX package's
# fused_2d_pass, apply_filter_overlap and fused_nd_pass
# ---------------------------------------------------------------------------


def _stack64(M) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(M, np.float64))


def _cat_mats(m):
    """A dimension's stacked tails rows G_cat (n|1, ΣK, T) and carry
    columns Rhat_cat (n|1, T, ΣK)."""
    return (np.concatenate([np.asarray(g) for g in m.G], axis=1),
            np.concatenate([np.asarray(r) for r in m.Rhat], axis=2))


def _apply_stack(M: torch.Tensor, V: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, M, V)`` for a matrix stack M (n|1, o, s) whose first
    letter of ``eq`` is the tile axis: a uniform stack (n = 1) contracts
    its one matrix (the JAX package's ``_apply_a5`` / ``_apply_b5`` and
    ``_apply_a`` / ``_apply_b``)."""
    if M.shape[0] == 1:
        lhs, out = eq.split("->")
        m, v = lhs.split(",")
        return torch.einsum(f"{m[1:]},{v}->{out}", M[0], V)
    return torch.einsum(eq, M, V)


def _solve_lines(b: torch.Tensor, n_ax: int, k_ax: int,
                 CM: torch.Tensor) -> torch.Tensor:
    """A dimension's dense carry solve: the (n, k) axes of ``b`` moved
    last, flattened, times CMᵀ, and moved back."""
    bt = b.movedim((n_ax, k_ax), (-2, -1))
    shp = bt.shape
    N = (bt.reshape(-1, shp[-2] * shp[-1]) @ CM.T).reshape(shp)
    return N.movedim((-2, -1), (n_ax, k_ax))


class Fused2DK(nn.Module):
    """The ``overlap_k`` backend's kernel path for scans ``scans_a`` on
    axis −2 and ``scans_b`` on axis −1 of float32 arrays (..., wa, wb) —
    the JAX package's ``_fused_2d_kernel_path``, at the HIGHEST grade:

        pass 1 (read x):  bA = G_A·x, raw U = x·G_Bᵀ        moments2d_k
        solves (tiny):    N_A = CM_A·bA; bB = Btot_A·U + Rhat_A·(G_B·N_A);
                          N_B = CM_B·bB                     torch, float64
        passes 2+3:       Y = (Btot_A·x + Rhat_A·N_A)·Btot_Bᵀ
                            + N_B·Rhat_Bᵀ                   final2d_k

    ``Ta`` is the leading axis's tile (≤ 128), the last axis's is 128;
    extents are zero-padded to whole tiles (``pad_a`` / ``pad_b`` set by
    the caller's gates: never under a clamp border). The glue runs in
    float64 with dense solves, as the port's other glue does.
    ``matmul_dtype="bfloat16"`` runs passes 2+3 with bf16 products
    (``final2d_k_bf16``, :class:`.kernels.final2d.Final2DK`): the JAX
    package's ``final2d(matmul_dtype=bfloat16)``; pass 1 and the glue as
    at float32. ``forward_plain`` runs the kernels' twins."""

    def __init__(self, scans_a: Sequence[Scan], scans_b: Sequence[Scan],
                 wa: int, wb: int, Ta: int, border: str,
                 matmul_dtype: str = "float32"):
        super().__init__()
        Tb = TILE
        clamp = border == BorderMode.CLAMP
        na, nb = -(-wa // Ta), -(-wb // Tb)
        self.wa, self.wb, self.Ta, self.na, self.nb = wa, wb, Ta, na, nb
        pad_a, pad_b = na * Ta - wa, nb * Tb - wb
        ma = dimfuse.prepare_dim_pass(scans_a, Ta, na, clamp,
                                      pad_slots=pad_a)
        mb = dimfuse.prepare_dim_pass(scans_b, Tb, nb, clamp,
                                      pad_slots=pad_b)
        Ga_cat, Ra_cat = _cat_mats(ma)
        Gb_cat, Rb_cat = _cat_mats(mb)
        self.Ka, self.Kb = Ga_cat.shape[1], Gb_cat.shape[1]
        self.moments = k2d.Moments2DK(Ga_cat, Gb_cat, na, nb)
        self.final = k2d.Final2DK(ma.Btot, Ra_cat, mb.Btot, Rb_cat, na, nb,
                                  matmul_dtype=matmul_dtype)
        self.register_buffer("Btot_a", _stack64(ma.Btot))
        self.register_buffer("Ra_cat", _stack64(Ra_cat))
        self.register_buffer("Gb_cat", _stack64(Gb_cat))
        self.register_buffer("CMa", _stack64(
            dimfuse.combined_solve_matrix(ma, na)))
        self.register_buffer("CMb", _stack64(
            dimfuse.combined_solve_matrix(mb, nb)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.moments, self.final)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.moments.plain, self.final.plain)

    def carries(self, X4: torch.Tensor, moments=None):
        """Pass 1 and the solves: the kernel layouts NA (p, na, Ka, W) and
        NB (p, na, nb, Ta, Kb), float32."""
        p, na, nb, Ta, Tb = X4.shape[0], self.na, self.nb, self.Ta, TILE
        bA, U = (moments or self.moments)(X4)
        bA5 = bA.double().reshape(p, na, self.Ka, nb, Tb)
        U5 = U.double().transpose(2, 3)                  # (p, na, Ta, nb, Kb)
        NA5 = _solve_lines(bA5, 1, 2, self.CMa)          # (p, na, Ka, nb, Tb)
        GN = _apply_stack(self.Gb_cat, NA5, "bot,pasbt->pasbo")
        bb = (_apply_stack(self.Btot_a, U5, "aos,pasbt->paobt")
              + _apply_stack(self.Ra_cat, GN, "aos,pasbt->paobt"))
        NB5 = _solve_lines(bb, 3, 4, self.CMb)           # (p, na, Ta, nb, Kb)
        return (NA5.reshape(p, na, self.Ka, nb * Tb).float().contiguous(),
                NB5.transpose(2, 3).float().contiguous())

    def _run(self, x, moments, final):
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32 input, got {x.dtype}")
        if x.ndim < 2 or tuple(x.shape[-2:]) != (self.wa, self.wb):
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"({self.wa}, {self.wb})")
        X4 = self.tile(x)
        NA, NB = self.carries(X4, moments)
        Y4 = final(X4, NA, NB)
        Y = Y4.reshape(*x.shape[:-2], self.na * self.Ta, self.nb * TILE)
        return Y[..., :self.wa, :self.wb]

    def tile(self, x: torch.Tensor) -> torch.Tensor:
        """(..., wa, wb) → the kernels' zero-padded (p, na, Ta, nb·128)."""
        Ha, Wb = self.na * self.Ta, self.nb * TILE
        xp = F.pad(x, (0, Wb - self.wb, 0, Ha - self.wa))
        return xp.reshape(-1, self.na, self.Ta, Wb).contiguous()


class _Swapped(nn.Module):
    """``body`` on the input with axes ``a`` and ``b`` swapped, its output
    swapped back (the JAX package's normalization of a pair whose first
    scanned axis comes later in the array)."""

    def __init__(self, body: nn.Module, a: int, b: int):
        super().__init__()
        self.body, self.a, self.b = body, a, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x.transpose(self.a, self.b)).transpose(self.a,
                                                                self.b)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self.body.forward_plain(
            x.transpose(self.a, self.b)).transpose(self.a, self.b)


def fused_2d_module(shape, axis_a: int, scans_a, Ta: int, axis_b: int,
                    scans_b, Tb: int, border: str = BorderMode.ZERO,
                    use_kernels: bool = False,
                    matmul_precision: str = "highest",
                    matmul_dtype: str = "float32") -> nn.Module:
    """The executor the JAX package's ``fused_2d_pass`` runs for scans
    ``scans_a`` on ``axis_a`` then ``scans_b`` on ``axis_b`` of arrays of
    ``shape``, by its gates in its order:

      1. a pair whose first axis comes later is swapped (:class:`_Swapped`);
      2. ``use_kernels`` at ``px6``, ``px4`` or ``px3`` on the trailing
         pair where :func:`fused2d_decline` passes: :class:`Fused2DPx`
         with the grade's product count (the JAX package's map names only
         those three grades);
      3. the tiles: each at least its axis's largest order and at most its
         extent; with ``use_kernels`` the last axis's pinned to 128;
      4. a clamp border with pad, more than 256 tiles on an axis, or a
         tile below the order: two :func:`.dimfuse.dim_pass_module` passes
         at ``highest`` (the JAX call's default), a :class:`.dimfuse.
         StagedPass` of route ``"pair-fallback"``;
      5. ``use_kernels`` on the contiguous trailing pair: :class:`Fused2DK`
         (``moments2d_k`` + ``final2d_k``, or ``final2d_k_bf16`` at
         ``matmul_dtype="bfloat16"``);
      6. else the einsum form, :class:`OverlapND` on the two axes (route
         ``"pair"``).

    Every other grade (``default``, ``highest``, the split-einsum grades)
    and a px grade off the gates of 2 fall through to 3–6 at the HIGHEST
    grade, as in the JAX package; without kernels the grade is not read.
    ``matmul_dtype`` is read by :class:`Fused2DK` alone (the JAX
    package's ``_fused_2d_kernel_path``)."""
    shape = tuple(int(e) for e in shape)
    nd = len(shape)
    axis_a, axis_b = axis_a % nd, axis_b % nd
    if axis_a > axis_b:
        sw = list(shape)
        sw[axis_a], sw[axis_b] = sw[axis_b], sw[axis_a]
        return _Swapped(fused_2d_module(
            sw, axis_b, scans_a, Ta, axis_a, scans_b, Tb, border,
            use_kernels, matmul_precision, matmul_dtype), axis_a, axis_b)
    wa, wb = shape[axis_a], shape[axis_b]
    trailing = axis_a == nd - 2 and axis_b == nd - 1
    nprod = PX_NPROD.get(matmul_precision, 0)
    if (use_kernels and nprod and trailing
            and fused2d_decline(scans_a, scans_b, wa, wb, border) is None):
        return Fused2DPx(scans_a, scans_b, wa, wb, border, nprod=nprod)
    ka = max(s.order for s in scans_a)
    kb = max(s.order for s in scans_b)
    Ta = int(min(max(Ta, ka), wa))
    Tb = int(min(max(Tb, kb), wb))
    if use_kernels:
        Tb = int(min(TILE, -(-wb // TILE) * TILE))
    na, nb = -(-wa // Ta), -(-wb // Tb)
    pad_a, pad_b = na * Ta - wa, nb * Tb - wb
    cap = dimfuse._CHAIN_MATMUL_MAX_TILES
    if ((border == BorderMode.CLAMP and (pad_a or pad_b))
            or na > cap or nb > cap or Ta < ka or Tb < kb):
        return dimfuse.StagedPass([
            dimfuse.dim_pass_module(scans_a, axis_a, shape, Ta, border,
                                    "highest"),
            dimfuse.dim_pass_module(scans_b, axis_b, shape, Tb, border,
                                    "highest")], "pair-fallback")
    if use_kernels and trailing:
        return Fused2DK(scans_a, scans_b, wa, wb, Ta, border,
                        matmul_dtype)
    return OverlapND(shape, [(axis_a, scans_a, Ta), (axis_b, scans_b, Tb)],
                     border, route="pair")


def fused_2d_pass(x: torch.Tensor, axis_a: int, scans_a, Ta: int,
                  axis_b: int, scans_b, Tb: int,
                  border: str = BorderMode.ZERO, use_kernels: bool = False,
                  matmul_precision: str = "highest",
                  matmul_dtype: str = "float32") -> torch.Tensor:
    """Functional :func:`fused_2d_module` on the float32 ``x``."""
    mod = fused_2d_module(x.shape, axis_a, scans_a, Ta, axis_b, scans_b, Tb,
                          border, use_kernels, matmul_precision,
                          matmul_dtype)
    return mod.to(x.device)(x)


def nd_decline(shape, groups, border: str):
    """Why the JAX package's ``fused_nd_pass`` declines ``groups`` =
    [(axis, scans, T), ...] on arrays of ``shape`` (a clamp border with
    pad, a tile below the order, more than 256 tiles), or None."""
    for axis, scans, T in groups:
        w, k = shape[axis], max(s.order for s in scans)
        T = int(min(max(T, k), w))
        n = -(-w // T)
        if border == BorderMode.CLAMP and n * T - w:
            return f"axis {axis}: clamp border with pad"
        if T < k:
            return f"axis {axis}: tile {T} below the order {k}"
        if n > dimfuse._CHAIN_MATMUL_MAX_TILES:
            return f"axis {axis}: {n} tiles"
    return None


class OverlapND(nn.Module):
    """Every scanned dimension's carries from ONE read of the image — the
    JAX package's ``fused_nd_pass`` (D ≥ 2 scanned axes): with Y_e the
    image after dims 0..e's completions, dim d's raw tails are

        G_d ∘ Y_{d-1} = V_{d-1},   V_{-1} = G_d ∘ x   (a pass-1 moment)
        V_e = Btot_e ∘ V_{e-1} + Rcat_e ∘ (G_d ∘ N_e)

    so after one read everything is carry-sized until the D completions.
    ``groups`` = [(axis, scans, T), ...]; :func:`nd_decline` must pass.
    With two groups it is also the pair's einsum form past the kernel
    path (the JAX package's ``fused_2d_pass``), ``route`` ``"pair"``; as
    ``fused_nd_pass`` it is ``"nd"``. Every product, the big einsums over
    the image included, runs in float64 (as the port's ``highest`` einsum
    passes do), float32 out; no kernel; ``forward_plain`` is
    ``forward``."""

    def __init__(self, shape, groups, border: str, route: str = "nd"):
        super().__init__()
        self.route = route
        why = nd_decline(shape, groups, border)
        if why:
            raise ValueError(f"fused_nd_pass declines: {why}")
        clamp = border == BorderMode.CLAMP
        self.shape = tuple(int(e) for e in shape)
        self.infos = []
        letters = iter("abcdefghijklmnop")
        tiled = {}
        for d, (axis, scans, T) in enumerate(groups):
            w, k = self.shape[axis], max(s.order for s in scans)
            T = int(min(max(T, k), w))
            n = -(-w // T)
            m = dimfuse.prepare_dim_pass(scans, T, n, clamp,
                                         pad_slots=n * T - w)
            G, R = _cat_mats(m)
            self.infos.append(dict(axis=axis, T=T, n=n, pad=n * T - w, w=w,
                                   K=G.shape[1]))
            for name, M in (("G", G), ("R", R), ("B", m.Btot),
                            ("CM", dimfuse.combined_solve_matrix(m, n))):
                self.register_buffer(f"{name}{d}", _stack64(M))
            tiled[axis] = d
        view, axl = [], []
        for ax in range(len(self.shape)):
            if ax in tiled:
                inf = self.infos[tiled[ax]]
                inf["nl"], inf["sl"] = next(letters), next(letters)
                view += [inf["n"], inf["T"]]
                axl += [inf["nl"], inf["sl"]]
            else:
                view.append(self.shape[ax])
                axl.append(next(letters))
        self.view, self.in_str = view, "".join(axl)

    def _on(self, M, V, d):
        inf = self.infos[d]
        out = self.in_str.replace(inf["sl"], "z")
        return _apply_stack(M, V, f"{inf['nl']}z{inf['sl']},"
                            f"{self.in_str}->{out}")

    def _solve(self, V, d):
        inf = self.infos[d]
        return _solve_lines(V, self.in_str.index(inf["nl"]),
                            self.in_str.index(inf["sl"]),
                            getattr(self, f"CM{d}"))

    def _slice_k(self, V, d):
        inf = self.infos[d]
        return V.narrow(self.in_str.index(inf["sl"]), 0, inf["K"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.shape:
            raise ValueError(f"input shape {tuple(x.shape)} != {self.shape}")
        nd = len(self.shape)
        pads = [0, 0] * nd
        for inf in self.infos:
            pads[2 * (nd - 1 - inf["axis"]) + 1] = inf["pad"]
        xp = F.pad(x.double(), pads)
        X = xp.reshape(self.view)
        D = len(self.infos)
        N = []
        for d in range(D):
            V = self._slice_k(self._on(getattr(self, f"G{d}"), X, d), d)
            for e in range(d):
                GN = self._on(getattr(self, f"G{d}"), N[e], d)
                V = (self._on(getattr(self, f"B{e}"), V, e)
                     + self._on(getattr(self, f"R{e}"), GN, e))
            N.append(self._solve(V, d))
        Y = X
        for e in range(D):
            Y = (self._on(getattr(self, f"B{e}"), Y, e)
                 + self._on(getattr(self, f"R{e}"), N[e], e))
        Y = Y.reshape(xp.shape)
        for inf in self.infos:
            if inf["pad"]:
                Y = Y.narrow(inf["axis"], 0, inf["w"])
        return Y.to(x.dtype)

    forward_plain = forward


def fused_nd_pass(x: torch.Tensor, groups, border: str = BorderMode.ZERO):
    """Functional :class:`OverlapND`, or None where :func:`nd_decline`
    declines (the JAX package's contract)."""
    if nd_decline(x.shape, groups, border):
        return None
    return OverlapND(x.shape, groups, border).to(x.device)(x)


class OverlapFilter(nn.Module):
    """The ``overlap`` / ``overlap_k`` backends — the JAX package's
    ``apply_filter_overlap``: scanned axes in order of first appearance,
    consumed in pairs through :func:`fused_2d_module` (an odd last axis
    through :func:`.dimfuse.dim_pass_module` at ``highest``), each axis
    tiled by its split width or ``tile_default``. Without kernels
    (``overlap``) three or more scanned axes take :class:`OverlapND` where
    :func:`nd_decline` passes. ``use_kernels`` (``overlap_k``) runs the
    trailing pair on :class:`Fused2DPx` at ``px6``, ``px4`` or ``px3``
    where its gates hold, else — at every other grade too, ``default``
    among them — on :class:`Fused2DK` at the HIGHEST grade, or the pair
    fallback off its gates (:func:`fused_2d_module`, the JAX package's
    ``fused_2d_pass`` map). ``matmul_dtype="bfloat16"`` reaches the
    HIGHEST pair alone (bf16 products in ``final2d_k_bf16``); the px pair
    and the pair fallback ignore it, as in the JAX package. Integer
    filters run the sequential core. ``stages`` lists the executors;
    ``forward_plain`` runs the kernels' twins."""

    def __init__(self, spec, tile_default: int = 32,
                 use_kernels: bool = False,
                 matmul_precision: str = "highest",
                 matmul_dtype: str = "float32"):
        super().__init__()
        from .scan_core import ScanFilter, _compute_type

        spec = spec.stacked()
        _compute_type(spec.dtype)  # raises on the dtypes the port lacks
        self.ext = tuple(d.extent for d in spec.dims)
        self.core = ScanFilter(spec) if spec.dtype != "float32" else None
        tiles = spec.tile_widths or (0,) * spec.ndim
        groups = [(ax, [spec.scans[j] for j in ids], tiles[ax] or tile_default)
                  for ax, ids in spec.scans_by_axis().items()]
        stages = []
        if (self.core is None and len(groups) >= 3 and not use_kernels
                and nd_decline(self.ext, groups, spec.border) is None):
            stages = [OverlapND(self.ext, groups, spec.border)]
        elif self.core is None:
            i = 0
            while i < len(groups):
                if i + 1 < len(groups):
                    (ax_a, sc_a, Ta), (ax_b, sc_b, Tb) = groups[i:i + 2]
                    stages.append(fused_2d_module(
                        self.ext, ax_a, sc_a, Ta, ax_b, sc_b, Tb,
                        spec.border, use_kernels, matmul_precision,
                        matmul_dtype))
                    i += 2
                else:
                    ax, sc, T = groups[i]
                    stages.append(dimfuse.dim_pass_module(
                        sc, ax, self.ext, T, spec.border, "highest"))
                    i += 1
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, False)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, True)

    def _run(self, x, plain):
        if self.core is not None:
            return self.core(x)
        x = torch.as_tensor(x).to(torch.float32)
        for st in self.stages:
            x = st.forward_plain(x) if plain else st(x)
        return x.contiguous()


def apply_filter_overlap(spec, x: torch.Tensor, tile_default: int = 32,
                         use_kernels: bool = False,
                         matmul_precision: str = "highest",
                         matmul_dtype: str = "float32") -> torch.Tensor:
    """Functional :class:`OverlapFilter` on ``x``'s device."""
    x = torch.as_tensor(x)
    mod = OverlapFilter(spec, tile_default, use_kernels, matmul_precision,
                        matmul_dtype)
    return mod.to(x.device)(x)
