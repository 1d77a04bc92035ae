#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: build, check, time.

    python3 chip_smoke.py

Drives ``recfilter_tpu_torch`` (never jax) through its public API on its
paths, and fails (non-zero exit, traceback) if any phase fails.

The 2-D path: the headline filter of ``bench.py::_build_filter`` — a
3rd-order Gaussian (σ=5), causal and anticausal on x and y, 128-wide
tiles, float32, px6 — at 4096², on ``moments2d`` and ``final2d``.

The 1-D last-axis path, on ``tails`` and ``completion``:

  A  10,000,000 samples, ``audio_filter_high_order(order=2)``, tile 1000,
     zero border — the supertile hierarchy, dense level-2 solve;
  B  the same at order 29 — 4 carry slots, Kogge–Stone level 2;
  C  1,000,001 samples, the σ=5 Gaussian causal + anticausal, clamp,
     tile 1000 — the hierarchy with pad, clamp edges and couplings;
  D  64 channels × 30,000 samples, the Gaussian of C, tile 128, zero —
     one tiled pass with pad variants;
  E  64 channels × 32,768 samples, the Gaussian of C, tile 128, clamp —
     one tiled pass with first/last variants.

The rows path (a scan on a non-last axis, everything after it flattened
into lanes), on ``rows_tails`` and ``rows_final``, with the σ=5 Gaussian
causal + anticausal on every scanned axis, float32, px6, tiles of 128:

  V1  256³, zero border, ``scripts/bench_volume.py``'s filter and input
      (N(0,1)·0.01, seed 0): the rows pass on z, then the 2-D executor on
      (y, x) with the depth as its batch;
  V2  512³ (a CT volume: 0.5 GB in, 0.5 GB out), clamp border;
  S1  ``apps.gaussian_3x_3y(4096, 4096)``: x on the 1-D kernels, then y on
      the rows kernels — timed against ``gaussian_3xy``, the same filter on
      the 3-touch path;
  S2  ``apps.gaussian_1xy_2x_2y(4096, 4096)``: its three stages run all six
      kernels;
  S3  y only on 8192 × 4096, zero border: 64 tiles, the banded carry solve;
  S4  axes {0, 2} of 256 × 512 × 1024, zero border: a rows pass with
      524,288 lanes, then a last-axis pass (x split at 128).

The banded FIR path, on ``fir_band`` (input N(0,1)·0.01, seed 2; F2's
SAT variant N(0,1), seed 3):

  F1  ``apps.box_filter_3(4096, 4096, B=5)``: a 31-tap FIR, two passes;
  F2  ``apps.box_filter_order_1(1920, 1080, B=5)``, both variants: the FIR
      (two ``fir_band`` passes) and the SAT (the 2-D kernels + torch
      differencing);
  F3  ``apps.difference_of_gaussians(4096, 4096, 5, 9)``: a C = 2 bank of
      the box³ radii 5 and 9, then their signed contraction.

The rotated emit and the fused consumers, on ``final2d_stencil``,
``completion_rot`` (the rotated ``completion`` with its stencil) and
``stencil2d``, with ``tails`` and ``moments2d`` in their extra-row forms:

  C1  ``apps.difference_of_gaussians(4096, 4096, 5, 9, variant="sat")``:
      the SAT with both radii's 4-corner banks fused into its final
      kernel, then per radius a rotated 2nd-order x and y integral, each
      with its double difference fused, the subtraction as an epilogue
      (``bounded_image`` input, checked; then uniform [0, 1), printed);
  C2  ``apps.box_filter_3(4096, 4096, B=5, variant="sat")``: the order-1
      box (FIR at B = 5) then two rotated 2nd-order integrals;
  C3  ``apps.box_filter_6(2048, 2048, B=5, variant="sat")``: six rotated
      passes;
  C4  a y-only σ=5 Gaussian on 4096², then a 2-channel Sobel bank
      (``as_func(stencil2d=)``): the rows kernels, then ``stencil2d``;
  C5  the headline Gaussian at 4096² with the unsharp combine 2a − o as
      its epilogue (aux: the image), affine: inside ``final2d``'s store
      loop (``final2d_epi``);
  C6  a 2nd-order x integral with ``rotate_emit=2`` on (2, 1024, 2048)
      with per-slice DoG taps: the per-slice branch.

The rotation chain (``dimfuse.RotationChain``: one rotated last-axis pass
per scanned axis, each pass after the first taking its tails from the
previous pass's ``completion_rot_tails`` where the gates allow), with the
σ=5 Gaussian causal + anticausal per axis, float32, px6, 128 splits,
N(0,1)·0.01 input (seed 0) unless stated:

  K1  4096², the Gaussian twice per axis (ΣK = 12, two carry slots: no
      chaining), zero border: ``tails`` and ``completion_rot`` per pass;
  K2  ``apps.bicubic(1920, 1080)`` and ``biquintic_overlapped(1920,
      1080)``, clamp: x (15 tiles) on the kernels, y in 120-row tiles on
      the einsum form;
  K3  a 200 × 512 × 512 CT volume, zero border (the rows gates decline
      the depth): x extracts y's tails (the volume regime), y takes them,
      z runs with pad 56 — and the same filter unchained, bit-equal;
  K4  a 16 × 128 × 256 × 256 time series of volumes: x → y → z chained,
      t (16 wide) on the einsum form;
  K5  the headline 4096² filter at ``highest``: the einsum chain, no
      kernel launch;
  K6  a 512 × 40,960 panorama, zero border (320 tiles on x): x's einsum
      tails and associative solve, then ``completion_rot_tails`` (the
      image regime), y on the extracted tails.

The learnable (training) path (``learnable.LearnableRecFilter``: float64
coefficient parameters, each axis one fused pass on ``tails_traced`` and
``completion_traced``, whose matrices are runtime tensors), float32, seed
0:

  L1  the σ=5 Gaussian of the 2-D headline as a learnable filter, causal +
      anticausal on x and y, zero border, tile 128, 4096², N(0,1)·0.01
      (``image``): one forward;
  L2  10 Adam(2e-3) steps fitting L1's coefficients from a start with
      every feedback vector scaled by 0.9 to L1's output (the same from
      Adam(2e-2), printed: the step moves b0 = 0.0226 by ~90 %);
  L3  a biquad (b0 0.3, a (0.9, −0.45): ``demo_system_id.py``'s), 8 ×
      65,536 samples, tile 128: 512 tiles, the associative-scan solve;
      10 Adam(2e-2) steps from a × 0.9.

The unsharp mask, the cascade and Tuple API and the affine epilogue in
the completion kernels (``final2d_epi``, ``completion_epi``,
``completion_rot_epi``: ``a·y + Σᵢ bᵢ·auxᵢ + c`` in the store loop),
float32, px6:

  U1  ``apps.unsharp_mask(4096, 4096)`` (σ = 5, weight 1) on ``image``:
      the merged route — ``fuse_cascade`` of ``gaussian_3x_3y``, the 3-touch
      executor, the combine (1 + w)·I − w·blur in ``final2d``'s store loop;
  U2  the same with ``fused=False``: the two stages, then the combine as
      torch ops;
  U3  the staged route at ``highest``, 1024² (no launch);
  T1  a Tuple (a, b) of two 4096² images under the headline Gaussian with
      the epilogue 2u − 3v: folded into the input, one channel filtered;
  T2  T1 with u·v: the stacked pass (batch 2), then the product;
  T3  T1 with clamp(2u − 3v, −50, 50), the components ×1e5 so the clip
      binds: not folded;
  CA  ``compute_at`` of the unsharp combine on the headline filter;
  E1  the order-2 audio filter of A on 64 channels × 32,768 samples, tile
      128, with the dry/wet mix 0.7·y + 0.3·x (one tiled pass: ``tails``,
      then ``completion_epi``; a bare 10M-sample signal is one line, below
      the kernels' 8, and an epilogue declines the supertile hierarchy, so
      its mix runs on the einsum form in both packages);
  E2  K1 with the unsharp combine on the chain's last pass
      (``completion_rot_epi``).

The integer route, on ``int_scan`` and ``int_seg_scan`` (bit exact, with
wrap-around):

  I1  ``apps.summed_table(4096, 4096, dtype="int32")`` over an 8-bit
      image (values 0..255: the table wraps past 2^31);
  I2  int16 and int8 at 2048² over the full value range: x with
      (f=2, a=-1) causal, (1, -1) and (3, +1) anticausal, y a SAT scan;
  I3  an int32 cumsum of 8 channels × 10,000,000 samples: the segmented
      last-axis route (chunks of 3,200);
  I4  a y-only int32 SAT on 16384 × 4096: the segmented other-axis route.

Phases:

  1. the card, its power limit and the fp32 matmul and convolution
     settings; build the CUDA kernels from
     ``recfilter_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, all
     at once);
  2. each kernel against its plain PyTorch twin on the card at its path's
     shapes (2-D: 4096² zero and clamp, 1080×1920 padded; 1-D: A, B, E;
     rows: V1, V2, S3; FIR: both passes of F1 and F3, flat passes at the
     ragged L = 1000; integer: I1–I4): max|kernel − twin| ≤
     1e-5·max|twin|, carry pad slots written as zeros; the integer kernels
     bit-equal;
  3. each path end to end through ``RecFilter.as_func()`` (the cascades
     through ``RecFilter.realize`` / ``apps.run_cascade``) on the card, the
     launch counts set to 0 just before each call and read just after: the
     2-D cases launch moments2d and final2d once each and no 1-D kernel;
     A, B, D, E launch tails and completion once each, C twice (one per
     scan), and no 2-D kernel; V1 and V2 launch rows_tails, rows_final,
     moments2d and final2d once each; S1's second stage and S3 the two
     rows kernels only; S2 all six once; S4 the rows and 1-D kernels once.
     Error against the f64 reference ≤ 2e-6 of the peak (5e-6 for C) — the
     JAX package's bounds. The 10M cases are held to
     ``scipy.signal.lfilter`` in float64, itself checked against the
     definitional oracle on a 100,000-sample prefix; every other case to
     the oracle itself (a cascade to the oracle of its whole filter).
     F1 and F3 launch ``fir_band`` twice, F2's FIR variant too and its SAT
     variant the 2-D kernels once each; F1 and F2 sit within 2e-6 of the
     f64 FIR oracle's peak (F2's SAT variant within the JAX test's
     rtol = 1e-3, atol = 1e-4 of the box oracle), F3 within 5e-6 of the
     peak of the difference. I1 and I2 launch ``int_scan`` once per axis,
     I3 and I4 each segmented phase once; all four are bit-equal to
     numpy's wrapping int32 cumsum (I2: to the integer oracle). C1
     launches moments2d and final2d_stencil once, tails four times,
     completion_rot three times and completion_rot_epi once (the
     subtraction, its last pass's affine epilogue); C2 fir_band, tails and completion_rot
     twice; C3 tails and completion_rot six times; C4 the rows kernels
     and stencil2d once; C5 moments2d and final2d_epi once; C6 tails and
     completion_rot once per slice (the extra-row tails of C1 and C6 as
     tails_extra). C1–C3, on ``bounded_image`` input (every integral the
     SAT apps take stays bounded, so the fp32 formulation holds), within
     1e-3 of their f64 formulation oracles' peak at every pixel and 2e-4
     short of the far margin; C2 there within 2e-4 of the FIR form, and at
     128² equal to it within rtol = 1e-3, atol = 1e-4; C1 on uniform
     [0, 1) input printed, not checked (the JAX test's whole-image metric
     and the error short of the far margin: the fp32 formulation's own
     loss at 4096², PERF.md); C4
     within 2e-5 of the peak, C5 2e-6, C6 2e-5 of the producer's. Before
     these (phase 2e) the new and extended kernels against their twins at
     C1's shapes — moments2d's edge rows, final2d_stencil with the
     dual-radius bank, tails_extra, completion_rot with and
     without a stencil in all four start/end modes, stencil2d with C = 2
     — on integer-valued input whose integrals stay bounded, exact in
     fp32 so that only a fault separates kernel and twin, within 1e-5 of
     the twin's peak; phase 2f holds ``completion_rot_tails`` to its twin
     bit for bit on integer-valued input at K3's and K6's first-pass
     shapes (both regimes, clamp variants), and chains of unit
     integrators with a padded first pass and with P = 3 leading slices
     chained, unchained and on the twins, bit-equal; phase 3f runs K1–K6
     (launch counts, the route and its tails reads, within 2e-6 of the
     f64 oracle); phase 2g holds ``tails_traced`` and
     ``completion_traced`` to their twins at L1's x-axis shapes (q 4096,
     n 32, S 6: 1e-5 of the twin's peak, pad slots zeros), and phase 3g
     runs L1 (``tails_traced`` and ``completion_traced`` twice each, no
     other kernel, within 2e-6 of the f64 oracle), L2 (the first step's
     coefficient gradients within rtol = 1e-4, atol = 1e-4·max|g| of the
     plain path's — the twins on the card — and the loss falls over the
     10 steps) and L3 (one launch each, within 2e-6 of
     ``scipy.signal.lfilter``'s peak, gradients and a falling loss as
     L2, the gradients also against autograd through the float64 einsum
     route at 64-wide tiles, the same parameters);
     Phase 2h holds the epilogue entries to their twins (1e-5 of the
     twin's peak): ``final2d_epi`` at 4096² with k = 1 (the unsharp
     combine) and k = 2 with a bias, ``completion_epi`` at A's kernel pass
     (306 lines × 256 tiles), ``completion_rot_epi`` at C1's x pass with
     and without its fused 3-tap stencil; phase 3h runs U1 (moments2d and
     final2d_epi once, nothing else; within 2e-6 of the f64 oracle
     (1 + w)·I − w·oracle(blur)), U2 (2e-6; U1 − U2 within 1e-6 of the
     peak), U3 (no launch, 2e-6), T1 (folded: moments2d and final2d once;
     5e-6 of the component-wise oracle's peak), T2 and T3 (staged, the
     same bound; T3 against the clipped oracle), CA (the epilogue route,
     final2d_epi; against the composition within 1e-6), E1 (tails and
     completion_epi, 2e-6 of ``lfilter``'s peak) and E2 (two tails, one
     completion_rot and one completion_rot_epi, 2e-6 of the oracle);
     phase 2i holds the other backends' kernels to their twins (1e-5 of
     the twin's peak): ``moments2d_k`` and ``final2d_k`` (the HIGHEST
     2-D pair of ``overlap_k``) at 4096² with Ta = 128, K = 6, at Ta = 32
     and at K = 12, ``dim_pass_rows`` and ``dim_pass_cols`` (the strip
     passes of ``pallas``) at 4096² zero and clamp, 1080 × 1920 and
     1920 × 1080 zero (a padded tail on either axis) and with a
     ``line_block`` of 64; phase 3i runs every other backend through
     ``as_func()``, launches asserted and within 2e-6 of the f64 oracle:
     O1 the headline on ``overlap_k`` at ``highest`` (one moments2d_k,
     one final2d_k), O2 the Gaussian twice per axis at 4096² on
     ``overlap_k`` at px6 (ΣK = 12: the px pair declines, the HIGHEST
     pair runs), O3 the headline on ``overlap_k`` at px6 (moments2d,
     final2d), O4 ``overlap`` on V1's 256³ (``fused_nd_pass``, float64
     einsums, no launch) and on a 1080 × 1920 clamp frame (two dimension
     passes), P1 the headline with ``intra_schedule(1).compute_locally()``
     (one dim_pass_rows, one dim_pass_cols), P2 the clamp frame on
     ``pallas`` (x on dim_pass_rows, y padded: the blocked algebra), P3
     256³ on ``pallas`` (dim_pass_cols twice, dim_pass_rows once), B1 and
     S1 the headline at 1024² on ``blocked`` and ``scan``, S3 an untiled
     1024² headline (``auto``: the sequential core), and S2 an int32 SAT
     2048² on ``pallas`` (the core, bit-equal to numpy's cumsum);
     phase 2j holds the 2-D executor's optional kernels and the bench's
     probe to their twins at the headline's shapes (4096²): ``bsolve``
     (the dim-B carry glue and its solve, on the glue's dim-A carries)
     and ``moments2d_naf`` (pass 1 with the dim-A solve inside, clusters
     of 16 blocks) within 1e-5 of the twin's peak, ``copy`` bit-equal;
     phase 3j runs the headline on its four carry routes, each built by
     ``as_func()`` under ``RECFILTER_PX2D_BK`` / ``RECFILTER_PXM_NAF``
     (glue, BK, NAF, BK + NAF: ``carry_route`` and ``moments_route``
     checked, launches asserted, each within 2e-6 of the f64 oracle, a
     profile of each: device ops, busy time, idle share), then
     ``recfilter_tpu_torch.bench.main()`` in-process (its stderr line and
     JSON line: the headline's Mpix/s against the roofline of the
     bandwidth its ``copy`` measures); phase 3k times ``bsolve``,
     ``moments2d_naf`` and ``copy`` there as phase 5 times the other
     kernels (it runs early: late profiler windows lose their device
     events), ``bsolve`` beside the glue ops it replaces,
     ``moments2d_naf`` beside ``moments2d`` then the glue's dim-A solve,
     ``copy`` beside one ``torch.mul`` (the library form) with the
     bandwidth it measures, and the headline's four carry routes in turns
     (glue, BK, NAF, BK + NAF, then back);
  4. gradients of sum(y²) through the kernel path against the plain path,
     within rtol = atol = 1e-4: 2-D at 512², 1-D at 300,000 samples (order
     3, the hierarchy), a 128 × 128 × 256 volume, ``box_filter_3`` at
     512², K3's chain at 200 × 128 × 128; and of <y, ct> through C1's
     stencil2d stage and a rotated stencil pass at 512²; U1's input
     gradient (through the filter and the combine's aux) against U2's at
     4096²;
  5. device times (CUDA events, median of single calls) of the whole call
     and of each kernel, beside their plain twins and, where one PyTorch
     call computes a kernel's function, beside that call; for A, B and V1
     also a profile of one call (device ops, busy time, idle share); for
     A and B the first-call host build; for A–E the error of the
     fp32-accumulating tails variant, end to end; for F1, F3, I1 and I3
     the new kernels' event, device, twin and library times (``conv1d``
     with the same taps, ``torch.cumsum(..., dtype=torch.int32)``) and the
     whole call against the plain path with the device's idle share; for
     the new and extended kernels at C1's shapes (stencil2d at C4's) the
     same, with ``conv2d``, ``matmul`` and ``einsum`` as yardsticks, and
     the whole calls of C1–C5; for ``completion_rot_tails`` at K3's first
     pass the same, beside ``completion_rot`` + ``tails`` and, as the
     library form, one ``matmul`` and one ``einsum`` (two calls), and the
     whole calls of K1–K6; for ``tails_traced`` and ``completion_traced``
     at L1's x-axis shapes the same, with one ``matmul`` each as the
     library form, the whole L1 and L3 forwards, and L2's training step
     (event median, device ops per step); the L1 forward and L2 step (32
     tiles) and L3's (512 tiles) with the cross-tile solve forced to the
     dense solve from W powers and to the associative scan; for U1 and U2
     the whole calls with their profiles, and the three epilogue entries
     at U1's, A's and C1's shapes beside their twins, ``final2d_epi``
     also beside ``final2d`` then the combine as torch ops,
     ``completion_epi`` beside one ``addmm`` (the mix's a and b as its
     alpha and beta) as the library form; for ``moments2d_k`` and
     ``final2d_k`` at O1's shapes and ``dim_pass_rows`` /
     ``dim_pass_cols`` at P1's the same (no PyTorch call computes any of
     the four), the whole calls O1, O2, P1 and P3 with their profiles,
     B1 and S1 (median of 5 calls: the sequential core is a loop of small
     launches), and each strip pass of P1, P2 and P3 at every line block
     that fits beside ``pick_line_block``'s own choice
     (:func:`line_block_sweep`). A profiled window that comes back without device events is taken
     again (three tries); past that a kernel's device time is its
     CUDA-event time over 10 back-to-back calls, and a note says so.

The last line is the JSON result; the line before it is the card's name
and power limit; before that a JSON line describes each kernel, with its
bound: the larger of its bytes over 3.35 TB/s and its operations over the
fp32 (67 TFLOP/s, outside the tensor cores) or fp64 (67 TFLOP/s on the
tensor cores, DMMA: the card's peak for the type, though the kernels
summing in fp64 — the tails kernels, ``tails_traced``, ``moments2d_k`` and
the strip kernels among them — run their fp64 on the CUDA cores at half
of it) peak of an H100 SXM, or for the integer kernels over its int32 add
rate (132 SMs × 64 INT32 lanes × 1.98 GHz = 16.7 Tops/s, from the SM's
unit count in NVIDIA's Hopper white paper).
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H = W = 4096
N_TIMED = 25
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores, fp64 FLOP/s on them (DMMA: the card's peak for fp64)
PEAK_BYTES, PEAK_FP32, PEAK_FP64 = 3.35e12, 67e12, 67e12
PEAK_INT32 = 132 * 64 * 1.98e9  # int32 adds/s (module docstring)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_filter(rft, h, w, image, clamp=False):
    """``bench.py::_build_filter`` against the port's RecFilter."""
    wts = rft.gaussian_weights(5.0, 3)
    x, y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("GaussianIIR")
    if clamp:
        F.set_clamped_image_border()
    F[y, x] = image
    for d in (+x, -x, +y, -y):
        F.add_filter(d, wts)
    F.split(x, 128, y, 128)
    return F


def usm_combine(blur, img):
    """The unsharp combine (1 + w)·I − w·blur at w = 1 (C5, CA, E2)."""
    return 2.0 * img - blur


def image(*shape, seed=0):
    import numpy as np

    # bench.py's input: N(0,1)·0.01 from np.random.default_rng(seed)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.01
            ).astype(np.float32)


def gauss_axes(rft, shape, axes, clamp=False, name="GaussianND", times=1):
    """The σ=5 3rd-order Gaussian, causal + anticausal on each of
    ``axes`` (in that order; ``times`` over), tiles of 128, bound to
    ``image(*shape)``: ``scripts/bench_volume.py``'s filter for
    ``axes = (0, 1, 2)``."""
    wts = rft.gaussian_weights(5.0, 3)
    dims = [rft.Dim(nm, e) for nm, e in zip("vwzyx"[-len(shape):], shape)]
    F = rft.RecFilter(name)
    if clamp:
        F.set_clamped_image_border()
    F[tuple(dims)] = image(*shape)
    for ax in axes:
        for _ in range(times):
            F.add_filter(+dims[ax], wts)
            F.add_filter(-dims[ax], wts)
    F.split({dims[ax]: 128 for ax in axes})
    return F


# the headline's carry routes: (RECFILTER_PX2D_BK, RECFILTER_PXM_NAF)
ROUTES = {"glue": (False, False), "BK": (True, False), "NAF": (False, True),
          "BK+NAF": (True, True)}
ROUTE_VARS = ("RECFILTER_PX2D_BK", "RECFILTER_PXM_NAF")


def route_module(F, bk, naf):
    """``F.as_func()`` built with each route's variable set to "1" where
    asked and unset otherwise (the module reads them once, when built)."""
    saved = {v: os.environ.pop(v, None) for v in ROUTE_VARS}
    try:
        for var, on in zip(ROUTE_VARS, (bk, naf)):
            if on:
                os.environ[var] = "1"
        return F.as_func()
    finally:
        for var, val in saved.items():
            os.environ.pop(var, None)
            if val is not None:
                os.environ[var] = val


def counted(fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before the call
    and read just after: (output, counts)."""
    import torch

    from recfilter_tpu_torch.kernels import launch

    torch.cuda.synchronize()
    launch.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(launch.LAUNCHES)


def roofline(nbytes, flops, rate):
    """(bound_ms, bound_by): the least time for ``nbytes`` of traffic and
    ``flops`` operations at ``rate`` — the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def median_ms(fn, *args):
    """Median single-call CUDA-event time of ``fn(*args)``."""
    from recfilter_tpu_torch.utils import timing

    return statistics.median(timing.call_times_ms(
        fn, *args, iterations=2 * N_TIMED, warmup=3))


def device_ms(fn, *args):
    """Device time per call of ``fn(*args)`` from the profiler — the sum
    of its kernels and copies, free of the host's launch gaps that a
    host-bound single call adds to its CUDA-event time. Where no profiled
    window recorded every device event, the CUDA-event time per call of
    10 back-to-back calls stands in, and a note says so."""
    from recfilter_tpu_torch.utils import timing

    busy = timing.device_profile(fn, *args, iterations=10)["busy_ms"]
    if busy is not None:
        return busy
    ms = timing.benchmark(fn, *args, iterations=10) / 10
    print(f"  note: no profiled window recorded every device event of "
          f"{getattr(fn, '__name__', type(fn).__name__)}; CUDA events of 10 "
          f"back-to-back calls instead: {ms:.4f} ms", flush=True)
    return ms


def busy_text(prof):
    """A profile's device busy time and idle share, or "not measured"
    where no profiled window recorded every device event."""
    if prof["busy_ms"] is None:
        return "not measured"
    return f"{prof['busy_ms']:.4f} ms, idle {100 * prof['idle']:.1f} %"


def oracle_err(spec, x_np, y):
    """max|y − oracle| / max|oracle| against the f64 oracle of ``spec``."""
    import numpy as np

    from recfilter_tpu_torch import scan_core

    want = scan_core.oracle_apply(spec, x_np.astype(np.float64))
    got = y.cpu().numpy().astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def gauss_1d(rft, shape, tile, clamp):
    """The σ=5 3rd-order Gaussian, causal + anticausal, on the last axis
    of ``shape``; channels on a leading axis."""
    dims = [rft.Dim("t", shape[-1])]
    if len(shape) == 2:
        dims.insert(0, rft.Dim("c", shape[0]))
    F = rft.RecFilter("Gaussian1D")
    if clamp:
        F.set_clamped_image_border()
    F[tuple(dims)] = signal(shape)
    wts = rft.gaussian_weights(5.0, 3)
    F.add_filter(+dims[-1], wts)
    F.add_filter(-dims[-1], wts)
    F.split(dims[-1], tile)
    return F


def signal(shape, seed=6):
    import numpy as np

    return (np.random.default_rng(seed).standard_normal(shape) * 0.1
            ).astype(np.float32)


def rel_err(got, want):
    """max|got − want| / max|want| (both torch tensors)."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def paired_times(kernel_fn, plain_fn, *args):
    """Medians (kernel, plain) of single-call CUDA-event times, taken in
    turns plain, kernel, kernel, plain."""
    from recfilter_tpu_torch.utils import timing

    k, p = [], []
    for fn, acc in ((plain_fn, p), (kernel_fn, k), (kernel_fn, k),
                    (plain_fn, p)):
        acc += timing.call_times_ms(fn, *args, iterations=N_TIMED, warmup=3)
    return statistics.median(k), statistics.median(p)


def line_block_sweep(rft, dev, card):
    """Each strip pass of P1 (4096², zero), P2 (1080 × 1920 clamp: the x
    pass; y takes the blocked algebra) and P3 (256³) at every line block
    that fits shared memory, beside the block ``pick_line_block`` takes
    on its own: CUDA-event medians of single calls, in turns (ascending,
    then descending). Each block's output is held to the default's at
    1e-6 of its peak. Returns [(label, {block: ms}, picked)]."""
    import torch

    from recfilter_tpu_torch.kernels import fused

    cases = (("P1", build_filter(rft, H, W, image(H, W))),
             ("P2", build_filter(rft, 1080, 1920, image(1080, 1920), True)),
             ("P3", gauss_axes(rft, (256, 256, 256), (0, 1, 2))))
    out = []
    with torch.no_grad():
        for tag, F in cases:
            F.set_plan(backend="pallas")
            mod = F.as_func(device=dev)
            v = torch.from_numpy(F._image).to(dev)
            for i, st in enumerate(mod.stages):
                if st.route == "blocked":
                    v = st(v)
                    continue
                body, X = st.body, st.kernel_input(v)
                rows = st.route == "rows"
                lines, outer = ((X.shape[0], 1) if rows
                                else (X.shape[2], X.shape[0]))
                picked = fused.pick_line_block(lines, outer, body.T, body.K,
                                               rows)
                y0 = body(X)
                fits = [lb for lb in (16, 32, 64) if fused.pick_line_block(
                    lines, outer, body.T, body.K, rows, lb) == lb]
                ms = {lb: [] for lb in fits}
                for lb in fits + fits[::-1]:
                    body.line_block = lb
                    ms[lb].append(median_ms(body, X))
                for lb in fits:
                    body.line_block = lb
                    check(rel_err(body(X), y0) <= 1e-6,
                          f"LB {tag} axis {st.axis}: {lb} lines a block "
                          "agree with the default")
                body.line_block = 0
                med = {lb: statistics.median(t) for lb, t in ms.items()}
                label = (f"{tag} {st.route} axis {st.axis} ({lines} lines, "
                         f"outer {outer}, T {body.T}, K {body.K})")
                print(f"  LB {label}: " + ", ".join(
                    f"{lb} lines {med[lb]:.4f} ms (turns "
                    f"{ms[lb][0]:.4f}, {ms[lb][1]:.4f})" for lb in fits)
                    + f"; picked {picked}, fastest {min(med, key=med.get)} "
                    f"on {card}", flush=True)
                out.append((label, med, picked))
                v = st(v)
            del v
    return out


def lfilter_reference(spec, x):
    """Zero-border causal single-scan filters: scipy's lfilter in float64
    with b = [b0], a = [1, −a1, …, −ak]."""
    import numpy as np
    from scipy.signal import lfilter

    (s,) = spec.scans
    assert s.causal and spec.border == "zero"
    return lfilter([s.feedfwd], [1.0] + [-a for a in s.feedback],
                   x.astype(np.float64))


def sep_oracle(img, taps):
    """The f64 FIR oracle of ``taps`` along x, then along y."""
    from recfilter_tpu_torch.fir import fir_oracle

    return fir_oracle(fir_oracle(img, taps, 1), taps, 0)


def ints(shape, lo, hi, dtype, seed):
    import numpy as np

    return np.random.default_rng(seed).integers(lo, hi, shape, endpoint=True
                                                ).astype(dtype)


def int_filter(rft, img, axes_coeffs, tile=128):
    """An integer filter over ``img``: ``axes_coeffs`` lists (axis, causal,
    [feed-forward, feedback]) in order; every scanned axis split at
    ``tile``."""
    dims = [rft.Dim(nm, e) for nm, e in zip("zyx"[-img.ndim:], img.shape)]
    F = rft.RecFilter("IntegerScan")
    F[tuple(dims)] = img
    for ax, causal, coeff in axes_coeffs:
        F.add_filter(+dims[ax] if causal else -dims[ax], coeff)
    F.split({dims[ax]: tile for ax, _, _ in axes_coeffs})
    return F


def seg_route(int_scan, unit, plain):
    """The segmented route of one unit scan on the last axis of a (rows, E)
    tensor: both phase kernels (or their twins) and the carry chain."""
    def run(xr):
        C = int_scan._chunk_len(xr.shape[1])
        carries = (int_scan.seg_carries_plain if plain
                   else int_scan.seg_carries)(xr, unit, 0, C)
        inc = int_scan._carry_chain(carries, unit[2])
        return (int_scan.seg_fix_plain if plain
                else int_scan.seg_fix)(xr, inc, unit, 0, C)
    return run


def max_int_diff(a, b):
    return (a.long() - b.long()).abs().max().item()


# C4's bank: the two Sobel gradients (dy, dx, coeff)
SOBEL = [[(-1, -1, -1.0), (0, -1, -2.0), (1, -1, -1.0), (-1, 1, 1.0),
          (0, 1, 2.0), (1, 1, 1.0)],
         [(-1, -1, -1.0), (-1, 0, -2.0), (-1, 1, -1.0), (1, -1, 1.0),
          (1, 0, 2.0), (1, 1, 1.0)]]


def exact_ints(shape, axes, seed):
    """Integer-valued float32 input whose integrals stay bounded: the
    discrete derivative (one per entry of ``axes``) of an integer field in
    [-8, 8]. An integrator's sums over it are exact in fp32, so a kernel
    and its twin differ only where the kernel is wrong — with real-valued
    input the differencing consumers cancel the integrals' leading digits
    and the rounding of two summation orders differs by far more than
    1e-5 of the output."""
    import numpy as np

    r = np.random.default_rng(seed).integers(-8, 8, shape, endpoint=True)
    for ax in axes:
        r = np.diff(r, axis=ax, prepend=0)
    return r.astype(np.float32)


def bounded_image(n, m, seed, rad=4):
    """An (n, n) float32 input on which the SAT apps' fp32 formulation is
    well conditioned at any size: the 2nd y- and x-difference of an integer
    field (values in [-8, 8] box-summed over radius ``rad``, so the signal
    sits in the box and DoG pass bands), zero in the m-pixel margins. Every
    integral the apps take of it — the table, the 2nd-order x and y
    integrals — stays bounded, so their fp32 sums keep the digits the
    differenced output needs. Image-like input lets the integrals grow to
    1e6–1e7 at 4096², and the differencing cancels the output's digits
    (PERF.md, PR 5)."""
    import numpy as np

    r = np.random.default_rng(seed).integers(-8, 8, (n, n), endpoint=True)
    for ax in (0, 1):  # box sums over [i - rad, i + rad], clipped
        c = np.concatenate([np.zeros_like(r[:1]) if ax == 0
                            else np.zeros_like(r[:, :1]),
                            r.cumsum(ax)], axis=ax)
        i = np.arange(n)
        r = (np.take(c, np.minimum(i + rad + 1, n), axis=ax)
             - np.take(c, np.maximum(i - rad, 0), axis=ax))
    r[:m] = r[n - m - 2:] = 0
    r[:, :m] = r[:, n - m - 2:] = 0
    for ax in (0, 0, 1, 1):
        r = np.diff(r, axis=ax, prepend=0)
    return r.astype(np.float32)


def zero_margin(img, m):
    """``img`` with an m-pixel zero margin (the box and DoG apps'
    zeroed-margin contract)."""
    img = img.copy()
    img[:m] = img[-m:] = 0
    img[:, :m] = img[:, -m:] = 0
    return img


def shift_np(f, off, ax):
    """f[i + off] along ``ax``: clamped past the far edge, zero before the
    start (the apps' border rule)."""
    import numpy as np

    n = f.shape[ax]
    idx = np.arange(n) + off
    g = np.take(f, np.clip(idx, 0, n - 1), axis=ax)
    if off < 0:
        keep = (idx >= 0).astype(f.dtype)
        g = g * (keep[:, None] if ax == 0 else keep)
    return g


def ddiff_np(f, B, ax):
    """The double difference of a 2nd-order integral at radius B."""
    n = float(2 * B + 1)
    return (shift_np(f, 2 * B, ax) - 2.0 * shift_np(f, -1, ax)
            + shift_np(f, -2 * B - 2, ax)) / (n * n)


def dog_oracle(img, B1, B2):
    """The six-stage SAT DoG untiled in float64 (``tests/test_apps.py``'s
    oracle): cumsum integrals and the apps' shifts."""
    s = img.astype("float64").cumsum(1).cumsum(0)
    g = []
    for B in (B1, B2):
        d = shift_np(s, B, 0) - shift_np(s, -B - 1, 0)
        b = (shift_np(d, B, 1) - shift_np(d, -B - 1, 1)) / (2 * B + 1) ** 2
        b2 = ddiff_np(b.cumsum(1).cumsum(1), B, 1)
        g.append(ddiff_np(b2.cumsum(0).cumsum(0), B, 0))
    return g[0] - g[1]


def box2_oracle(f, B):
    """``box_filter_order_2``'s formulation in float64: a 2nd-order x
    integral and its double difference, then the same along y."""
    f = ddiff_np(f.astype("float64").cumsum(1).cumsum(1), B, 1)
    return ddiff_np(f.cumsum(0).cumsum(0), B, 0)


def stencil_np(y, bank):
    """The 2-D shifted-tap bank in float64 (the stencil2d border rule)."""
    return [sum(c * shift_np(shift_np(y, dy, 0), dx, 1) for dy, dx, c in taps)
            for taps in bank]


def interior_err(got, want, m):
    """max|got − want| and max|want| on [0, n − m)²: the region short of
    the far margin, where the clamped integrals of the SAT formulation are
    not the zero-fill filter."""
    import numpy as np

    v = (slice(0, want.shape[0] - m), slice(0, want.shape[1] - m))
    return float(np.abs(got[v] - want[v]).max()), float(np.abs(want[v]).max())


def sat_check(tag, got, want, m):
    """A SAT app's output against its f64 formulation oracle, on
    ``bounded_image`` input: every pixel within 1e-3 of the oracle's peak,
    and short of the far margin within 2e-4 of it — both well below a
    typical value (the median |oracle| there is about 0.13 of the peak)."""
    import numpy as np

    n0, n1 = want.shape
    peak = float(np.abs(want).max())
    e_all = float(np.abs(got - want).max())
    e_in, _ = interior_err(got, want, m)
    med = float(np.median(np.abs(want[:n0 - m, :n1 - m])))
    print(f"  {tag}: max|y - oracle| = {e_all:.4g} ({e_all / peak:.4e} of "
          f"the peak {peak:.4g}, {e_all / med:.4e} of the median |oracle| "
          f"{med:.4g}); short of the far margin {e_in:.4g} "
          f"({e_in / peak:.4e} of the peak)")
    check(e_all <= 1e-3 * peak, f"{tag}: every pixel within 1e-3 of the f64 "
          "formulation oracle's peak")
    check(e_in <= 2e-4 * peak, f"{tag}: short of the far margin within 2e-4 "
          "of the oracle's peak")


def learnable_kernels(rft, dev, size):
    """Phase 2g: ``tails_traced`` and ``completion_traced`` against their
    twins at L1's x-axis shapes — the σ=5 Gaussian's learnable matrices
    (x: ΣK = 6) on ``image(size, size)`` as (size, size / 128, 128), the
    carries solved from the twin's tails. Returns (model, x, the kernels'
    inputs (X, G, Btot, Rcat, N), max|kernel − twin| per kernel)."""
    import torch

    from recfilter_tpu_torch import learnable as tlrn
    from recfilter_tpu_torch.kernels import completion as kcomp

    F = build_filter(rft, size, size, image(size, size))
    model = tlrn.LearnableRecFilter(F.spec, tile_width=128, device=dev)
    x = torch.from_numpy(image(size, size)).to(dev)
    with torch.no_grad():
        pl = [(s.causal, model.params[f"scan{i}"]["b0"],
               model.params[f"scan{i}"]["a"])
              for i, s in enumerate(F.spec.scans) if s.axis == 1]
        base, G, Hc, Btot, Rhat = tlrn._dim_mats_learnable(pl, 128)
        X = x.reshape(size, size // 128, 128)
        Gcat = torch.cat(G).float()
        Btot32, Rcat32 = Btot.float(), torch.cat(Rhat, 1).float()
        bk = kcomp.tails_traced(X, Gcat)
        bp = kcomp.tails_traced_plain(X, Gcat)
        Nt8 = tlrn.traced_carries(bp, base, Hc)
        yk = kcomp.completion_traced(X, Btot32, Rcat32, Nt8)
        yp = kcomp.completion_traced_plain(X, Btot32, Rcat32, Nt8)
    sync(dev)
    S = Gcat.shape[0]
    errs = {}
    for name, got, want in (("tails_traced", bk, bp),
                            ("completion_traced", yk, yp)):
        err = rel_err(got, want)
        errs[name] = (got - want).abs().max().item()
        print(f"  L1 x pass {name} {tuple(X.shape)} -> {tuple(got.shape)}: "
              f"max|k-p|/max|p| = {err:.3e}")
        check(err <= 1e-5, f"L1 x pass {name} within 1e-5 of its twin's peak")
    check(not bk[:, S:].any(), f"L1 x pass tails_traced: pad slots {S}..7 "
          "written as zeros")
    return model, x, (X, Gcat, Btot32, Rcat32, Nt8), errs


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def coeff_grads(model, fwd, x, target):
    """The coefficient gradients of mean((fwd(x) − target)²), flattened."""
    import torch

    model.zero_grad()
    ((fwd(x) - target) ** 2).mean().backward()
    g = torch.cat([p.grad.flatten() for p in model.parameters()])
    model.zero_grad()
    return g


def grads_match(label, model, x, target, ref=None):
    """The first training step's coefficient gradients of mean((y − t)²)
    through the kernels against the plain path (the twins on the same
    device) and, given ``ref`` (a model with the same parameters on the
    float64 einsum route), against autograd through it: within rtol =
    1e-4 and atol = 1e-4 of the largest (the gradients of a mean over
    16.7M pixels are ~1e-8, so a bare atol of 1e-4 would hold anything)."""
    gk = coeff_grads(model, model.forward, x, target)
    refs = [("plain path", coeff_grads(model, model.forward_plain, x,
                                       target))]
    if ref is not None:
        refs.append(("float64 einsum route",
                     coeff_grads(ref, ref.forward, x, target)))
    for what, gp in refs:
        dg, top = (gk - gp).abs(), gp.abs().max()
        print(f"  {label}: first-step gradients, max|g_kernel - g| = "
              f"{dg.max().item():.3e} against the {what} (max|g| = "
              f"{top.item():.3e})")
        check(bool((dg <= 1e-4 * gp.abs() + 1e-4 * top).all()),
              f"{label}: gradients within rtol = 1e-4, atol = 1e-4·max|g| of "
              f"the {what}'s")


def perturbed(tlrn, spec, dev):
    """A learnable filter of ``spec`` started with every feedback vector
    scaled by 0.9."""
    import torch

    m = tlrn.LearnableRecFilter(spec, tile_width=128, device=dev)
    with torch.no_grad():
        for p in m.params.values():
            p["a"].mul_(0.9)
    return m


def trainer(model, target, lr):
    """A fresh Adam(lr) and one step of it on mean((model(x) − target)²),
    as ``step(x)``, which returns the loss before the step."""
    import torch

    opt = torch.optim.Adam(model.parameters(), lr)

    def step(v):
        opt.zero_grad()
        loss = ((model(v) - target) ** 2).mean()
        loss.backward()
        opt.step()
        return loss
    return step


def train(model, x, target, lr, steps=10):
    """``steps`` Adam steps: the losses before each and after the last."""
    import torch

    step = trainer(model, target, lr)
    losses = [step(x).item() for _ in range(steps)]
    with torch.no_grad():
        losses.append(((model(x) - target) ** 2).mean().item())
    return losses


def learnable_cases(rft, dev, l1, x1, samples, counts):
    """Phase 3g: L1–L3 (module docstring) through LearnableRecFilter;
    ``counts(fn, x)`` runs a forward with the launch counts set to 0 just
    before and read just after. Returns (L1's launches, the L2 model, its
    target, the L3 model and signal)."""
    import numpy as np
    import torch

    from recfilter_tpu_torch import dimfuse as tdf
    from recfilter_tpu_torch import learnable as tlrn

    h, w = x1.shape
    with torch.no_grad():
        y1, l1_launches = counts(l1, x1)
    print(f"  L1 learnable Gaussian {h}x{w}: launches {l1_launches}")
    check(l1_launches == {k: (2 if k in ("tails_traced", "completion_traced")
                              else 0) for k in l1_launches},
          "L1: tails_traced and completion_traced twice each (x, y), no "
          "other kernel")
    check(tuple(y1.shape) == (h, w) and bool(torch.isfinite(y1).all()),
          f"L1: output finite, shape {(h, w)}")
    err = oracle_err(l1.spec, image(h, w), y1)
    print(f"  L1: max|y - oracle|/max|oracle| = {err:.3e}")
    check(err <= 2e-6, "L1: within the px6 bound 2e-6 of the f64 oracle")

    l2 = perturbed(tlrn, l1.spec, dev)
    grads_match("L2", l2, x1, y1)
    losses = train(l2, x1, y1, 2e-3)
    print("  L2 losses, Adam(2e-3), 10 steps: "
          + " ".join(f"{v:.6e}" for v in losses))
    check(losses[-1] < losses[0], "L2: the loss falls over 10 Adam(2e-3) "
          "steps")
    print(f"  L2: falls at every step: "
          f"{all(b < a for a, b in zip(losses, losses[1:]))}")
    other = train(perturbed(tlrn, l1.spec, dev), x1, y1, 2e-2)
    print("  L2 at Adam(2e-2), printed, not checked (b0 = 0.0226: a step "
          "of ~lr moves it by 90 %): " + " ".join(f"{v:.6e}" for v in other))

    spec3 = rft.FilterSpec("SysId", (rft.Dim("c", 8), rft.Dim("t", samples)),
                           (rft.Scan(1, True, 0.3, (0.9, -0.45)),))
    plan = tdf._plan_tiles(samples, 128, 2, False)
    check(plan[0] == 128 and plan[1] > 128, f"L3: {plan[1]} tiles of 128, "
          "the associative-scan solve (> 128 tiles)")
    l3 = tlrn.LearnableRecFilter(spec3, tile_width=128, device=dev)
    xs3 = signal((8, samples))
    x3 = torch.from_numpy(xs3).to(dev)
    with torch.no_grad():
        y3, launches = counts(l3, x3)
    print(f"  L3 biquad 8 x {samples}: launches {launches}")
    check(launches == {k: (1 if k in ("tails_traced", "completion_traced")
                           else 0) for k in launches},
          "L3: tails_traced and completion_traced once each")
    ref = lfilter_reference(spec3, xs3)
    err = float(np.abs(y3.cpu().numpy().astype(np.float64) - ref).max()
                / np.abs(ref).max())
    print(f"  L3: max|y - lfilter|/max|lfilter| = {err:.3e}")
    check(err <= 2e-6, "L3: within 2e-6 of scipy.signal.lfilter's peak")
    l3p = perturbed(tlrn, spec3, dev)
    # the same parameters at 64-wide tiles: no kernel, autograd through the
    # float64 einsums, an independent check of the Functions' backward
    ref = tlrn.LearnableRecFilter(spec3, tile_width=64, device=dev)
    ref.load_state_dict(l3p.state_dict())
    grads_match("L3", l3p, x3, y3, ref=ref)
    del ref
    losses = train(l3p, x3, y3, 2e-2)
    print("  L3 losses, Adam(2e-2), 10 steps: "
          + " ".join(f"{v:.6e}" for v in losses))
    check(losses[-1] < losses[0], "L3: the loss falls over 10 Adam(2e-2) "
          "steps")
    return l1_launches, l2, y1, l3, x3


def solve_branches(tlrn, label, mod, v, step, card):
    """The learnable forward ``mod(v)`` and a training ``step(v)`` with
    the cross-tile solve forced to the dense solve from W powers and to
    the associative scan, interleaved dense, assoc, assoc, dense: CUDA-event
    medians of 20 calls each and a profile of the step; both solves give
    the same output within 1e-6 of its peak."""
    import torch

    from recfilter_tpu_torch.utils import timing

    dense_max = tlrn._DENSE_SOLVE_MAX
    force = {"dense": 1 << 30, "assoc": 0}
    times, outs, profs = {}, {}, {}
    try:
        for name in ("dense", "assoc", "assoc", "dense"):
            tlrn._DENSE_SOLVE_MAX = force[name]
            with torch.no_grad():
                fwd = timing.call_times_ms(mod, v, iterations=10, warmup=2)
            st = timing.call_times_ms(step, v, iterations=10, warmup=2)
            f0, s0 = times.setdefault(name, ([], []))
            f0.extend(fwd)
            s0.extend(st)
        for name in force:
            tlrn._DENSE_SOLVE_MAX = force[name]
            with torch.no_grad():
                outs[name] = mod(v)
            profs[name] = timing.device_profile(step, v, iterations=5)
    finally:
        tlrn._DENSE_SOLVE_MAX = dense_max
    check(rel_err(outs["assoc"], outs["dense"]) <= 1e-6,
          f"{label}: the dense and associative solves give the same output")
    n = v.shape[-1] // 128
    for name, (fwd, st) in times.items():
        pr = profs[name]
        print(f"  {label} {name} solve ({n} tiles): forward event median "
              f"{statistics.median(fwd):.4f} ms, step event median "
              f"{statistics.median(st):.4f} ms (20 calls each); step profile:"
              f" call {pr['call_ms']:.4f} ms, device busy {busy_text(pr)}, "
              f"{pr['device_ops']:.0f} device ops on {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "recfilter_tpu_torch")):
        print(f"chip_smoke: no recfilter_tpu_torch package beside {__file__}"
              " — run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as F_

    import recfilter_tpu_torch as rft
    from recfilter_tpu_torch import scan_core
    from recfilter_tpu_torch.apps import (audio_filter_high_order,
                                          gaussian_1xy_2x_2y, gaussian_3x_3y,
                                          gaussian_3xy, run_cascade)
    from recfilter_tpu_torch.kernels import _build
    from recfilter_tpu_torch.kernels import launch
    from recfilter_tpu_torch.kernels.stencil2d import Stencil2D
    from recfilter_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    def timed(label, fn, plain, lib, args, nbytes, ops, rate, launches):
        """Event and device times of a kernel beside its twin and library
        yardstick (None: no one PyTorch call computes it)."""
        t = paired_times(fn, plain, *args)
        d = (device_ms(fn, *args), device_ms(plain, *args),
             None if lib is None else device_ms(lib, *args))
        lib_ms = None if lib is None else median_ms(lib, *args)
        bound, by = roofline(nbytes, ops, rate)
        print(f"  {label}: {launches} launch(es) per call; event "
              f"{t[0]:.4f} ms, device {d[0]:.4f} ms; bound {bound:.4f} ms by "
              f"{by} ({100 * bound / d[0]:.1f} % of the device time); twin "
              f"event {t[1]:.4f}, device {d[1]:.4f} ms; library "
              + ("none" if lib is None else
                 f"event {lib_ms:.4f}, device {d[2]:.4f} ms") + f" on {card}")
        return t, d, (bound, by), lib_ms

    print("== phase 1: card, settings, kernel build", flush=True)
    print(f"card (name, power limit): {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "fp32 matmuls do not use TF32")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is 'highest'")
    torch.backends.cudnn.allow_tf32 = False  # conv1d yardstick in fp32
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (set: the "
          "fir_band yardstick conv1d runs in full fp32)")
    t0 = time.perf_counter()
    _build.build(list(launch.SIGNATURES))
    print(f"nvcc, {len(launch.SIGNATURES)} kernels in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name, sig in launch.SIGNATURES.items():
        _build.load(name, sig)
        log = _build.build_logs.get(name, "(library was already built)")
        print(f"built {name}:\n" + "\n".join(
            "    " + ln for ln in log.strip().splitlines()))

    print("== phase 2a: 2-D kernels against their plain twins on the card",
          flush=True)
    cases = {"4096x4096 zero": (H, W, False),
             "4096x4096 clamp": (H, W, True),
             "1080x1920 zero (padded)": (1080, 1920, False)}
    modules = {}
    max_abs = {name: 0.0 for name in launch.SIGNATURES}
    main_launches = {}

    def only(**kw):
        """Launch counts with every kernel not named at 0."""
        return {k: kw.get(k, 0) for k in launch.LAUNCHES}
    for label, (h, w, clamp) in cases.items():
        img = image(h, w)
        F = build_filter(rft, h, w, img, clamp)
        mod = F.as_func()
        modules[label] = (F, mod, img)
        with torch.no_grad():
            X4 = mod.tile(torch.from_numpy(img).to(dev))
            for got, want, what in zip(mod.moments(X4),
                                       mod.moments.plain(X4),
                                       ("bA_t", "term1")):
                torch.cuda.synchronize()
                err = rel_err(got, want)
                print(f"  {label} moments2d {what}: max|k-p|/max|p| = "
                      f"{err:.3e}")
                check(err <= 1e-5, f"{label} moments2d {what} within 1e-5")
                if label.startswith("4096x4096 zero"):
                    max_abs["moments2d"] = max(
                        max_abs["moments2d"],
                        (got - want).abs().max().item())
            NA_t, NB_t = mod.carries(X4, mod.moments.plain)
            got = mod.final(X4, NA_t, NB_t)
            want = mod.final.plain(X4, NA_t, NB_t)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"  {label} final2d Y: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} final2d within 1e-5")
            if label.startswith("4096x4096 zero"):
                max_abs["final2d"] = (got - want).abs().max().item()

    print("== phase 2b: build the 1-D cases; tails and completion against "
          "their twins on the card", flush=True)
    n10 = 10_000_000
    cases_1d = {}
    build_s = {}
    for label, make in (
            ("A", lambda: audio_filter_high_order(n10, 2, 1000)),
            ("B", lambda: audio_filter_high_order(n10, 29, 1000)),
            ("C", lambda: gauss_1d(rft, (1_000_001,), 1000, True)),
            ("D", lambda: gauss_1d(rft, (64, 30_000), 128, False)),
            ("E", lambda: gauss_1d(rft, (64, 32_768), 128, True))):
        F = make()
        t0 = time.perf_counter()
        mod = F.as_func()
        build_s[label] = time.perf_counter() - t0
        cases_1d[label] = (F, mod)
        print(f"  {label}: {F.spec.dims}, ΣK = "
              f"{sum(s.order for s in F.spec.scans)}, route "
              f"{type(mod.body).__name__}, host build {build_s[label]:.2f} s")

    def local_inputs(label):
        """The case's first tiled pass, and x as its kernels see it."""
        F, mod = cases_1d[label]
        body = mod.body
        loc = body.locals[0] if hasattr(body, "locals") else body
        x = torch.from_numpy(signal(F._image.shape)).to(dev)
        X = F_.pad(x, (0, body.pad)).reshape(-1, loc.n, loc.T).contiguous()
        return loc, X

    for label in ("A", "B", "E"):
        loc, X = local_inputs(label)
        with torch.no_grad():
            b = loc.tails(X)
            bp = loc.tails.plain(X)
            torch.cuda.synchronize()
            err = rel_err(b, bp)
            print(f"  {label} tails {tuple(X.shape)} -> {tuple(b.shape)}: "
                  f"max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} tails within 1e-5")
            check(not b[:, loc.S:].any(), f"{label} tails pad slots zero")
            Nt = loc._solve_t(bp.double()).float()
            y = loc.completion(X, Nt)
            yp = loc.completion.plain(X, Nt)
            torch.cuda.synchronize()
            err = rel_err(y, yp)
            print(f"  {label} completion: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} completion within 1e-5")
            if label == "A":
                max_abs["tails"] = (b - bp).abs().max().item()
                max_abs["completion"] = (y - yp).abs().max().item()

    print("== phase 2c: build the rows-path cases; rows_tails and rows_final "
          "against their twins on the card", flush=True)
    rows_cases = {}  # label: (filter, module on the card, input)
    for label, make in (
            ("V1", lambda: gauss_axes(rft, (256, 256, 256), (0, 1, 2))),
            ("V2", lambda: gauss_axes(rft, (512, 512, 512), (0, 1, 2),
                                      clamp=True)),
            ("S3", lambda: gauss_axes(rft, (8192, 4096), (0,))),
            ("S4", lambda: gauss_axes(rft, (256, 512, 1024), (0, 2)))):
        F = make()
        t0 = time.perf_counter()
        mod = F.as_func()
        rows = mod if isinstance(mod, rft.FusedRowsPx) else mod.stages[0]
        print(f"  {label}: {F.spec.dims}, border {F.spec.border}, route "
              f"{getattr(mod, 'route', type(mod).__name__)} "
              f"[{', '.join(type(m).__name__ for m in getattr(mod, 'stages', [mod]))}]"
              f", rows pass n = {rows.n} tiles x W = {rows.W} lanes, solve "
              f"{'banded' if rows.offsets else 'dense'}, host build "
              f"{time.perf_counter() - t0:.2f} s")
        rows_cases[label] = (F, mod, F._image)
    check(isinstance(rows_cases["S3"][1], rft.FusedRowsPx)
          and rows_cases["S3"][1].offsets is not None,
          "S3 runs the rows pass alone, on the banded carry solve")

    def rows_of(label):
        mod = rows_cases[label][1]
        return mod if isinstance(mod, rft.FusedRowsPx) else mod.stages[0]

    for label in ("V1", "V2", "S3"):
        rows = rows_of(label)
        with torch.no_grad():
            X4 = rows.tile(torch.from_numpy(rows_cases[label][2]).to(dev))
            b = rows.tails(X4)
            bp = rows.tails.plain(X4)
            torch.cuda.synchronize()
            err = rel_err(b, bp)
            print(f"  {label} rows_tails {tuple(X4.shape)} -> "
                  f"{tuple(b.shape)} ({rows.tails.G_v.shape[0]} variants): "
                  f"max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} rows_tails within 1e-5")
            check(not b[:, :, rows.K:].any(),
                  f"{label} rows_tails pad slots zero")
            N = rows.carries(X4, rows.tails.plain)
            y = rows.final(X4, N)
            yp = rows.final.plain(X4, N)
            torch.cuda.synchronize()
            err = rel_err(y, yp)
            print(f"  {label} rows_final: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} rows_final within 1e-5")
            if label == "V1":
                max_abs["rows_tails"] = (b - bp).abs().max().item()
                max_abs["rows_final"] = (y - yp).abs().max().item()
            del X4, b, bp, N, y, yp

    print("== phase 2d: build the FIR and integer cases; fir_band, int_scan "
          "and int_seg_scan against their twins on the card", flush=True)
    from recfilter_tpu_torch.apps import (box_filter_3, box_filter_order_1,
                                          box_oracle, difference_of_gaussians,
                                          summed_table)
    from recfilter_tpu_torch.fir import _align_taps, box_taps
    from recfilter_tpu_torch.kernels import fir_band, int_scan

    box3 = box_filter_3(W, H, 5)                             # F1
    dog = difference_of_gaussians(W, H, 5, 9)                # F3
    check(box3.x_pass.band is not None and box3.y_pass.band is not None,
          "F1 runs both passes on fir_band")
    check(dog.x_pass.band.Cout == 2 and dog.y_pass.band.contract,
          "F3: a C = 2 bank, then a signed contraction, on fir_band")
    xf_np = image(H, W, seed=2)
    xf = torch.from_numpy(xf_np).to(dev)
    dog_taps = [box_taps(5, 3), box_taps(9, 3)]
    rag = torch.from_numpy(image(2, 1080, 1000, seed=4)).to(dev)
    with torch.no_grad():
        mid1 = box3.x_pass.band.plain(xf)
        mid3 = dog.x_pass.band.plain(xf)
        band_cases = [
            ("F1 x pass (1->1, rotated)", box3.x_pass.band, xf),
            ("F1 y pass (1->1, rotated)", box3.y_pass.band, mid1),
            ("F3 x pass (1->2 bank, rotated)", dog.x_pass.band, xf),
            ("F3 y pass (2->1 contraction, rotated)", dog.y_pass.band, mid3),
            ("L=1000 1->1 flat", fir_band.FirBand(box_taps(5, 3)).to(dev),
             rag[0]),
            ("L=1000 1->2 bank flat", fir_band.FirBand(
                _align_taps(dog_taps)).to(dev), rag[0]),
            ("L=1000 2->1 contraction flat", fir_band.FirBand(
                _align_taps(dog_taps), contract=True,
                signs=[1.0, -1.0]).to(dev), rag)]
        for label, band, v in band_cases:
            got, want = band(v), band.plain(v)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"  {label} {tuple(v.shape)} -> {tuple(got.shape)}, K = "
                  f"{band.taps_k.shape[1]} (padded): max|k-p|/max|p| = "
                  f"{err:.3e}")
            check(err <= 1e-5, f"{label}: fir_band within 1e-5 of its twin")
            if label.startswith("F1 x"):
                max_abs["fir_band"] = (got - want).abs().max().item()
        del mid1, mid3, got, want

    img_i1 = ints((H, W), 0, 255, np.int32, seed=5)          # I1
    x_i1 = torch.from_numpy(img_i1).to(dev)
    int_cases = [("I1 x (lanes)", x_i1, [(1, 1, True)], 1),
                 ("I1 y (rows)", x_i1, [(1, 1, True)], 0)]
    i2_units = {1: [(2, -1, True), (1, -1, False), (3, 1, False)],
                0: [(1, 1, True)]}
    for dt in (np.int16, np.int8):
        info = np.iinfo(dt)
        v = torch.from_numpy(ints((2048, 2048), info.min, info.max, dt,
                                  seed=6)).to(dev)
        for ax in (1, 0):
            int_cases.append((f"I2 {np.dtype(dt).name} axis {ax}", v,
                              i2_units[ax], ax))
    with torch.no_grad():
        for label, v, units, ax in int_cases:
            got = int_scan.int_unit_dim_pass(v, units, ax)
            want = int_scan.unit_scans_plain(v, units, ax)
            torch.cuda.synchronize()
            d = max_int_diff(got, want)
            print(f"  {label} {tuple(v.shape)} {v.dtype}, {len(units)} "
                  f"scan(s): max|k-p| = {d}")
            check(d == 0 and got.dtype == v.dtype,
                  f"{label}: int_scan bit-equal to its twin")
            max_abs["int_scan"] = max(max_abs["int_scan"], float(d))
        del got, want
    x_i3 = torch.from_numpy(ints((8, 10_000_000), -2**31, 2**31 - 1,
                                 np.int32, seed=7)).to(dev)   # I3
    x_i4 = torch.from_numpy(ints((16384, 4096), 0, 255, np.int32,
                                 seed=8)).to(dev)             # I4
    with torch.no_grad():
        for label, v, layout in (("I3", x_i3, 0), ("I4", x_i4, 1)):
            xr = v if layout == 0 else v.reshape(1, *v.shape)
            for unit in ((1, 1, True), (-3, -1, False)):
                C = int_scan._chunk_len(xr.shape[1])
                c = int_scan.seg_carries(xr, unit, layout, C)
                cp = int_scan.seg_carries_plain(xr, unit, layout, C)
                inc = int_scan._carry_chain(c, unit[2])
                y = int_scan.seg_fix(xr, inc, unit, layout, C)
                yp = int_scan.seg_fix_plain(xr, inc, unit, layout, C)
                torch.cuda.synchronize()
                d = (max_int_diff(c, cp), max_int_diff(y, yp))
                print(f"  {label} {tuple(xr.shape)} unit {unit}, C = {C}, "
                      f"{c.shape[1]} chunks: max|k-p| carries {d[0]}, fix "
                      f"{d[1]}")
                check(d == (0, 0),
                      f"{label} {unit}: both int_seg_scan phases bit-equal "
                      "to their twins")
                max_abs["int_seg_scan"] = max(max_abs["int_seg_scan"],
                                              float(max(d)))
                del c, cp, inc, y, yp

    print("== phase 2e: the rotated emit and the stencil consumers against "
          "their twins on the card (C1's shapes; integer-valued inputs "
          "with bounded integrals, exact in fp32)", flush=True)
    from recfilter_tpu_torch import dimfuse as tdf
    from recfilter_tpu_torch.apps import box_filter_6
    from recfilter_tpu_torch.apps.dog import _stencil

    c1 = difference_of_gaussians(W, H, 5, 9, variant="sat")          # C1
    c1sat = c1.sat_box
    check(isinstance(c1sat, rft.Fused2DPx) and c1sat.h8 == 16,
          "C1's SAT fuses the 4-corner bank (h8 = 16)")
    x2 = torch.from_numpy(exact_ints((H, W), (0, 1), seed=9)).to(dev)
    for label in launch.LAUNCHES:
        max_abs.setdefault(label, 0.0)
    with torch.no_grad():
        X4 = c1sat.tile(x2)
        for got, want, what in zip(c1sat.moments(X4), c1sat.moments.plain(X4),
                                   ("bA_t", "term1", "ht", "hb")):
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"  C1 moments2d (h8 = 16 edge rows) {what}: "
                  f"max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"C1 moments2d {what} within 1e-5")
        NA, NB, ht, hb = c1sat._carries(X4, c1sat.moments.plain)
        top, bot = c1sat.halo_strips(ht, hb, NA, NB)
        st_args = (X4, NA.float(), NB.float(), top, bot)
        got, want = c1sat.final(*st_args), c1sat.final.plain(*st_args)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        print(f"  C1 final2d_stencil (2 channels, radii 5 and 9) "
              f"{tuple(got.shape)}: max|k-p|/max|p| = {err:.3e}")
        check(err <= 1e-5, "C1 final2d_stencil within 1e-5 of its twin")
        max_abs["final2d_stencil"] = (got - want).abs().max().item()
        del X4, NA, NB, ht, hb, top, bot, st_args, got, want
        x1 = torch.from_numpy(exact_ints((H, W), (1, 1), seed=10)).to(dev)
        for B in (5, 9):
            for start, end in (("zero", "clamp"), ("clamp", "zero"),
                               ("zero", "zero"), ("clamp", "clamp")):
                xd, yd = rft.Dim("x", W), rft.Dim("y", H)
                Fx = rft.RecFilter("SAT2x")
                Fx[yd, xd] = np.zeros((H, W), np.float32)
                Fx.add_filter(+xd, [1.0, 2.0, -1.0])
                Fx.split(xd, 128)
                Fx.set_plan(rotate_emit=2)
                loc = Fx.as_func(stencil=dict(_stencil(B), start=start,
                                              end=end)).body
                check(loc.st_comp is not None,
                      f"B = {B} {start}/{end}: the stencil fuses")
                X = x1.reshape(-1, loc.n, 128)
                tails, comp = loc.st_tails[0], loc.st_comp[0]
                b, bp = tails(X), tails.plain(X)
                Nt = loc._solve_t(bp[:, :loc.sl].double())
                halos = tdf._stencil_halo(bp[:, loc.sl:].double(), Nt,
                                          loc.st_R0, *loc.st_reach[0])
                y, yp = comp(X, Nt.float(), *halos), comp.plain(
                    X, Nt.float(), *halos)
                torch.cuda.synchronize()
                e_t, e_c = rel_err(b, bp), rel_err(y, yp)
                print(f"  B = {B} start {start}, end {end}: tails (+{tails.He}"
                      f" extra rows) {tuple(b.shape)} {e_t:.3e}; "
                      f"completion_rot + stencil {tuple(y.shape)} {e_c:.3e}")
                check(e_t <= 1e-5 and e_c <= 1e-5 and not b[:, 2:8].any(),
                      f"B = {B} {start}/{end}: tails and the rotated "
                      "stencil completion within 1e-5, pad slots zero")
                max_abs["completion_rot"] = max(
                    max_abs["completion_rot"], (y - yp).abs().max().item())
                max_abs["tails_extra"] = max(
                    max_abs["tails_extra"], (b - bp).abs().max().item())
            y, yp = loc.completion(X, Nt.float()), loc.completion.plain(
                X, Nt.float())
            torch.cuda.synchronize()
            err = rel_err(y, yp)
            print(f"  B = {B}: completion_rot without a stencil: max|k-p|/"
                  f"max|p| = {err:.3e}")
            check(err <= 1e-5, "completion_rot within 1e-5 of its twin")
            del X, b, bp, Nt, halos, y, yp
        bank = Stencil2D(SOBEL).to(dev)
        v = torch.from_numpy(image(H, W, seed=11)).to(dev)
        for got, want in zip(bank(v), bank.plain(v)):
            torch.cuda.synchronize()
            err = rel_err(got, want)
            check(err <= 1e-5, f"stencil2d (C = 2 Sobel, {H}x{W}) within "
                  f"1e-5 of its twin ({err:.3e})")
            max_abs["stencil2d"] = max(max_abs["stencil2d"],
                                       (got - want).abs().max().item())
        vi = torch.from_numpy(ints((H, W), -2**20, 2**20, np.int32,
                                   seed=12)).to(dev)
        for got, want in zip(bank(vi), bank.plain(vi)):
            check(got.dtype == torch.float32 and torch.equal(got, want),
                  "stencil2d on an int32 table: float32, equal to its twin")
        del x1, x2, v, vi

    print("== phase 2f: completion_rot_tails against its twin on the card "
          "(integer-valued input: every sum exact, so bit-equal)", flush=True)
    from recfilter_tpu_torch.kernels import completion as kcomp

    def int_stack(var, rows, cols, n, seed):
        """An integer-valued per-tile stack in [-2, 2]: uniform, or with
        first/last-tile (clamp) variants."""
        rng = np.random.default_rng(seed)
        M = [rng.integers(-2, 2, (rows, cols), endpoint=True).astype(float)
             for _ in range(3)]
        if var == "uniform" or n == 1:
            return M[1 if var == "clamp" else 0][None]
        return np.stack([M[1]] + [M[0]] * (n - 2) + [M[2]])

    # K3's first pass (volumes: 200 x 512 lines, the next pass's 4 tiles on
    # each of ra = 200 extents) and K6's (images: 512 lines, 320 tiles)
    for label, q, n, n2, var in (
            ("K3 x pass, volumes (ra = 200)", 102400, 4, 4, "uniform"),
            ("K3 x pass, clamp variants of Btot, Rcat and G2", 102400, 4, 4,
             "clamp"),
            ("K6 x pass, images (ra = 1), clamp variants", 512, 320, 4,
             "clamp")):
        comp = kcomp.CompletionPass(
            int_stack(var, 128, 128, n, 1), int_stack(var, 128, 6, n, 2), n,
            rot=True, next_tails=(int_stack(var, 5, 128, n2, 3), n2)).to(dev)
        with torch.no_grad():
            xk = torch.from_numpy(ints((q, n, 128), -8, 8, np.float32, 4)
                                  ).to(dev)
            Nk = torch.zeros((n, 8, q), device=dev)
            Nk[:, :6] = torch.from_numpy(ints((n, 6, q), -8, 8, np.float32,
                                              5)).to(dev)
            (y, t2), (yp, tp) = comp(xk, Nk), comp.plain(xk, Nk)
            torch.cuda.synchronize()
        d = max((y - yp).abs().max().item(), (t2 - tp).abs().max().item())
        print(f"  {label}: y {tuple(y.shape)}, tails {tuple(t2.shape)}, "
              f"G2 {comp.G2_v.shape[0]} variant(s): max|k-p| = {d}")
        check(d == 0 and not t2[:, 5:].any(),
              f"{label}: completion_rot_tails bit-equal to its twin, pad "
              "slots zero")
        max_abs["completion_rot_tails"] = max(
            max_abs.get("completion_rot_tails", 0.0), d)
        del xk, Nk, y, t2, yp, tp
    # whole chains of unit integrators (exact) on integer-valued input
    # whose integrals stay bounded: a first pass with pad (84 padded lines
    # cut from its extracted tails) and the per-slice route (P = 3)
    for label, shape, border in (("pad 84 (256 x 300)", (256, 300), "zero"),
                                 ("P = 3 slices, clamp (3 x 256 x 384)",
                                  (3, 256, 384), "clamp")):
        nd = len(shape)
        spec = rft.FilterSpec("Integrators", tuple(
            rft.Dim(nm, e) for nm, e in zip("cyx"[-nd:], shape)), (
            rft.Scan(nd - 1, True, 1.0, (1.0,)),
            rft.Scan(nd - 2, False, 1.0, (1.0,))), border=border,
            tile_widths=(0,) * (nd - 2) + (128, 128))
        groups = {nd - 1: [spec.scans[0]], nd - 2: [spec.scans[1]]}
        chains = [tdf.RotationChain(groups, shape, spec.tile_widths,
                                    border).to(dev) for _ in range(2)]
        for p in chains[1].passes:
            p.completion_nt = None  # unchained: every pass reads its tails
        xi = torch.from_numpy(exact_ints(shape, (nd - 1, nd - 2), 6)).to(dev)
        with torch.no_grad():
            (yc, lc), (yu, lu) = (counted(m, xi) for m in chains)
            yp = chains[0].forward_plain(xi)
        P = shape[0] if nd == 3 else 1
        print(f"  {label}: chained launches {lc}, tails_in "
              f"{chains[0].tails_in_taken}; unchained {lu}")
        check(lc == only(tails=P, completion_rot_tails=P, completion_rot=P)
              and lu == only(tails=2 * P, completion_rot=2 * P)
              and chains[0].tails_in_taken == [False, True],
              f"{label}: the second pass takes the extracted tails")
        check(torch.equal(yc, yu) and torch.equal(yc, yp),
              f"{label}: chained, unchained and the twins bit-equal")
        del xi, yc, yu, yp

    print("== phase 2g: tails_traced and completion_traced against their "
          "twins on the card at L1's x-axis shapes", flush=True)
    l1, x_l1, traced_in, errs = learnable_kernels(rft, dev, H)
    max_abs.update(errs)

    print("== phase 2h: the affine epilogue entries against their twins on "
          "the card (final2d_epi at 4096², completion_epi at A's kernel "
          "pass, completion_rot_epi at C1's x pass)", flush=True)
    epi_in = {}  # entry: (module, args) at its main-path shape, phase 5i
    F, mod, img = modules["4096x4096 zero"]
    with torch.no_grad():
        X4 = mod.tile(torch.from_numpy(img).to(dev))
        NA_t, NB_t = mod.carries(X4, mod.moments.plain)
        auxes = [X4, mod.tile(torch.from_numpy(image(H, W, seed=30)).to(dev))]
        for what, fn in (("k = 1, the unsharp combine 2a - o", usm_combine),
                         ("k = 2 with a bias, 0.5y + 2a - b + 0.25",
                          lambda y_, a_, b_: 0.5 * y_ + 2.0 * a_ - b_ + 0.25)):
            m = F.as_func(epilogue=fn)
            check(m.epilogue_route == "kernel",
                  f"final2d_epi {what}: the kernel route")
            args = (X4, NA_t, NB_t, *auxes[:m.final.k])
            got, want = m.final(*args), m.final.plain(*args)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"  final2d_epi {what}: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"final2d_epi {what} within 1e-5")
            if m.final.k == 1:
                max_abs["final2d_epi"] = (got - want).abs().max().item()
        del got, want, auxes, m
        # A's kernel pass: 306 supertiles as lines, 256 tiles of 128
        loc, X = local_inputs("A")
        Nt = loc._solve_t(loc.tails.plain(X).double()).float()
        le = tdf.LastAxisPass(cases_1d["A"][1].body.scans,
                              (loc.T, loc.n, 0), False, "px6",
                              epilogue=lambda y_, x_: 0.7 * y_ + 0.3 * x_
                              ).to(dev)
        comp = le.completion
        got, want = comp(X, Nt, X), comp.plain(X, Nt, X)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        print(f"  completion_epi (the mix 0.7y + 0.3x) at A's kernel pass "
              f"{tuple(X.shape)}: max|k-p|/max|p| = {err:.3e}")
        check(err <= 1e-5, "completion_epi within 1e-5")
        max_abs["completion_epi"] = (got - want).abs().max().item()
        epi_in["completion_epi"] = (comp, (X, Nt, X))
        # C1's x pass (radius 5): the rotated completion with and without
        # its 3-tap stencil, the DoG's subtraction after it — on
        # integer-valued input with bounded integrals (phase 2e: exact in
        # fp32, so only a fault separates kernel and twin)
        loc = c1.sat2x[0].body
        X = torch.from_numpy(exact_ints((H, W), (1, 1), seed=31)).to(
            dev).reshape(-1, loc.n, 128)
        bp = loc.st_tails[0].plain(X).double()
        Nt = loc._solve_t(bp[:, :loc.sl])
        halos = tdf._stencil_halo(bp[:, loc.sl:], Nt, loc.st_R0,
                                  *loc.st_reach[0])
        Nt = Nt.float().contiguous()
        aux = torch.from_numpy(exact_ints((H, W), (), seed=32)).to(dev)
        max_abs["completion_rot_epi"] = 0.0
        for stencil in (None, _stencil(5)):
            le = tdf.LastAxisPass([rft.Scan(1, True, 1.0, (2.0, -1.0))],
                                  (loc.T, loc.n, loc.pad), False, "px6",
                                  rot_axes=2, stencil=stencil,
                                  epilogue=lambda o, a: a - o).to(dev)
            comp = le.completion if stencil is None else le.st_comp[0]
            args = (X, Nt, *(() if stencil is None else halos), aux)
            got, want = comp(*args), comp.plain(*args)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            what = "no stencil" if stencil is None else "the 3-tap stencil"
            print(f"  completion_rot_epi (a - o) at C1's x pass, {what}: "
                  f"max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"completion_rot_epi ({what}) within 1e-5")
            max_abs["completion_rot_epi"] = max(
                max_abs["completion_rot_epi"],
                (got - want).abs().max().item())
        epi_in["completion_rot_epi"] = (comp, args)
        del got, want, bp, le

    print("== phase 2i: the HIGHEST pair (moments2d_k, final2d_k) and the "
          "strip kernels (dim_pass_rows, dim_pass_cols) against their twins "
          "on the card", flush=True)

    def pair_of(mod):
        """The HIGHEST pair module of an overlap_k filter's first stage,
        and whether it runs on the transposed image."""
        st = mod.stages[0]
        return (st.body, True) if hasattr(st, "a") else (st, False)

    with torch.no_grad():
        for label, (F, plan) in {
                "4096² Ta 128 K 6": (build_filter(rft, H, W, image(H, W)),
                                     "highest"),
                "4096² Ta 32 K 6": (build_filter(rft, H, W, image(H, W)),
                                    "highest"),
                "4096² Ta 128 K 12": (gauss_axes(rft, (H, W), (0, 1),
                                                 times=2), "px6")}.items():
            if "Ta 32" in label:  # x is the pair's leading axis (swapped)
                F.split({F.spec.dims[1]: 32})
            F.set_plan(backend="overlap_k", matmul_precision=plan)
            mod = F.as_func()
            fk, swapped = pair_of(mod)
            check(type(fk).__name__ == "Fused2DK",
                  f"{label}: the HIGHEST pair runs")
            x = torch.from_numpy(F._image).to(dev)
            X4 = fk.tile(x.t() if swapped else x)
            for got, want, what in zip(fk.moments(X4), fk.moments.plain(X4),
                                       ("bA", "U")):
                torch.cuda.synchronize()
                err = rel_err(got, want)
                print(f"  {label} moments2d_k {what} {tuple(got.shape)}: "
                      f"max|k-p|/max|p| = {err:.3e}")
                check(err <= 1e-5, f"{label} moments2d_k {what} within 1e-5")
                if label == "4096² Ta 128 K 6":
                    max_abs["moments2d_k"] = max(
                        max_abs.get("moments2d_k", 0.0),
                        (got - want).abs().max().item())
            NA_k, NB_k = fk.carries(X4, fk.moments.plain)
            got = fk.final(X4, NA_k, NB_k)
            want = fk.final.plain(X4, NA_k, NB_k)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"  {label} final2d_k Y: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} final2d_k within 1e-5")
            if label == "4096² Ta 128 K 6":
                max_abs["final2d_k"] = (got - want).abs().max().item()
        del X4, NA_k, NB_k, got, want
        for label, (h, w, clamp, lb) in {
                "4096² zero": (H, W, False, 0),
                "4096² clamp": (H, W, True, 0),
                "1080x1920 zero (y padded)": (1080, 1920, False, 0),
                "1920x1080 zero (x padded)": (1920, 1080, False, 0),
                "4096² line_block 64": (H, W, False, 64)}.items():
            F = build_filter(rft, h, w, image(h, w), clamp)
            F.set_plan(backend="pallas", line_block=lb)
            mod = F.as_func()
            check([st.route for st in mod.stages] == ["rows", "cols"],
                  f"{label}: x on dim_pass_rows, y on dim_pass_cols")
            v = torch.from_numpy(F._image).to(dev)
            for st, name in zip(mod.stages, ("dim_pass_rows",
                                             "dim_pass_cols")):
                X = st.kernel_input(v)
                got, want = st.body(X), st.body.plain(X)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                print(f"  {label} {name} {tuple(X.shape)}, tile {st.T}, "
                      f"w_real {st.body.w_real}: max|k-p|/max|p| = "
                      f"{err:.3e}")
                check(err <= 1e-5, f"{label} {name} within 1e-5")
                if label == "4096² zero":
                    max_abs[name] = (got - want).abs().max().item()
                v = st.forward_plain(v)
        del X, got, want, v

    print("== phase 2j: bsolve, moments2d_naf and copy against their twins "
          "at the 4096² headline's shapes", flush=True)
    from recfilter_tpu_torch import bench
    from recfilter_tpu_torch.kernels import copy as kcopy
    from recfilter_tpu_torch.kernels import final2d as k2d

    F_h, mod_h, img_h = modules["4096x4096 zero"]
    routes = {label: route_module(F_h, bk, naf)
              for label, (bk, naf) in ROUTES.items()}
    for label, m in routes.items():
        bk, naf = ROUTES[label]
        check((m.carry_route, m.moments_route) == (
            "bsolve" if bk else "glue", "naf" if naf else "raw"),
            f"{label}: carry_route {m.carry_route}, moments_route "
            f"{m.moments_route}")
    with torch.no_grad():
        x_h = torch.from_numpy(img_h).to(dev)
        X4 = mod_h.tile(x_h)
        # bsolve on the glue's solved dim-A carries and term1
        NA64 = mod_h._carries(X4, mod_h.moments.plain)[0]
        term1 = mod_h.moments.plain(X4)[1]
        bsm = routes["BK"].bsolve
        got, want = bsm(NA64.float(), term1), bsm.plain(NA64.float(), term1)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        print(f"  bsolve {tuple(got.shape)}: max|k-p|/max|p| = {err:.3e}")
        check(err <= 1e-5, "bsolve within 1e-5 of its twin's peak")
        check(not got.reshape(1, 32, 32, 8, 128)[:, :, :, mod_h.Kb:].any(),
              "bsolve: pad slots zero")
        max_abs["bsolve"] = (got - want).abs().max().item()
        nm = routes["NAF"].moments
        max_abs["moments2d_naf"] = 0.0
        for got, want, what in zip(nm(X4), nm.plain(X4), ("N_A", "term1")):
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"  moments2d_naf {what} {tuple(got.shape)}: "
                  f"max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"moments2d_naf {what} within 1e-5 of its "
                  "twin's peak")
            max_abs["moments2d_naf"] = max(max_abs["moments2d_naf"],
                                           (got - want).abs().max().item())
        got, want = kcopy.copy(x_h), kcopy.plain(x_h)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "copy (4096² float32) bit-equal to "
              "its twin")
        max_abs["copy"] = (got - want).abs().max().item()
        del X4, NA64, term1, got, want

    print("== phase 3a: the 2-D path end to end through RecFilter.as_func()",
          flush=True)

    for label, (F, mod, img) in modules.items():
        with torch.no_grad():
            y, launches = counted(mod, torch.from_numpy(img).to(dev))
        print(f"  {label}: launches {launches}")
        check(launches == only(moments2d=1, final2d=1),
              f"{label}: each 2-D kernel launched once by the call, no 1-D "
              "kernel")
        if label == "4096x4096 zero":
            main_launches.update(moments2d=launches["moments2d"],
                                 final2d=launches["final2d"])
        check(tuple(y.shape) == img.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {img.shape}")
        err = oracle_err(F.spec, img, y)
        print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e}")
        check(err <= 2e-6, f"{label}: within the px6 bound 2e-6 of the "
              "f64 oracle")

    print("== phase 3b: the 1-D path end to end through RecFilter.as_func()",
          flush=True)
    for order in (2, 29):
        spec = audio_filter_high_order(100_000, order, 1000).spec
        xs = signal((100_000,))
        ref = lfilter_reference(spec, xs)
        orc = scan_core.oracle_apply_scan(
            xs.astype(np.float64), 0, True, spec.scans[0].feedfwd,
            list(spec.scans[0].feedback))
        err = float(np.abs(ref - orc).max() / np.abs(orc).max())
        print(f"  lfilter stand-in vs oracle, order {order}, 100,000 "
              f"samples: {err:.3e}")
        check(err <= 1e-12, f"lfilter equals the oracle at order {order}")
    expect = {"A": 1, "B": 1, "C": 2, "D": 1, "E": 1}
    refs = {}  # label: (signal on the card, f64 reference) for phase 5
    for label, (F, mod) in cases_1d.items():
        xs = signal(F._image.shape)
        x = torch.from_numpy(xs).to(dev)
        with torch.no_grad():
            y, launches = counted(mod, x)
        print(f"  {label}: launches {launches}")
        k = expect[label]
        check(launches == only(tails=k, completion=k),
              f"{label}: tails and completion launched {k}x by the call, no "
              "2-D kernel")
        if label == "A":
            main_launches.update(tails=launches["tails"],
                                 completion=launches["completion"])
        check(tuple(y.shape) == xs.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {xs.shape}")
        if label in ("A", "B"):
            want, what = lfilter_reference(F.spec, xs), "lfilter f64"
        else:
            want, what = rft.oracle_apply(F.spec, xs.astype(np.float64)), \
                "f64 oracle"
        bound = 5e-6 if label == "C" else 2e-6
        err = float(np.abs(y.cpu().numpy().astype(np.float64) - want).max()
                    / np.abs(want).max())
        print(f"  {label}: max|y - ref|/max|ref| = {err:.3e} ({what})")
        check(err <= bound, f"{label}: within {bound:g} of the {what}")
        refs[label] = (x, want)

    print("== phase 3c: the rows path end to end through RecFilter.as_func()"
          " and the cascades' realize", flush=True)
    expect_rows = {
        "V1": only(rows_tails=1, rows_final=1, moments2d=1, final2d=1),
        "V2": only(rows_tails=1, rows_final=1, moments2d=1, final2d=1),
        "S3": only(rows_tails=1, rows_final=1),
        "S4": only(rows_tails=1, rows_final=1, tails=1, completion=1)}
    for label, (F, mod, xs) in rows_cases.items():
        with torch.no_grad():
            y, launches = counted(mod, torch.from_numpy(xs).to(dev))
        print(f"  {label}: launches {launches}")
        check(launches == expect_rows[label],
              f"{label}: launches {expect_rows[label]}")
        if label == "V1":
            main_launches.update(rows_tails=launches["rows_tails"],
                                 rows_final=launches["rows_final"])
        check(tuple(y.shape) == xs.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {xs.shape}")
        err = oracle_err(F.spec, xs, y)
        print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e}")
        check(err <= 2e-6, f"{label}: within the px6 bound 2e-6 of the f64 "
              "oracle")
        del y
    img = image(H, W)
    # S1, stage by stage through realize: x on the 1-D kernels, y on rows
    fc = gaussian_3x_3y(W, H)
    out = img
    for f, want in zip(fc, (only(tails=1, completion=1),
                            only(rows_tails=1, rows_final=1))):
        with torch.no_grad():
            out, launches = counted(
                lambda v, f=f: f.realize(v, device=dev), out)
        print(f"  S1 stage {f.name} ({[str(s) for s in f.spec.scans]}): "
              f"launches {launches}")
        check(launches == want, f"S1 stage {f.name}: launches {want}")
    err = oracle_err(gaussian_3xy(W, H).spec, img, out)
    print(f"  S1: max|y - oracle of gaussian_3xy|/max = {err:.3e}")
    check(err <= 2e-6, "S1: within 2e-6 of the whole filter's oracle")
    # S2, the whole chain through run_cascade: all six kernels once
    fc = gaussian_1xy_2x_2y(W, H)
    with torch.no_grad():
        out, launches = counted(
            lambda v: run_cascade(fc, v, device=dev), img)
    print(f"  S2: launches {launches}")
    check(launches == only(moments2d=1, final2d=1, tails=1, completion=1,
                           rows_tails=1, rows_final=1),
          "S2: each of the six float kernels launched once by the cascade")
    whole = rft.FilterSpec("G", fc[0].spec.dims,
                           sum((f.spec.scans for f in fc), ()),
                           border="clamp", tile_widths=(128, 128))
    err = oracle_err(whole, img, out)
    print(f"  S2: max|y - oracle of the whole filter|/max = {err:.3e}")
    check(err <= 2e-6, "S2: within 2e-6 of the whole filter's oracle")
    del out

    print("== phase 3d: box, DoG and the integer tables end to end through "
          "the app builders and RecFilter.realize", flush=True)
    with torch.no_grad():
        y, launches = counted(box3, xf)
    print(f"  F1: launches {launches}")
    check(launches == only(fir_band=2), "F1: fir_band launched twice")
    main_launches["fir_band"] = launches["fir_band"]
    check(tuple(y.shape) == (H, W) and bool(torch.isfinite(y).all()),
          f"F1: output finite, shape {(H, W)}")
    want = sep_oracle(xf_np, box_taps(5, 3))
    err = float(np.abs(y.cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  F1: max|y - FIR oracle|/max|oracle| = {err:.3e}")
    check(err <= 2e-6, "F1: within 2e-6 of the f64 FIR oracle")
    with torch.no_grad():
        y, launches = counted(dog, xf)
    print(f"  F3: launches {launches}")
    check(launches == only(fir_band=2), "F3: fir_band launched twice")
    want = sep_oracle(xf_np, dog_taps[0]) - sep_oracle(xf_np, dog_taps[1])
    err = float(np.abs(y.cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  F3: max|y - oracle|/max|oracle of the difference| = {err:.3e}")
    check(err <= 5e-6, "F3: within 5e-6 of the peak of the difference")
    del y, want
    # F2, both variants at 1920 × 1080
    img2 = np.random.default_rng(3).standard_normal((1080, 1920)).astype(
        np.float32)
    want = box_oracle(img2, 5, 1)
    for variant, expect in (("fir", only(fir_band=2)),
                            ("sat", only(moments2d=1, final2d=1))):
        mod, sat = box_filter_order_1(1920, 1080, 5, variant=variant)
        check((sat is None) == (variant == "fir"),
              f"F2 {variant}: builds a SAT filter only for the SAT variant")
        with torch.no_grad():
            y, launches = counted(mod, torch.from_numpy(img2).to(dev))
        print(f"  F2 {variant}: launches {launches}")
        check(launches == expect, f"F2 {variant}: launches {expect}")
        got = y.cpu().numpy()
        if variant == "fir":
            err = float(np.abs(got - want).max() / np.abs(want).max())
            print(f"  F2 fir: max|y - box oracle|/max|oracle| = {err:.3e}")
            check(err <= 2e-6, "F2 fir: within 2e-6 of the box oracle")
        else:
            v = (slice(6, -6), slice(6, -6))
            dev_ = np.abs(got[v] - want[v])
            print(f"  F2 sat: interior max|y - box oracle| = "
                  f"{dev_.max():.3e}; max of |d| / (1e-4 + 1e-3·|oracle|) = "
                  f"{(dev_ / (1e-4 + 1e-3 * np.abs(want[v]))).max():.3e}")
            check(np.allclose(got[v], want[v], rtol=1e-3, atol=1e-4),
                  "F2 sat: interior within rtol = 1e-3, atol = 1e-4 of the "
                  "box oracle")
    del y, want
    # I1: the int32 SAT of an 8-bit image through summed_table's realize
    F = summed_table(W, H, dtype="int32")
    y, launches = counted(lambda v: F.realize(v), img_i1)
    print(f"  I1: launches {launches}")
    check(launches == only(int_scan=2), "I1: int_scan launched once per axis")
    main_launches["int_scan"] = launches["int_scan"]
    want = img_i1.cumsum(1, dtype=np.int32).cumsum(0, dtype=np.int32)
    check(y.dtype == torch.int32 and np.array_equal(y.cpu().numpy(), want),
          "I1: bit-exact against numpy's wrapping int32 cumsum(1).cumsum(0) "
          f"(peak before wrap {int(img_i1.sum(dtype=np.int64))})")
    int_mods = {"I1": F.as_func()}
    # I2: int16 and int8 with the a = -1 anticausal chain on x
    for dt in (np.int16, np.int8):
        info = np.iinfo(dt)
        img = ints((2048, 2048), info.min, info.max, dt, seed=6)
        F = int_filter(rft, img, [(1, True, [2, -1]), (1, False, [1, -1]),
                                  (1, False, [3, 1]), (0, True, [1, 1])])
        y, launches = counted(lambda v: F.realize(v), img)
        name = np.dtype(dt).name
        print(f"  I2 {name}: launches {launches}")
        check(launches == only(int_scan=2),
              f"I2 {name}: int_scan launched once per axis")
        check(y.dtype == getattr(torch, name) and np.array_equal(
            y.cpu().numpy(), scan_core.oracle_apply(F.spec, img)),
            f"I2 {name}: bit-exact against the integer oracle")
    # I3, I4: the segmented routes
    img_i3 = x_i3.cpu().numpy()
    F = int_filter(rft, img_i3, [(1, True, [1, 1])])
    y, launches = counted(lambda v: F.realize(v), img_i3)
    print(f"  I3: launches {launches}")
    check(launches == only(int_seg_carries=1, int_seg_fix=1),
          "I3: each segmented phase launched once")
    main_launches["int_seg_scan"] = (launches["int_seg_carries"]
                                     + launches["int_seg_fix"])
    check(np.array_equal(y.cpu().numpy(),
                         img_i3.cumsum(1, dtype=np.int32)),
          "I3: bit-exact against numpy's wrapping int32 cumsum")
    int_mods["I3"] = F.as_func()
    img_i4 = x_i4.cpu().numpy()
    F = int_filter(rft, img_i4, [(0, True, [1, 1])])
    y, launches = counted(lambda v: F.realize(v), img_i4)
    print(f"  I4: launches {launches}")
    check(launches == only(int_seg_carries=1, int_seg_fix=1),
          "I4: each segmented phase launched once (other-axis layout)")
    check(np.array_equal(y.cpu().numpy(),
                         img_i4.cumsum(0, dtype=np.int32)),
          "I4: bit-exact against numpy's wrapping int32 cumsum along y")
    del y, img_i3, img_i4

    print("== phase 3e: the SAT apps, the 2-D bank, the epilogue and the "
          "per-slice rotated pass end to end through the public API",
          flush=True)
    # C1: held at every pixel to the f64 six-stage oracle on an input
    # whose integrals stay bounded (bounded_image); an image-like input
    # after it shows the fp32 formulation's own loss, printed, not held
    img = bounded_image(H, 21, seed=10)
    x_c1 = torch.from_numpy(img).to(dev)
    with torch.no_grad():
        y, launches = counted(c1, x_c1)
    print(f"  C1 DoG SAT: launches {launches}")
    check(launches == only(moments2d=1, final2d_stencil=1, tails_extra=4,
                           completion_rot=3, completion_rot_epi=1),
          "C1: moments2d and final2d_stencil once, tails_extra four times "
          "(two radii x two stages), completion_rot three times and "
          "completion_rot_epi once (the subtraction, in the last pass)")
    main_launches.update(final2d_stencil=launches["final2d_stencil"],
                         tails_extra=launches["tails_extra"],
                         completion_rot=launches["completion_rot"])
    check(tuple(y.shape) == (H, W) and bool(torch.isfinite(y).all()),
          f"C1: output finite, shape {(H, W)}")
    sat_check("C1", y.cpu().numpy(), dog_oracle(img, 5, 9), 21)
    img = zero_margin(np.random.default_rng(10).random((H, W)).astype(
        np.float32), 21)
    with torch.no_grad():
        got = c1(torch.from_numpy(img).to(dev)).cpu().numpy()
    want = dog_oracle(img, 5, 9)
    ie, ip = interior_err(got, want, 21)
    print(f"  C1 on uniform [0, 1) input (not checked: the fp32 "
          f"formulation's loss, PERF.md): the JAX test's metric "
          f"max|y - oracle|/max|oracle| = "
          f"{np.abs(got - want).max() / np.abs(want).max():.4e} (peak "
          f"{np.abs(want).max():.4g}); short of the far margin max|y - "
          f"oracle| = {ie:.4g} against a peak of {ip:.4g}")
    # C2: box ×3 SAT (the order-1 box takes its FIR form at B = 5)
    box3s = box_filter_3(W, H, 5, variant="sat")
    img = bounded_image(H, 19, seed=13)
    x_c2 = torch.from_numpy(img).to(dev)
    with torch.no_grad():
        y, launches = counted(box3s, x_c2)
        y_fir = box3(x_c2)
    print(f"  C2 box_filter_3 SAT: launches {launches}")
    check(launches == only(fir_band=2, tails=2, completion_rot=2),
          "C2: fir_band twice (the order-1 box), tails and completion_rot "
          "twice (the order-2 integrals)")
    got = y.cpu().numpy()
    sat_check("C2", got, box2_oracle(sep_oracle(img, box_taps(5, 1)), 5), 19)
    ie, ip = interior_err(got, y_fir.cpu().numpy(), 19)
    print(f"  C2 against the FIR variant short of the far margin: max|d| = "
          f"{ie:.4g}, its peak {ip:.4g} ({ie / ip:.4e})")
    check(ie <= 2e-4 * ip, "C2: equal to the FIR form (box³ with zero "
          "padding) short of the far margin within 2e-4 of its peak")
    s_small = zero_margin(image(128, 128, seed=14) * 100, 13)
    with torch.no_grad():
        a = box_filter_3(128, 128, 3, variant="sat")(
            torch.from_numpy(s_small).to(dev)).cpu().numpy()
        b = box_filter_3(128, 128, 3, variant="fir")(
            torch.from_numpy(s_small).to(dev)).cpu().numpy()
    v = slice(0, 128 - 13)
    check(np.allclose(a[v, v], b[v, v], rtol=1e-3, atol=1e-4),
          "C2 at 128² (zero-mean): SAT equals FIR on the zeroed-margin "
          "region within rtol = 1e-3, atol = 1e-4 (tests/test_fir.py:112)")
    # C3: box ×6 SAT at 2048²: three chained order-2 boxes
    box6s = box_filter_6(2048, 2048, 5, variant="sat")
    img = bounded_image(2048, 37, seed=15)
    x_c3 = torch.from_numpy(img).to(dev)
    with torch.no_grad():
        y, launches = counted(box6s, x_c3)
    print(f"  C3 box_filter_6 SAT 2048²: launches {launches}")
    check(launches == only(tails=6, completion_rot=6),
          "C3: six rotated passes")
    sat_check("C3", y.cpu().numpy(),
              box2_oracle(box2_oracle(box2_oracle(img, 5), 5), 5), 37)
    # C4: a y-only σ=5 Gaussian, then the Sobel bank (edge detection)
    F4 = gauss_axes(rft, (H, W), (0,), name="BlurY")
    c4 = F4.as_func(stencil2d=SOBEL)
    x_c4 = torch.from_numpy(F4._image).to(dev)
    with torch.no_grad():
        y, launches = counted(c4, x_c4)
    print(f"  C4 y-only Gaussian + Sobel: launches {launches}")
    check(launches == only(rows_tails=1, rows_final=1, stencil2d=1),
          "C4: the rows kernels, then stencil2d once")
    main_launches["stencil2d"] = launches["stencil2d"]
    blur = scan_core.oracle_apply(F4.spec, F4._image.astype(np.float64))
    for c, (g, w) in enumerate(zip(y, stencil_np(blur, SOBEL))):
        err = float(np.abs(g.cpu().numpy() - w).max() / np.abs(w).max())
        print(f"  C4 channel {c}: max|y - oracle|/max = {err:.3e}")
        check(err <= 2e-5, f"C4 channel {c}: within 2e-5 of the f64 oracle "
              "(tests/test_overlap2d.py:523)")
    # C5: the headline Gaussian with the unsharp-mask combine as epilogue
    img = image(H, W, seed=16)
    F5 = build_filter(rft, H, W, img)
    c5 = F5.as_func(epilogue=lambda o, a: 2.0 * a - o)
    x_c5 = torch.from_numpy(img).to(dev)
    with torch.no_grad():
        y, launches = counted(c5, x_c5, x_c5)
    print(f"  C5 Gaussian + unsharp epilogue: launches {launches}")
    check(launches == only(moments2d=1, final2d_epi=1)
          and c5.epilogue_route == "kernel", "C5: moments2d and "
          "final2d_epi once, the affine combine in final2d's store loop")
    want = 2.0 * img.astype(np.float64) - scan_core.oracle_apply(
        F5.spec, img.astype(np.float64))
    err = float(np.abs(y.cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  C5: max|y - (2x - oracle)|/max = {err:.3e}")
    check(err <= 2e-6, "C5: within the px6 bound 2e-6")
    # C6: the per-slice branch, the DoG's dual-radius taps per channel
    cd, yd, xd = rft.Dim("c", 2), rft.Dim("y", 1024), rft.Dim("x", 2048)
    F6 = rft.RecFilter("SAT2x_slices")
    F6[cd, yd, xd] = np.zeros((2, 1024, 2048), np.float32)
    F6.add_filter(+xd, [1.0, 2.0, -1.0])
    F6.split(xd, 128)
    F6.set_plan(rotate_emit=2)
    st6 = {"taps": [_stencil(5)["taps"], _stencil(9)["taps"]],
           "start": "zero", "end": "clamp"}
    c6 = F6.as_func(stencil=st6)
    img6 = image(2, 1024, 2048, seed=17)
    with torch.no_grad():
        y, launches = counted(c6, torch.from_numpy(img6).to(dev))
    print(f"  C6 per-slice rotated stencil (2, 1024, 2048): launches "
          f"{launches}")
    check(launches == only(tails_extra=2, completion_rot=2),
          "C6: one tails_extra and one completion_rot launch per slice")
    z = np.swapaxes(img6.astype(np.float64).cumsum(2).cumsum(2), 1, 2)
    want = np.stack([ddiff_np(z[p], B, 0) for p, B in ((0, 5), (1, 9))])
    err = float(np.abs(y.cpu().numpy() - want).max() / np.abs(z).max())
    print(f"  C6: max|y - oracle|/max|producer| = {err:.3e}")
    check(err <= 2e-5, "C6: within 2e-5 of the producer's peak "
          "(tests/test_dimfuse.py:988)")
    del y, z, want, img6

    print("== phase 3f: the rotation chain end to end through "
          "RecFilter.as_func() and the B-spline apps", flush=True)
    from recfilter_tpu_torch.apps import bicubic, biquintic_overlapped

    k_cases = {}  # label: (module, input on the card) for phase 5g

    def k_case(label, F, shape, expect, taken, oracle=True):
        """Run one K case through as_func(): its launches, route and tails
        reads, and (``oracle``) its error against the f64 oracle; kept for
        phase 5g's whole-call times."""
        mod = F.as_func()
        x_np = image(*shape)
        xk = torch.from_numpy(x_np).to(dev)
        with torch.no_grad():
            yk, launches = counted(mod, xk)
        print(f"  {label} {shape}: launches {launches}; route "
              f"{type(mod).__name__}, tiles "
              f"{[(p.T, p.n, p.pad) for p in getattr(mod, 'passes', [])]}, "
              f"tails_in {getattr(mod, 'tails_in_taken', None)}")
        check(isinstance(mod, tdf.RotationChain)
              and mod.tails_in_taken == taken,
              f"{label}: the rotation chain, tails_in per pass {taken}")
        check(launches == only(**expect), f"{label}: launches {expect}")
        check(tuple(yk.shape) == shape and bool(torch.isfinite(yk).all()),
              f"{label}: output finite, shape {shape}")
        k_cases[label] = (mod, xk)
        if oracle:
            t0 = time.perf_counter()
            err = oracle_err(F.spec, x_np, yk)
            print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e} (f64 "
                  f"oracle {time.perf_counter() - t0:.1f} s)")
            check(err <= 2e-6, f"{label}: within the px6 bound 2e-6 of the "
                  "f64 oracle")
        return mod, xk, yk, launches

    k_case("K1 Gaussian twice per axis (ΣK = 12)",
           gauss_axes(rft, (H, W), (0, 1), times=2), (H, W),
           dict(tails=2, completion_rot=2), [False, False])
    for name, make in (("bicubic", bicubic),
                       ("biquintic_overlapped", biquintic_overlapped)):
        F = make(1920, 1080)
        k_case(f"K2 {name}(1920, 1080)", F, (1080, 1920),
               dict(tails=1, completion_rot=1), [False, False])
    mod3, x3, y3, l3 = k_case("K3 CT volume",
                              gauss_axes(rft, (200, 512, 512), (0, 1, 2)),
                              (200, 512, 512),
                              dict(tails=2, completion_rot_tails=1,
                                   completion_rot=2), [False, True, False])
    main_launches["completion_rot_tails"] = l3["completion_rot_tails"]
    un3 = gauss_axes(rft, (200, 512, 512), (0, 1, 2)).as_func()
    for p in un3.passes:
        p.completion_nt = None
    with torch.no_grad():
        yu, launches = counted(un3, x3)
    print(f"  K3 unchained: launches {launches}")
    check(launches == only(tails=3, completion_rot=3),
          "K3 unchained: three tails reads, three completion_rot")
    check(torch.equal(yu, y3), "K3: chained bit-equal to unchained")
    del yu, y3, un3
    # K4: the f64 oracle of the full size runs for about half a minute on
    # the host, so the error is checked at depth 8; the full size runs
    # (launches, route) and is timed
    for shape, full in (((16, 128, 256, 256), True),
                        ((8, 128, 256, 256), False)):
        k_case(f"K4 4-D time series of volumes {shape[0]}-deep",
               gauss_axes(rft, shape, (0, 1, 2, 3)), shape,
               dict(tails=1, completion_rot_tails=2, completion_rot=1),
               [False, True, True, False], oracle=not full)
    del k_cases["K4 4-D time series of volumes 8-deep"]
    F5 = build_filter(rft, H, W, image(H, W))
    F5.set_plan(matmul_precision="highest")
    k_case("K5 headline 4096² at highest", F5, (H, W), {},
           [False, False])
    k_case("K6 panorama", gauss_axes(rft, (512, 40960), (0, 1)),
           (512, 40960), dict(completion_rot_tails=1, completion_rot=1),
           [False, True])

    print("== phase 3g: the learnable path end to end through "
          "LearnableRecFilter: L1 forward, L2 training steps, L3 biquad",
          flush=True)
    l1_launches, l2, y_l1, l3, x_l3 = learnable_cases(rft, dev, l1, x_l1,
                                                      65536, counted)
    main_launches.update(tails_traced=l1_launches["tails_traced"],
                         completion_traced=l1_launches["completion_traced"])

    print("== phase 3h: the unsharp mask, the Tuple routes, compute_at and "
          "the epilogue on the 1-D kernels end to end through the public "
          "API", flush=True)
    from recfilter_tpu_torch.apps import unsharp_mask

    def peak_err(got, want):
        """max|got − want| / max|want| against a numpy reference."""
        return float(np.abs(got.cpu().numpy() - want).max()
                     / np.abs(want).max())

    img_u = image(H, W)
    x_u = torch.from_numpy(img_u).to(dev)
    want_u = 2.0 * img_u - scan_core.oracle_apply(
        gaussian_3xy(W, H).spec, img_u.astype(np.float64))
    u1 = unsharp_mask(W, H)
    with torch.no_grad():
        y_u1, launches = counted(u1, x_u)
    print(f"  U1 unsharp_mask({W}, {H}): route {u1.usm_route}, epilogue "
          f"{u1.stages[0].epilogue_route}; launches {launches}")
    check(u1.usm_route == "merged"
          and u1.stages[0].epilogue_route == "kernel",
          "U1: the merged route, the combine in final2d's store loop")
    check(launches == only(moments2d=1, final2d_epi=1),
          "U1: moments2d and final2d_epi once, nothing else")
    main_launches["final2d_epi"] = launches["final2d_epi"]
    check(tuple(y_u1.shape) == (H, W) and bool(torch.isfinite(y_u1).all()),
          f"U1: output finite, shape {(H, W)}")
    err = peak_err(y_u1, want_u)
    print(f"  U1: max|y - ((1+w)I - w oracle(blur))|/max = {err:.3e}")
    check(err <= 2e-6, "U1: within the px6 bound 2e-6 of the f64 oracle")
    u2 = unsharp_mask(W, H, fused=False)
    with torch.no_grad():
        y_u2, launches = counted(u2, x_u)
    err = peak_err(y_u2, want_u)
    d12 = float((y_u1 - y_u2).abs().max()) / float(np.abs(want_u).max())
    print(f"  U2 naive: launches {launches}; max|y - oracle|/max = "
          f"{err:.3e}; max|U1 - U2|/max = {d12:.3e}")
    check(u2.usm_route == "naive" and err <= 2e-6,
          "U2: the naive route within 2e-6 of the oracle")
    check(d12 <= 1e-6, "U1 equals U2 within 1e-6 of the peak")
    del y_u1, y_u2
    u3 = unsharp_mask(1024, 1024, matmul_precision="highest")
    img3 = image(1024, 1024, seed=33)
    with torch.no_grad():
        y3u, launches = counted(u3, torch.from_numpy(img3).to(dev))
    want3 = 2.0 * img3 - scan_core.oracle_apply(
        gaussian_3xy(1024, 1024).spec, img3.astype(np.float64))
    err = peak_err(y3u, want3)
    print(f"  U3 staged at highest 1024²: route {u3.usm_route}, launches "
          f"{launches}; max|y - oracle|/max = {err:.3e}")
    check(u3.usm_route == "staged" and launches == only(),
          "U3: the staged route, no kernel launch (einsum passes)")
    check(err <= 2e-6, "U3: within 2e-6 of the f64 oracle")
    # the Tuple routes on the headline Gaussian (zero border)
    ta, tb = image(H, W, seed=41), image(H, W, seed=42)
    FT = build_filter(rft, H, W, (ta, tb))
    one = build_filter(rft, H, W, ta).spec
    oa, ob = (scan_core.oracle_apply(one, c.astype(np.float64))
              for c in (ta, tb))
    xt = (torch.from_numpy(ta).to(dev), torch.from_numpy(tb).to(dev))
    for label, fn, route, expect, want, scale in (
            ("T1 2u - 3v", lambda u, v: 2.0 * u - 3.0 * v, "linear-folded",
             only(moments2d=1, final2d=1), 2.0 * oa - 3.0 * ob, 1.0),
            ("T2 u v", lambda u, v: u * v, "staged",
             only(moments2d=1, final2d=1), oa * ob, 1.0),
            ("T3 clamp(2u - 3v, -50, 50), components x 1e5",
             lambda u, v: torch.clamp(2.0 * u - 3.0 * v, -50, 50), "staged",
             only(moments2d=1, final2d=1),
             np.clip(1e5 * (2.0 * oa - 3.0 * ob), -50, 50), 1e5)):
        mod_t = FT.as_func(epilogue=fn)
        with torch.no_grad():
            y, launches = counted(mod_t, tuple(scale * c for c in xt))
        peak = (np.abs(want).max() if scale == 1.0
                else scale * np.abs(2.0 * oa - 3.0 * ob).max())
        err = float(np.abs(y.cpu().numpy() - want).max()) / peak
        print(f"  {label}: route {mod_t.tuple_route}, launches {launches}; "
              f"max|y - oracle|/peak = {err:.3e}"
              + (f" (the clip binds at {100 * np.mean(np.abs(want) == 50):.0f}"
                 " % of the pixels)" if scale != 1.0 else ""))
        check(mod_t.tuple_route == route, f"{label}: the {route} route")
        check(launches == expect, f"{label}: launches {expect}")
        check(err <= 5e-6, f"{label}: within 5e-6 of the component-wise "
              "oracle's peak (tests/test_api.py:606-670)")
    del xt, y, oa, ob
    # compute_at of the unsharp combine on the headline filter
    Fca = build_filter(rft, H, W, img_u)
    ca = Fca.compute_at(usm_combine)
    with torch.no_grad():
        y, launches = counted(ca, x_u, x_u)
        comp_ = usm_combine(Fca.as_func()(x_u), x_u)
    d = rel_err(y, comp_)
    print(f"  CA compute_at(combine): route {ca.fused_route}, launches "
          f"{launches}; max|y - composition|/max = {d:.3e}")
    check(ca.fused_route == "epilogue"
          and launches == only(moments2d=1, final2d_epi=1),
          "CA: the epilogue route, moments2d and final2d_epi once")
    check(d <= 1e-6, "CA: equal to the composition within 1e-6")
    del y, comp_
    # E1: the dry/wet mix on multichannel audio, one tiled pass
    ce, xe = rft.Dim("c", 64), rft.Dim("x", 32768)
    FE = rft.RecFilter("MixAudio")
    FE[ce, xe] = np.zeros((64, 32768), np.float32)
    FE.add_filter(+xe, [1.0, 0.01, 0.01])  # A's order-2 coefficients
    FE.split(xe, 128)
    e1 = FE.as_func(epilogue=lambda y_, x_: 0.7 * y_ + 0.3 * x_)
    sig = signal((64, 32768), seed=34)
    x_e1 = torch.from_numpy(sig).to(dev)
    with torch.no_grad():
        y, launches = counted(e1, x_e1, x_e1)
    want = 0.7 * lfilter_reference(FE.spec, sig) + 0.3 * sig
    err = peak_err(y, want)
    print(f"  E1 64 x 32,768 audio + mix: launches {launches}, epilogue "
          f"{e1.body.epilogue_route}; max|y - lfilter mix|/max = {err:.3e}")
    check(launches == only(tails=1, completion_epi=1)
          and e1.body.epilogue_route == "kernel",
          "E1: tails and completion_epi once, the mix in the kernel")
    main_launches["completion_epi"] = launches["completion_epi"]
    check(err <= 2e-6, "E1: within 2e-6 of lfilter's mix")
    # E2: K1 with the unsharp combine on the chain's last pass
    K1e = gauss_axes(rft, (H, W), (0, 1), times=2)
    e2 = K1e.as_func(epilogue=usm_combine)
    x_e2 = torch.from_numpy(K1e._image).to(dev)
    with torch.no_grad():
        y, launches = counted(e2, x_e2, x_e2)
    want = 2.0 * K1e._image - scan_core.oracle_apply(
        K1e.spec, K1e._image.astype(np.float64))
    err = peak_err(y, want)
    print(f"  E2 K1 + unsharp combine: launches {launches}, last pass "
          f"{e2.passes[-1].epilogue_route}; max|y - oracle|/max = "
          f"{err:.3e}")
    check(launches == only(tails=2, completion_rot=1, completion_rot_epi=1)
          and e2.passes[-1].epilogue_route == "kernel",
          "E2: two tails, one completion_rot, one completion_rot_epi")
    main_launches["completion_rot_epi"] = launches["completion_rot_epi"]
    check(err <= 2e-6, "E2: within the px6 bound 2e-6 of the f64 oracle")
    del y, want, x_e2, e2

    print("== phase 3i: the other backends end to end through "
          "RecFilter.as_func()", flush=True)
    bcases = {}  # label: (module, input on the card) for phase 5j

    def stage_name(st):
        """A backend stage's route: a strip pass's, a staged pair's or an
        einsum form's, else the executor's class (a swapped pair's
        body)."""
        st = st.body if hasattr(st, "a") else st
        name = type(st).__name__
        return (st.route if name in ("StripAxis", "StagedPass", "OverlapND")
                else name)

    def backend_case(label, F, expect, routes=None, **plan):
        """Drive ``F`` on ``plan``'s backend once, counts zeroed just
        before: assert the launches ``expect``, print and check the
        error against the f64 oracle (2e-6)."""
        if plan:
            F.set_plan(**plan)
        mod = F.as_func()
        x = torch.from_numpy(F._image).to(dev)
        with torch.no_grad():
            y, launches = counted(mod, x)
        if routes is not None:
            got_routes = [stage_name(st) for st in mod.stages]
            print(f"  {label}: stages {got_routes}")
            check(got_routes == routes, f"{label}: stages {routes}")
        print(f"  {label}: launches {launches}")
        check(launches == only(**expect), f"{label}: launches {expect}")
        check(tuple(y.shape) == F._image.shape
              and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {F._image.shape}")
        err = oracle_err(F.spec, F._image, y)
        print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e}")
        check(err <= 2e-6, f"{label}: within 2e-6 of the f64 oracle")
        bcases[label] = (mod, x)
        return launches

    o1 = backend_case("O1 headline 4096², overlap_k at highest",
                      build_filter(rft, H, W, image(H, W)),
                      dict(moments2d_k=1, final2d_k=1), ["Fused2DK"],
                      backend="overlap_k", matmul_precision="highest")
    main_launches.update(moments2d_k=o1["moments2d_k"],
                         final2d_k=o1["final2d_k"])
    backend_case("O2 Gaussian twice per axis 4096² (Ka = Kb = 12), "
                 "overlap_k at px6", gauss_axes(rft, (H, W), (0, 1),
                                                times=2),
                 dict(moments2d_k=1, final2d_k=1), ["Fused2DK"],
                 backend="overlap_k")
    backend_case("O3 headline 4096², overlap_k at px6",
                 build_filter(rft, H, W, image(H, W)),
                 dict(moments2d=1, final2d=1), ["Fused2DPx"],
                 backend="overlap_k")
    backend_case("O4 V1 256³, overlap (fused_nd_pass)",
                 gauss_axes(rft, (256, 256, 256), (0, 1, 2)), {},
                 ["nd"], backend="overlap")
    backend_case("O4 1080 x 1920 clamp, overlap (two dimension passes)",
                 build_filter(rft, 1080, 1920, image(1080, 1920), True), {},
                 ["pair-fallback"], backend="overlap")
    P1 = build_filter(rft, H, W, image(H, W))
    P1.intra_schedule(1).compute_locally()
    check(P1.plan.backend == "pallas",
          "P1: compute_locally() selects the pallas backend")
    p1 = backend_case("P1 headline 4096², compute_locally (pallas)", P1,
                      dict(dim_pass_rows=1, dim_pass_cols=1),
                      ["rows", "cols"])
    main_launches.update(dim_pass_rows=p1["dim_pass_rows"],
                         dim_pass_cols=p1["dim_pass_cols"])
    backend_case("P2 1080 x 1920 clamp, pallas",
                 build_filter(rft, 1080, 1920, image(1080, 1920), True),
                 dict(dim_pass_rows=1), ["rows", "blocked"],
                 backend="pallas")
    backend_case("P3 256³, pallas", gauss_axes(rft, (256, 256, 256),
                                               (0, 1, 2)),
                 dict(dim_pass_cols=2, dim_pass_rows=1),
                 ["cols", "cols", "rows"], backend="pallas")
    backend_case("B1 headline 1024², blocked",
                 build_filter(rft, 1024, 1024, image(1024, 1024)), {},
                 backend="blocked")
    backend_case("S1 headline 1024², scan",
                 build_filter(rft, 1024, 1024, image(1024, 1024)), {},
                 backend="scan")
    S3 = rft.RecFilter("Untiled")
    xs_, ys_ = rft.Dim("x", 1024), rft.Dim("y", 1024)
    S3[ys_, xs_] = image(1024, 1024)
    for d in (+xs_, -xs_, +ys_, -ys_):
        S3.add_filter(d, rft.gaussian_weights(5.0, 3))
    check(S3.plan.backend == "auto" and not S3.spec.tiled,
          "S3: an untiled filter on the auto backend")
    backend_case("S3 untiled headline 1024² (auto: the sequential core)",
                 S3, {})
    sat = rft.RecFilter("SAT")
    xs_, ys_ = rft.Dim("x", 2048), rft.Dim("y", 2048)
    sat_img = np.random.default_rng(40).integers(-100, 100, (2048, 2048),
                                                 dtype=np.int32)
    sat[ys_, xs_] = sat_img
    sat.add_filter(+xs_, [1, 1])
    sat.add_filter(+ys_, [1, 1])
    sat.split(xs_, 128, ys_, 128)
    sat.set_plan(backend="pallas")
    with torch.no_grad():
        y, launches = counted(sat.as_func(),
                              torch.from_numpy(sat_img).to(dev))
    print(f"  S2 int32 SAT 2048², pallas: launches {launches}")
    check(launches == only(), "S2: the sequential core, no launch")
    check(y.dtype == torch.int32 and np.array_equal(
        y.cpu().numpy(), sat_img.cumsum(1).cumsum(0)),
        "S2: bit-equal to numpy's cumsum")
    del y

    print("== phase 3j: the headline on its four carry routes "
          "(RECFILTER_PX2D_BK, RECFILTER_PXM_NAF), and bench.main()",
          flush=True)
    want_h = scan_core.oracle_apply(F_h.spec, img_h.astype(np.float64))
    route_ops = {}
    for label, m in routes.items():
        bk, naf = ROUTES[label]
        with torch.no_grad():
            y, launches = counted(m, x_h)
        print(f"  {label}: launches {launches}")
        check(launches == only(
            final2d=1, bsolve=int(bk),
            **{"moments2d_naf" if naf else "moments2d": 1}),
            f"{label}: the route's kernels, each launched once")
        if bk:
            main_launches["bsolve"] = launches["bsolve"]
        if naf:
            main_launches["moments2d_naf"] = launches["moments2d_naf"]
        check(tuple(y.shape) == img_h.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {img_h.shape}")
        got = y.cpu().numpy().astype(np.float64)
        err = float(np.abs(got - want_h).max() / np.abs(want_h).max())
        print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e}")
        check(err <= 2e-6, f"{label}: within the px6 bound 2e-6 of the f64 "
              "oracle")
        with torch.no_grad():
            prof = timing.device_profile(m, x_h, iterations=10)
        route_ops[label] = prof
        print(f"  {label}: {prof['device_ops']:.0f} device ops a call, "
              f"device busy {busy_text(prof)}, call {prof['call_ms']:.4f} "
              f"ms on {card}; top: " + ", ".join(
                  f"{nm[:40]} {ms:.4f} ms" for nm, ms in prof["top"]))
    del y, got, want_h
    launch.reset_launches()
    bench_out = bench.main()
    torch.cuda.synchronize()
    main_launches["copy"] = launch.LAUNCHES["copy"]
    check(main_launches["copy"] > 0 and bench_out["measured_bw_gb_s"] > 0,
          f"bench.main(): {main_launches['copy']} copy launches, measured "
          f"bandwidth {bench_out['measured_bw_gb_s']} GB/s, "
          f"{bench_out['value']} Mpix/s on {bench_out['device']}")

    carry_times = {}  # kernel: what ``timed`` returns
    print("== phase 3k: bsolve, moments2d_naf and copy at the headline's "
          "shapes, and its four carry routes (CUDA events, median of "
          f"{4 * N_TIMED // 2} calls each)", flush=True)
    with torch.no_grad():
        X4 = mod_h.tile(x_h)
        NA64 = mod_h._carries(X4, mod_h.moments.plain)[0]
        NA32, term1 = NA64.float(), mod_h.moments.plain(X4)[1]
        bsm, nm = routes["BK"].bsolve, routes["NAF"].moments
        p_, na_, nb_, Ka, Kb = 1, mod_h.na, mod_h.nb, mod_h.Ka, mod_h.Kb
        M = nb_ * Kb
        NB = bsm(NA32, term1)
        r = timed("bsolve (4096², M = nb·Kb = %d)" % M, bsm, bsm.plain, None,
                  (NA32, term1),
                  tensor_bytes(NA32, term1, NB, bsm.Gb_v, bsm.RaT_v, bsm.CMT),
                  2.0 * p_ * na_ * (M * M + 2 * M * Ka) * 128, PEAK_FP64,
                  main_launches["bsolve"])
        carry_times["bsolve"] = r  # into times, dev_t, extra after 5a

        def glue_b(na64, t1):
            """The glue ops bsolve replaces: GN, the coupling, the add,
            the f64 solve and the cast (``Fused2DPx._carries``)."""
            bB = k2d.carry_b_tails(mod_h.Gb8n, mod_h.Ran, na64, t1, Ka)
            return mod_h._solve("b", bB, Kb).reshape(NB.shape).float()

        check(rel_err(glue_b(NA64, term1), NB) <= 1e-5,
              "the glue computes bsolve's function")
        print(f"  the glue ops bsolve replaces: event "
              f"{median_ms(glue_b, NA64, term1):.4f} ms, device "
              f"{device_ms(glue_b, NA64, term1):.4f} ms on {card}")
        N_A = nm(X4)[0]
        r = timed("moments2d_naf (4096², clusters of 16)", nm, nm.plain, None,
                  (X4,), tensor_bytes(X4, N_A, term1, nm.Ga_v, nm.Gb_v,
                                      nm.Ba1T_v, nm.CMaT),
                  2.0 * (Ka + 2 * Kb) * X4.numel()
                  + 2.0 * p_ * (na_ * Ka) ** 2 * X4.shape[-1], PEAK_FP64,
                  main_launches["moments2d_naf"])
        carry_times["moments2d_naf"] = r  # into times, dev_t, extra after 5a

        def raw_then_solve(v):
            """What moments2d_naf replaces: moments2d, then the glue's
            dim-A solve and its casts."""
            bA = mod_h.moments(v)[0]
            return mod_h._solve("a", bA.double(), Ka).float()

        check(rel_err(raw_then_solve(X4), N_A) <= 1e-5,
              "moments2d then the solve computes moments2d_naf's N_A")
        print(f"  moments2d then the glue's dim-A solve: event "
              f"{median_ms(raw_then_solve, X4):.4f} ms, device "
              f"{device_ms(raw_then_solve, X4):.4f} ms on {card}")
        del X4, NA64, NA32, term1, NB, N_A
        r = timed("copy (4096² float32)", kcopy.copy, kcopy.plain,
                  lambda v: torch.mul(v, kcopy.SCALE), (x_h,),
                  2 * tensor_bytes(x_h), float(x_h.numel()), PEAK_FP32,
                  main_launches["copy"])
        carry_times["copy"] = r  # into times, dev_t, extra after 5a
        print(f"  copy bandwidth: {2 * tensor_bytes(x_h) / r[1][0] / 1e6:.1f}"
              f" GB/s from the device time, "
              f"{2 * tensor_bytes(x_h) / r[0][0] / 1e6:.1f} GB/s from the "
              f"event time on {card}")
        # the four routes in turns: glue, BK, NAF, BK+NAF, then back
        order = list(routes) + list(routes)[::-1]
        ev = {label: [] for label in routes}
        for label in order:
            ev[label] += timing.call_times_ms(routes[label], x_h,
                                              iterations=N_TIMED, warmup=3)
        for label in routes:
            prof = route_ops[label]
            print(f"  {label} route: event {statistics.median(ev[label]):.4f}"
                  f" ms ({timing.mpix_per_sec(statistics.median(ev[label]), H * W):.0f}"
                  f" Mpix/s), device {device_ms(routes[label], x_h):.4f} ms; "
                  f"profile: {prof['device_ops']:.0f} ops, busy "
                  f"{busy_text(prof)} on {card}")
    del routes, x_h

    print("== phase 4: gradients through the kernel paths", flush=True)
    img = image(512, 512, seed=1)
    grad_cases = [
        ("2-D 512²", build_filter(rft, 512, 512, img).as_func(),
         img),
        ("1-D 300,000 order 3",
         audio_filter_high_order(300_000, 3, 1000).as_func(),
         signal((300_000,), seed=1)),
        ("volume 128x128x256",
         gauss_axes(rft, (128, 128, 256), (0, 1, 2)).as_func(),
         image(128, 128, 256, seed=1)),
        ("box_filter_3 512²", box_filter_3(512, 512, 5), img),
        ("K3's chain at 200 x 128 x 128",
         gauss_axes(rft, (200, 128, 128), (0, 1, 2)).as_func(),
         image(200, 128, 128, seed=1))]
    for label, mod, xin in grad_cases:
        grads = []
        for fwd in (mod.forward, mod.forward_plain):
            x = torch.from_numpy(xin).to(dev).requires_grad_()
            (g,) = torch.autograd.grad((fwd(x) ** 2).sum(), x)
            grads.append(g)
        dg = (grads[0] - grads[1]).abs()
        bound = 1e-4 + 1e-4 * grads[1].abs()
        print(f"  {label}: max|g_kernel - g_plain| = {dg.max().item():.3e} "
              f"(max|g| = {grads[1].abs().max().item():.3e})")
        check(bool((dg <= bound).all()),
              f"{label}: gradient within rtol=atol=1e-4")
    # the consumers: the gradient of <y, ct> (a fixed cotangent — the
    # stages are linear and the integrals' forward values differ between
    # the paths by rounding, which (y²) would carry into the gradient)
    c1g = difference_of_gaussians(512, 512, 5, 9, variant="sat")
    img = image(512, 512, seed=18)
    ct = torch.from_numpy(image(2, 512, 512, seed=19) * 100).to(dev)
    for label, mod in (("C1's stencil2d stage (SAT + 4-corner bank) 512²",
                        c1g.sat_box),
                       ("a rotated stencil pass (SAT2x, B = 5) 512²",
                        c1g.sat2x[0])):
        grads = []
        for fwd in (mod.forward, mod.forward_plain):
            x = torch.from_numpy(img).to(dev).requires_grad_()
            y = fwd(x)
            y = torch.stack(y) if isinstance(y, tuple) else y[None]
            (g,) = torch.autograd.grad((y * ct[:len(y)]).sum(), x)
            grads.append(g)
        dg = (grads[0] - grads[1]).abs()
        bound = 1e-4 + 1e-4 * grads[1].abs()
        print(f"  {label}: max|g_kernel - g_plain| = {dg.max().item():.3e} "
              f"(max|g| = {grads[1].abs().max().item():.3e})")
        check(bool((dg <= bound).all()),
              f"{label}: gradient within rtol=atol=1e-4")
    # U1's input gradient: through the filter and the combine's aux (the
    # image is both), against the naive route's
    grads = []
    for mod in (u1, u2):
        x = x_u.clone().requires_grad_()
        (g,) = torch.autograd.grad((mod(x) ** 2).sum(), x)
        grads.append(g)
    dg = (grads[0] - grads[1]).abs()
    print(f"  U1 4096²: max|g_merged - g_naive| = {dg.max().item():.3e} "
          f"(max|g| = {grads[1].abs().max().item():.3e})")
    check(bool((dg <= 1e-4 + 1e-4 * grads[1].abs()).all()),
          "U1: input gradient within rtol=atol=1e-4 of U2's")
    del grads, dg, g, x

    print("== phase 5a: 2-D device times at 4096² (CUDA events, median of "
          f"{4 * N_TIMED // 2} calls each)", flush=True)
    F, mod, img = modules["4096x4096 zero"]
    x = torch.from_numpy(img).to(dev)
    px = H * W
    with torch.no_grad():
        X4 = mod.tile(x)
        NA_t, NB_t = mod.carries(X4, mod.moments.plain)
        times = {
            "filter": paired_times(mod, mod.forward_plain, x),
            "moments2d": paired_times(mod.moments, mod.moments.plain, X4),
            "final2d": paired_times(mod.final, mod.final.plain, X4, NA_t,
                                    NB_t),
        }
        # bounds: bA_t and term1 have NA_t's and NB_t's shapes; moments2d
        # sums in fp64, final2d multiplies in fp32; no one PyTorch call
        # computes either function
        Ka, Kb, pix = mod.Ka, mod.moments.Kb, X4.numel()
        dev_t = {
            "moments2d": (device_ms(mod.moments, X4),
                          device_ms(mod.moments.plain, X4), None),
            "final2d": (device_ms(mod.final, X4, NA_t, NB_t),
                        device_ms(mod.final.plain, X4, NA_t, NB_t), None)}
        extra = {
            "moments2d": (*roofline(
                tensor_bytes(X4, NA_t, NB_t, mod.moments.Ga_v, mod.moments.Gb_v,
                       mod.moments.Ba1T_v),
                2.0 * (Ka + 2 * Kb) * pix, PEAK_FP64), None),
            "final2d": (*roofline(
                tensor_bytes(X4, NA_t, NB_t, X4, mod.final.A1_v, mod.final.B2_v),
                2.0 * (2 * 128 + Ka + Kb) * pix, PEAK_FP32), None)}
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel path {k_ms:.4f} ms "
              f"({timing.mpix_per_sec(k_ms, px):.0f} Mpix/s), plain "
              f"{p_ms:.4f} ms ({timing.mpix_per_sec(p_ms, px):.0f} Mpix/s)"
              f" on {card}")

    print("== phase 5b: 1-D device times at 10M samples (CUDA events, "
          f"median of {4 * N_TIMED // 2} calls each)", flush=True)
    for label in ("A", "B"):
        F, mod = cases_1d[label]
        x, want = refs[label]
        loc, X = local_inputs(label)
        q, n, S, sl = X.shape[0], loc.n, loc.S, loc.sl
        with torch.no_grad():
            Nt = loc._solve_t(loc.tails.plain(X).double()).float()
            t = {"filter": paired_times(mod, mod.forward_plain, x),
                 "tails": paired_times(loc.tails, loc.tails.plain, X),
                 "completion": paired_times(loc.completion,
                                            loc.completion.plain, X, Nt)}
            if label == "A":
                times.update(tails=t["tails"], completion=t["completion"])
                # one PyTorch call each: the tails as an einsum, the
                # completion as one matmul of [x, Nᵀ] against [Btotᵀ; Rᵀ]
                # (one variant: A has zero border and no pad)
                check(loc.tails.G_v.shape[0] == 1
                      and loc.completion.BR_v.shape[0] == 1,
                      "A's tiles share one matrix variant")
                G0, BR0 = loc.tails.G_v[0], loc.completion.BR_v[0]
                XN = torch.cat([X, Nt.permute(2, 0, 1)], dim=2)
                check(rel_err(torch.einsum("st,qnt->nsq", G0, X),
                              loc.tails(X)) <= 1e-5
                      and rel_err(torch.matmul(XN, BR0),
                                  loc.completion(X, Nt)) <= 1e-5,
                      "A: the library calls compute the kernels' functions")
                tails_lib = (
                    lambda g, v: torch.einsum("st,qnt->nsq", g, v))
                dev_t["tails"] = (device_ms(loc.tails, X),
                                  device_ms(loc.tails.plain, X),
                                  device_ms(tails_lib, G0, X))
                dev_t["completion"] = (
                    device_ms(loc.completion, X, Nt),
                    device_ms(loc.completion.plain, X, Nt),
                    device_ms(torch.matmul, XN, BR0))
                extra["tails"] = (*roofline(
                    tensor_bytes(X, Nt, loc.tails.G_v), 2.0 * S * X.numel(),
                    PEAK_FP64), median_ms(tails_lib, G0, X))
                extra["completion"] = (*roofline(
                    tensor_bytes(X, Nt, X, loc.completion.BR_v),
                    2.0 * (128 + S) * X.numel(), PEAK_FP32),
                    median_ms(torch.matmul, XN, BR0))
                del XN
            prof = timing.device_profile(mod, x, iterations=10)
        nbytes = X.numel() * 4 + n * sl * q * 4
        flops = 2.0 * q * n * 128 * (128 + sl)
        for name, (k_ms, p_ms) in t.items():
            print(f"  {label} {name}: kernel path {k_ms:.4f} ms "
                  f"({timing.mpix_per_sec(k_ms, n10):.0f} Msamples/s), "
                  f"plain {p_ms:.4f} ms "
                  f"({timing.mpix_per_sec(p_ms, n10):.0f} Msamples/s) on "
                  f"{card}")
        print(f"  {label} tails: {nbytes / 1e6:.1f} MB in "
              f"{t['tails'][0]:.4f} ms = "
              f"{nbytes / t['tails'][0] / 1e9:.3f} TB/s, "
              f"{100 * nbytes / t['tails'][0] / 1e9 / 3.35:.1f} % of 3.35 TB/s")
        print(f"  {label} completion: {flops / 1e9:.2f} GFLOP in "
              f"{t['completion'][0]:.4f} ms = "
              f"{flops / t['completion'][0] / 1e9:.2f} TFLOP/s, "
              f"{100 * flops / t['completion'][0] / 1e9 / 67:.1f} % of the "
              "67 TFLOP/s fp32 peak")
        print(f"  {label} first-call host build (as_func): "
              f"{build_s[label]:.2f} s")
        print(f"  {label} profile: call {prof['call_ms']:.4f} ms, device "
              f"busy {busy_text(prof)}, {prof['device_ops']:.0f} device ops "
              "per call; "
              "top: " + ", ".join(f"{nm[:40]} {ms:.4f} ms"
                                  for nm, ms in prof["top"]))

    print("== phase 5c: the fp32-accumulating tails variant, end to end",
          flush=True)
    for label, (F, mod) in cases_1d.items():
        x, want = refs[label]
        body = mod.body
        locs = list(body.locals) if hasattr(body, "locals") else [body]
        with torch.no_grad():
            for loc in locs:
                loc.tails.fp64 = False  # the kernel's fp32 instantiation
            y32 = mod(x)
            for loc in locs:
                loc.tails.fp64 = True
        err = float(np.abs(y32.cpu().numpy().astype(np.float64) - want).max()
                    / np.abs(want).max())
        print(f"  {label}: fp32 tails sums, max|y - ref|/max|ref| = "
              f"{err:.3e} (fp64 sums: phase 3b)")

    print("== phase 5d: rows-path device times (CUDA events, median of "
          f"{4 * N_TIMED // 2} calls each)", flush=True)
    for label in ("V1", "V2", "S3"):
        F, mod, xs = rows_cases[label]
        rows = rows_of(label)
        x = torch.from_numpy(xs).to(dev)
        with torch.no_grad():
            X4 = rows.tile(x)
            N = rows.carries(X4, rows.tails.plain)
            t = {"filter": paired_times(mod, mod.forward_plain, x),
                 "rows_tails": paired_times(rows.tails, rows.tails.plain,
                                            X4),
                 "rows_final": paired_times(rows.final, rows.final.plain,
                                            X4, N)}
            K, vox = rows.K, X4.numel()
            tb = tensor_bytes(X4, N, rows.tails.G_v)
            fb = tensor_bytes(X4, N, X4, rows.final.A1_v)
            flops = 2.0 * (128 + K) * vox
            if label == "V2":
                print(f"  V2 device times (profiler): rows_tails "
                      f"{device_ms(rows.tails, X4):.4f} ms, rows_final "
                      f"{device_ms(rows.final, X4, N):.4f} ms")
            if label == "V1":
                times.update(rows_tails=t["rows_tails"],
                             rows_final=t["rows_final"])
                # one PyTorch call each (one variant at zero border): G·x
                # as a matmul (fp32 sums), and [Btot | Rhat]·[x; N]
                check(rows.tails.G_v.shape[0] == 1,
                      "V1's tiles share one matrix variant")
                G0, A0 = rows.tails.G_v[0], rows.final.A1_v[0].T
                XN = torch.cat([X4, N], dim=2)
                check(rel_err(torch.matmul(G0, X4), rows.tails(X4)) <= 1e-5
                      and rel_err(torch.matmul(A0, XN),
                                  rows.final(X4, N)) <= 1e-5,
                      "V1: the library calls compute the kernels' functions")
                dev_t["rows_tails"] = (
                    device_ms(rows.tails, X4), device_ms(rows.tails.plain, X4),
                    device_ms(torch.matmul, G0, X4))
                dev_t["rows_final"] = (
                    device_ms(rows.final, X4, N),
                    device_ms(rows.final.plain, X4, N),
                    device_ms(torch.matmul, A0, XN))
                extra["rows_tails"] = (*roofline(tb, 2.0 * K * vox, PEAK_FP64),
                                       median_ms(torch.matmul, G0, X4))
                extra["rows_final"] = (*roofline(fb, flops, PEAK_FP32),
                                       median_ms(torch.matmul, A0, XN))
                del XN
                prof = timing.device_profile(mod, x, iterations=10)
            del X4, N
        for name, (k_ms, p_ms) in t.items():
            print(f"  {label} {name}: kernel path {k_ms:.4f} ms "
                  f"({timing.mpix_per_sec(k_ms, xs.size):.0f} Mvox/s), "
                  f"plain {p_ms:.4f} ms "
                  f"({timing.mpix_per_sec(p_ms, xs.size):.0f} Mvox/s) on "
                  f"{card}")
        print(f"  {label} rows_tails: {tb / 1e6:.1f} MB in "
              f"{t['rows_tails'][0]:.4f} ms = "
              f"{tb / t['rows_tails'][0] / 1e9:.3f} TB/s, "
              f"{100 * tb / t['rows_tails'][0] / 1e9 / 3.35:.1f} % of "
              "3.35 TB/s")
        print(f"  {label} rows_final: {flops / 1e9:.2f} GFLOP in "
              f"{t['rows_final'][0]:.4f} ms = "
              f"{flops / t['rows_final'][0] / 1e9:.2f} TFLOP/s, "
              f"{100 * flops / t['rows_final'][0] / 1e9 / 67:.1f} % of the "
              "67 TFLOP/s fp32 peak")
        if label == "V1":
            print(f"  V1 profile: call {prof['call_ms']:.4f} ms, device busy "
                  f"{busy_text(prof)}, {prof['device_ops']:.0f} device ops "
                  "per call; "
                  "top: " + ", ".join(f"{nm[:40]} {ms:.4f} ms"
                                      for nm, ms in prof["top"]))
        del x
    fc = gaussian_3x_3y(W, H)
    stages = [f.as_func() for f in fc]
    three = gaussian_3xy(W, H).as_func()

    def staged(v):
        for m in stages:
            v = m(v)
        return v

    with torch.no_grad():
        x = torch.from_numpy(image(H, W)).to(dev)
        check(rel_err(staged(x), three(x)) <= 2e-6,
              "S1 staged equals gaussian_3xy within 2e-6")
        s_ms, t_ms = paired_times(staged, three, x)
        s_prof = timing.device_profile(staged, x, iterations=10)
        t_prof = timing.device_profile(three, x, iterations=10)
    print(f"  S1 gaussian_3x_3y, both stages: {s_ms:.4f} ms "
          f"({timing.mpix_per_sec(s_ms, H * W):.0f} Mpix/s); gaussian_3xy "
          f"(3-touch): {t_ms:.4f} ms "
          f"({timing.mpix_per_sec(t_ms, H * W):.0f} Mpix/s); ratio "
          f"{s_ms / t_ms:.3f} on {card}")
    for what, pr in (("S1 both stages", s_prof), ("gaussian_3xy", t_prof)):
        print(f"  {what} profile: call {pr['call_ms']:.4f} ms, device busy "
              f"{busy_text(pr)}, {pr['device_ops']:.0f} device ops per call")
    if s_prof["busy_ms"] is not None and t_prof["busy_ms"] is not None:
        print(f"  S1 / gaussian_3xy device busy: "
              f"{s_prof['busy_ms'] / t_prof['busy_ms']:.3f}")

    print("== phase 5e: FIR and integer device times (CUDA events, median "
          f"of {4 * N_TIMED // 2} calls each)", flush=True)

    def whole_call(label, mod, v, n, top=False):
        """Whole-call events against the plain path, and the profile (with
        ``top``, its largest device ops)."""
        k_ms, p_ms = paired_times(mod, mod.forward_plain, v)
        prof = timing.device_profile(mod, v, iterations=10)
        print(f"  {label} whole call: kernel path {k_ms:.4f} ms "
              f"({timing.mpix_per_sec(k_ms, n):.0f} M/s), plain {p_ms:.4f} "
              f"ms ({timing.mpix_per_sec(p_ms, n):.0f} M/s); profile: call "
              f"{prof['call_ms']:.4f} ms, device busy {busy_text(prof)}, "
              f"{prof['device_ops']:.0f} device ops per call on {card}"
              + ("; top: " + ", ".join(f"{nm[:40]} {ms:.4f} ms"
                                       for nm, ms in prof["top"])
                 if top else ""))

    def kernel_times(label, fn, plain, lib, args, nbytes, ops, rate):
        """Event and device times of a kernel, its twin and its library
        yardstick; returns (event pair, device triple, bound, library)."""
        t = paired_times(fn, plain, *args)
        d = (device_ms(fn, *args), device_ms(plain, *args),
             device_ms(lib, *args))
        lib_ms = median_ms(lib, *args)
        bound, by = roofline(nbytes, ops, rate)
        print(f"  {label}: event {t[0]:.4f} ms, device {d[0]:.4f} ms; "
              f"bound {bound:.4f} ms by {by} ({100 * bound / d[0]:.1f} % of "
              f"the device time); twin event {t[1]:.4f}, device {d[1]:.4f} "
              f"ms; library event {lib_ms:.4f}, device {d[2]:.4f} ms")
        return t, d, (bound, by), lib_ms

    with torch.no_grad():
        for label, mod in (("F1 box_filter_3", box3), ("F3 DoG", dog)):
            y_mid = mod.x_pass.band.plain(xf)
            for name, band, v in (("x pass", mod.x_pass.band, xf),
                                  ("y pass", mod.y_pass.band, y_mid)):
                w = torch.from_numpy(np.stack(
                    [box_taps(5, 3)] if label.startswith("F1")
                    else _align_taps(dog_taps)).astype(np.float32))
                w = w[:, None].to(dev)  # (C, 1, K) conv1d weights
                Kt = w.shape[-1]
                if band.contract:  # the signed channel sum: one grouped
                    w = w * torch.tensor([1.0, -1.0], device=dev)[:, None,
                                                                  None]

                    def lib(v, w=w, Kt=Kt):
                        return F_.conv1d(v.permute(1, 0, 2), w.view(1, 2, Kt),
                                         padding=(Kt - 1) // 2)
                else:
                    def lib(v, w=w, Kt=Kt):
                        return F_.conv1d(v.reshape(v.shape[0], 1, v.shape[1]),
                                         w, padding=(Kt - 1) // 2)
                got = band(v)
                ref = lib(v).squeeze(1) if band.Cout == 1 else \
                    lib(v).permute(1, 0, 2)
                check(rel_err(ref.transpose(-1, -2), got) <= 1e-5,
                      f"{label} {name}: conv1d computes the kernel's "
                      "function (flat emit)")
                nbytes = tensor_bytes(v, got, band.taps_k)
                ops = 2.0 * Kt * band.Cin * got.numel()
                r = kernel_times(f"{label} {name} fir_band", band, band.plain,
                                 lib, (v,), nbytes, ops, PEAK_FP32)
                if label.startswith("F1") and name == "x pass":
                    times["fir_band"] = r[0]
                    dev_t["fir_band"] = r[1]
                    extra["fir_band"] = (*r[2], r[3])
                del got, ref
            del y_mid
            whole_call(label, mod, xf, H * W)

        units = [(1, 1, True)]
        for label, ax in (("I1 x (lanes)", 1), ("I1 y (rows)", 0)):
            r = kernel_times(
                f"{label} int_scan",
                lambda v, ax=ax: int_scan.int_unit_dim_pass(v, units, ax),
                lambda v, ax=ax: int_scan.unit_scans_plain(v, units, ax),
                lambda v, ax=ax: torch.cumsum(v, ax, dtype=torch.int32),
                (x_i1,), 2 * tensor_bytes(x_i1), x_i1.numel(), PEAK_INT32)
            if ax == 1:
                times["int_scan"], dev_t["int_scan"] = r[0], r[1]
                extra["int_scan"] = (*r[2], r[3])
        whole_call("I1 int32 SAT", int_mods["I1"], x_i1, H * W)

        unit = (1, 1, True)
        C = int_scan._chunk_len(x_i3.shape[1])
        r = kernel_times(
            "I3 int_seg_scan (both phases and the carry chain)",
            seg_route(int_scan, unit, False), seg_route(int_scan, unit, True),
            lambda v: torch.cumsum(v, 1, dtype=torch.int32), (x_i3,),
            2 * tensor_bytes(x_i3), x_i3.numel(), PEAK_INT32)
        times["int_seg_scan"], dev_t["int_seg_scan"] = r[0], r[1]
        extra["int_seg_scan"] = (*r[2], r[3])
        c = int_scan.seg_carries(x_i3, unit, 0, C)
        inc = int_scan._carry_chain(c, True)
        for phase, fn in (
                ("int_seg_carries",
                 lambda v: int_scan.seg_carries(v, unit, 0, C)),
                ("int_seg_fix",
                 lambda v: int_scan.seg_fix(v, inc, unit, 0, C))):
            print(f"  I3 {phase}: event {median_ms(fn, x_i3):.4f} ms, device "
                  f"{device_ms(fn, x_i3):.4f} ms")
        whole_call("I3 8 x 10M int32 cumsum", int_mods["I3"], x_i3,
                   x_i3.numel())
        del c, inc

    print("== phase 5f: the rotated emit and the stencil kernels at C1's "
          f"shapes, and the whole calls C1-C5 (CUDA events, median of "
          f"{4 * N_TIMED // 2} calls each)", flush=True)

    with torch.no_grad():
        # C1's SAT stage: moments2d with its edge rows, final2d_stencil
        X4 = c1sat.tile(x_c1)
        NA, NB, ht, hb = c1sat._carries(X4)
        top, bot = c1sat.halo_strips(ht, hb, NA, NB)
        NA, NB = NA.float(), NB.float()
        px, h8 = X4.numel(), c1sat.h8
        mom = c1sat.moments
        timed("C1 moments2d with 2 x 16 edge rows", mom, mom.plain, None,
              (X4,), tensor_bytes(X4, NA, NB, ht, hb),
              2.0 * (c1sat.Ka + 2 * c1sat.Kb + 2 * h8) * px, PEAK_FP64, 1)
        taps = sum(len(t) for t in c1sat.final.bank.taps_c)
        r = timed("C1 final2d_stencil (C = 2)", c1sat.final, c1sat.final.plain,
                  None, (X4, NA, NB, top, bot),
                  tensor_bytes(X4, NA, NB, top, bot, X4, X4),
                  2.0 * (2 * 128 + c1sat.Ka + c1sat.Kb + taps) * px, PEAK_FP32, 1)
        times["final2d_stencil"], dev_t["final2d_stencil"] = r[0], r[1]
        extra["final2d_stencil"] = (*r[2], r[3])
        del X4, NA, NB, ht, hb, top, bot
        # C1's first rotated pass (x, radius 5) on the bank's output
        v = c1sat(x_c1)[0]
        loc = c1.sat2x[0].body
        X = v.reshape(-1, loc.n, 128)
        tails, comp = loc.st_tails[0], loc.st_comp[0]
        bp = tails.plain(X).double()
        Nt = loc._solve_t(bp[:, :loc.sl])
        halos = tdf._stencil_halo(bp[:, loc.sl:], Nt, loc.st_R0,
                                  *loc.st_reach[0])
        Nt = Nt.float().contiguous()
        q, n = X.shape[0], loc.n
        # one PyTorch call: the einsum of x with the stacked [G; extra
        # rows] (fp32 sums, as phase 5b's yardstick of the plain tails)
        check(tails.G_v.shape[0] == 1, "C1: the x pass's tiles share one "
              "tails variant")
        G0 = tails.G_v[0]
        check(rel_err(torch.einsum("st,qnt->nsq", G0, X), tails(X)) <= 1e-5,
              "C1: the einsum computes tails_extra's function")
        r = timed(f"C1 tails_extra ({tails.He} extra rows)", tails,
                  tails.plain, lambda v: torch.einsum("st,qnt->nsq", G0, v),
                  (X,), tensor_bytes(X, tails.G_v)
                  + 4 * n * (tails.sl + tails.He) * q,
                  2.0 * (loc.S + tails.He) * X.numel(), PEAK_FP64, 4)
        times["tails_extra"], dev_t["tails_extra"] = r[0], r[1]
        extra["tails_extra"] = (*r[2], r[3])
        XN = torch.cat([X, Nt.permute(2, 0, 1)], dim=2)
        BR0 = comp.BR_v[0]
        check(rel_err(torch.matmul(XN, BR0).permute(1, 2, 0).reshape(-1, q),
                      loc.completion(X, Nt)) <= 1e-5,
              "C1: the matmul computes the rotated completion (transposed)")
        r = timed("C1 completion_rot + 3-tap stencil", comp, comp.plain,
                  lambda x_, n_, *h: torch.matmul(XN, BR0), (X, Nt, *halos),
                  tensor_bytes(X, Nt, *halos, X),
                  2.0 * (128 + loc.sl + len(comp.taps)) * X.numel(),
                  PEAK_FP32, main_launches["completion_rot"])
        times["completion_rot"], dev_t["completion_rot"] = r[0], r[1]
        extra["completion_rot"] = (*r[2], r[3])
        del v, X, bp, Nt, halos, XN
        # stencil2d at C4's shapes: the Sobel bank on the blurred image
        bank = c4.bank
        v = c4.body(x_c4)
        wts = torch.zeros(2, 1, 3, 3, device=dev)
        for c, taps_c in enumerate(SOBEL):
            for dy, dx, cf in taps_c:
                wts[c, 0, dy + 1, dx + 1] = cf

        def conv(y_):
            return F_.conv2d(y_[None, None], wts, padding=1)[0]

        got = torch.stack(bank(v))
        check(rel_err(conv(v)[:, 1:-1, 1:-1], got[:, 1:-1, 1:-1]) <= 1e-5,
              "C4: conv2d computes the bank inside the border")
        r = timed("C4 stencil2d (C = 2 Sobel)", bank,
                  lambda y_: bank.plain(y_), conv, (v,),
                  tensor_bytes(v, v, v), 2.0 * 12 * v.numel(), PEAK_FP32, 1)
        times["stencil2d"], dev_t["stencil2d"] = r[0], r[1]
        extra["stencil2d"] = (*r[2], r[3])
        del v, got

        class Call:
            """A whole call and its plain path as one timed callable."""

            def __init__(self, mod, *aux):
                self.mod, self.aux = mod, aux

            def __call__(self, v):
                return self.mod(v, *self.aux)

            def forward_plain(self, v):
                return self.mod.forward_plain(v, *self.aux)

        # the non-affine route's cost: an epilogue that final2d cannot
        # take runs as its own elementwise pass (torch ops after final2d);
        # timed on C5's combine 2a - o
        X4 = c5.tile(x_c5)
        y5 = c5.final.plain(X4, *c5.carries(X4), X4)
        print(f"  the non-affine route's torch-op pass, timed on C5's "
              f"combine 2a - o over the {tuple(y5.shape)} output: event "
              f"{median_ms(c5.epilogue, y5, y5):.4f} ms, device "
              f"{device_ms(c5.epilogue, y5, y5):.4f} ms on {card}")
        del X4, y5
        for label, mod, v in (("C1 DoG SAT", c1, x_c1),
                              ("C2 box_filter_3 SAT", box3s, x_c2),
                              ("C3 box_filter_6 SAT 2048²", box6s, x_c3),
                              ("C4 y-only blur + Sobel", c4, x_c4),
                              ("C5 Gaussian + unsharp epilogue (in "
                               "final2d_epi)",
                               Call(c5, x_c5), x_c5)):
            whole_call(label, mod, v, v.numel())

    print("== phase 5g: completion_rot_tails at K3's first pass, and the "
          f"K cases' calls (CUDA events, median of {4 * N_TIMED // 2} calls "
          "each)", flush=True)
    with torch.no_grad():
        p0, p1 = mod3.passes[0], mod3.passes[1]
        X = x3.reshape(-1, p0.n, 128)
        Nt = p0._solve_t(p0.tails(X).double()).float().contiguous()
        crt, rot, nxt = p0.completion_nt, p0.completion, p1.tails
        q, n2 = X.shape[0], crt.n2
        ra = q // (n2 * 128)

        def yardstick(x_, n_):
            """completion_rot, then the tails kernel on its output."""
            y_ = rot(x_, n_)
            return y_, nxt(y_.reshape(-1, n2, 128))

        yk, tk = crt(X, Nt)
        yy, ty = yardstick(X, Nt)
        check(torch.equal(yk, yy) and torch.equal(tk, ty),
              "K3: completion_rot_tails equals completion_rot + tails bit "
              "for bit")
        # one torch.matmul of [x, Nᵀ] by [Btotᵀ; Rᵀ] (unrotated), then
        # one torch.einsum of the tail rows over the next pass's tiles:
        # the library form of the same function, two calls (fp32 sums)
        check(crt.BR_v.shape[0] == 1 and crt.G2_v.shape[0] == 1,
              "K3's x pass: one matrix variant on both sides")
        XN = torch.cat([X, Nt.permute(2, 0, 1)], dim=2)
        BR0, G20 = crt.BR_v[0], crt.G2_v[0]

        def library(x_, n_):
            y_ = torch.matmul(XN, BR0)  # (z·y, x tiles, 128)
            return y_, torch.einsum("sj,acjx->csxa", G20, y_.reshape(
                ra, n2, 128, -1))

        yl, tl_ = library(X, Nt)
        check(rel_err(yl.permute(1, 2, 0).reshape(-1, q), yk) <= 1e-5
              and rel_err(tl_.reshape(tk.shape), tk) <= 1e-5,
              "K3: the library calls compute completion_rot_tails' function")
        del yy, ty, yl, tl_
        S2, sl = crt.S2, crt.sl
        nbytes = tensor_bytes(X, Nt, crt.BR_v, crt.G2_v, yk, tk)
        fp32, fp64 = 2.0 * (128 + sl) * X.numel(), 2.0 * S2 * X.numel()
        bound = max(nbytes / PEAK_BYTES, fp32 / PEAK_FP32 + fp64 / PEAK_FP64
                    ) * 1e3
        by = ("bytes" if nbytes / PEAK_BYTES >= fp32 / PEAK_FP32
              + fp64 / PEAK_FP64 else "operations")
        t = paired_times(crt, crt.plain, X, Nt)
        d = (device_ms(crt, X, Nt), device_ms(crt.plain, X, Nt))
        y_ms, y_dev = median_ms(yardstick, X, Nt), device_ms(yardstick, X, Nt)
        l_ms, l_dev = median_ms(library, X, Nt), device_ms(library, X, Nt)
        print(f"  K3 completion_rot_tails ({q} lines, {p0.n} tiles, next "
              f"{n2} tiles x ra = {ra}): 1 launch per call; event "
              f"{t[0]:.4f} ms, device {d[0]:.4f} ms; bound {bound:.4f} ms by "
              f"{by} ({nbytes / 1e6:.0f} MB, {fp32 / 1e9:.2f} GFLOP fp32 + "
              f"{fp64 / 1e9:.3f} GFLOP fp64; {100 * bound / d[0]:.1f} % of "
              f"the device time); twin event {t[1]:.4f}, device {d[1]:.4f} "
              f"ms; completion_rot + tails event {y_ms:.4f}, device "
              f"{y_dev:.4f} ms; library (matmul + einsum, two calls) event "
              f"{l_ms:.4f}, device {l_dev:.4f} ms on {card}")
        times["completion_rot_tails"] = t
        dev_t["completion_rot_tails"] = (d[0], d[1], l_dev)
        extra["completion_rot_tails"] = (bound, by, l_ms)
        del X, Nt, XN, yk, tk
        for label, (mod, v) in k_cases.items():
            whole_call(label, mod, v, v.numel(), top=True)
        del k_cases, mod3, x3

    print("== phase 5j: the calls O1, O2, P1, P3, B1 and S1, the HIGHEST pair "
          "at O1's shapes and the strip kernels at P1's (CUDA events, median "
          f"of {4 * N_TIMED // 2} calls each; S1 of 5)", flush=True)
    with torch.no_grad():
        # the whole calls first: a profiled window loses device events late
        # in a long run, after windows of many small ops (module docstring)
        for label in ("O1 headline 4096², overlap_k at highest",
                      "O2 Gaussian twice per axis 4096² (Ka = Kb = 12), "
                      "overlap_k at px6",
                      "P1 headline 4096², compute_locally (pallas)",
                      "P3 256³, pallas", "B1 headline 1024², blocked"):
            mod, x = bcases[label]
            whole_call(label[:2], mod, x, x.numel(), top=True)
        # the core issues one launch per tap and step (16,384 at 1024² for
        # four order-3 scans): five calls, no profile
        mod, x = bcases["S1 headline 1024², scan"]
        ms = statistics.median(timing.call_times_ms(mod, x, iterations=5,
                                                    warmup=1))
        print(f"  S1 whole call: event median of 5 calls {ms:.4f} ms "
              f"({timing.mpix_per_sec(ms, x.numel()):.1f} M/s) on {card}")
        mod, x = bcases["O1 headline 4096², overlap_k at highest"]
        fk, swapped = pair_of(mod)
        X4 = fk.tile(x.t() if swapped else x)
        NA_k, NB_k = fk.carries(X4, fk.moments.plain)
        bA_k, U_k = fk.moments(X4)
        Y_k = fk.final(X4, NA_k, NB_k)
        px = X4.numel()
        Ka, Kb, Ta = fk.Ka, fk.Kb, fk.Ta
        mom, fin = fk.moments, fk.final
        r = timed("O1 moments2d_k", mom, mom.plain, None, (X4,),
                  tensor_bytes(X4, bA_k, U_k, mom.Ga_v, mom.Gb_v),
                  2.0 * (Ka + Kb) * px, PEAK_FP64,
                  main_launches["moments2d_k"])
        times["moments2d_k"], dev_t["moments2d_k"] = r[0], r[1]
        extra["moments2d_k"] = (*r[2], r[3])
        r = timed("O1 final2d_k", fin, fin.plain, None, (X4, NA_k, NB_k),
                  tensor_bytes(X4, NA_k, NB_k, Y_k, fin.A1_v, fin.B2_v),
                  2.0 * (Ta + Ka + 128 + Kb) * px, PEAK_FP32,
                  main_launches["final2d_k"])
        times["final2d_k"], dev_t["final2d_k"] = r[0], r[1]
        extra["final2d_k"] = (*r[2], r[3])
        del X4, NA_k, NB_k, bA_k, U_k, Y_k
        mod, v = bcases["P1 headline 4096², compute_locally (pallas)"]
        for st, name in zip(mod.stages, ("dim_pass_rows", "dim_pass_cols")):
            X = st.kernel_input(v)
            Y = st.body(X)
            body = st.body
            t = paired_times(body, body.plain, X)
            # the twin's tile loop is ~500 small ops a call: CUDA events of
            # 10 back-to-back calls, not a profiled window
            d = (device_ms(body, X),
                 timing.benchmark(body.plain, X, iterations=10) / 10, None)
            bound, by = roofline(tensor_bytes(X, Y, body.ops),
                                 sum(2.0 * (body.T + body.K) * X.numel()
                                     for _ in body.causal), PEAK_FP64)
            print(f"  P1 {name} {tuple(X.shape)}: "
                  f"{main_launches[name]} launch(es) per call; event "
                  f"{t[0]:.4f} ms, device {d[0]:.4f} ms; bound {bound:.4f} "
                  f"ms by {by} ({100 * bound / d[0]:.1f} % of the device "
                  f"time); twin event {t[1]:.4f}, 10 back-to-back "
                  f"{d[1]:.4f} ms; library none on {card}")
            times[name], dev_t[name] = t, d
            extra[name] = (bound, by, None)
            v = st(v)
        del X, Y, v
        # the strip kernels' lines per block: every block that fits, at
        # P1's, P2's and P3's passes, beside pick_line_block's choice
        line_block_sweep(rft, dev, card)

    print("== phase 5i: the unsharp mask's calls and the affine epilogue "
          f"entries (CUDA events, median of {4 * N_TIMED // 2} calls each)",
          flush=True)
    with torch.no_grad():
        whole_call("U1 unsharp_mask merged 4096²", u1, x_u, H * W, top=True)
        whole_call("U2 unsharp_mask naive 4096²", u2, x_u, H * W, top=True)
        t12 = paired_times(u1, u2, x_u)  # in turns: U2, U1, U1, U2
        print(f"  U1 against U2 in turns: event {t12[0]:.4f} against "
              f"{t12[1]:.4f} ms on {card}")
        fu = u1.stages[0]
        X4 = fu.tile(x_u)
        NA, NB = fu.carries(X4)
        fin = fu.final
        ops_2d = 2.0 * (2 * 128 + fu.Ka + fu.Kb) * X4.numel()
        r = timed("U1 final2d_epi (k = 1: the combine, the image its aux)",
                  fin, fin.plain, None, (X4, NA, NB, X4),
                  tensor_bytes(X4, NA, NB, X4, X4, fin.A1_v, fin.B2_v,
                               fin.epi_coef),
                  ops_2d + 4.0 * X4.numel(), PEAK_FP32,
                  main_launches["final2d_epi"])
        times["final2d_epi"], dev_t["final2d_epi"] = r[0], r[1]
        extra["final2d_epi"] = (*r[2], r[3])
        # the same work unfused: final2d (no epilogue, the same clamp
        # filter's matrices), then the combine as torch ops
        fin0 = modules["4096x4096 clamp"][1].final

        def unfused(x_, na_, nb_, aux_):
            return fu.epilogue(fin0(x_, na_, nb_), aux_)

        check(rel_err(unfused(X4, NA, NB, X4), fin(X4, NA, NB, X4)) <= 1e-5,
              "U1: final2d then the combine computes final2d_epi's function")
        print(f"  U1 final2d then the combine as torch ops: event "
              f"{median_ms(unfused, X4, NA, NB, X4):.4f} ms, device "
              f"{device_ms(unfused, X4, NA, NB, X4):.4f} ms; final2d alone: "
              f"event {median_ms(fin0, X4, NA, NB):.4f} ms, device "
              f"{device_ms(fin0, X4, NA, NB):.4f} ms on {card}")
        del X4, NA, NB
        for name, label, k_launch in (
                ("completion_epi", "A's kernel pass, the mix", 
                 main_launches["completion_epi"]),
                ("completion_rot_epi", "C1's x pass, 3-tap stencil, a - o",
                 main_launches["completion_rot_epi"])):
            comp, args = epi_in[name]
            X, Nt = args[0], args[1]
            out = comp(*args)
            lib = None
            if name == "completion_epi":
                # one PyTorch call: addmm of [x, Nᵀ]·[Btotᵀ; Rᵀ] scaled by
                # the mix's a, plus b·x (A's tiles share one variant), on
                # the operand phase 5b's matmul takes
                check(comp.BR_v.shape[0] == 1 and comp.k == 1,
                      "A: one matrix variant, one aux")
                a_, (b_,) = comp.affine.scale, comp.affine.aux_weights
                XN = torch.cat([X, Nt.permute(2, 0, 1)], dim=2).reshape(
                    -1, 128 + comp.sl)
                BR0 = comp.BR_v[0]

                def lib(x_, n_, aux_):
                    return torch.addmm(aux_.reshape(-1, 128), XN, BR0,
                                       beta=b_, alpha=a_)

                err = rel_err(lib(*args).reshape(out.shape), out)
                print(f"  completion_epi: addmm against the kernel, "
                      f"max|l-k|/max|k| = {err:.3e}")
                check(err <= 1e-5, "A: addmm computes completion_epi's "
                      "function")
            r = timed(f"{name} at {label} {tuple(X.shape)}", comp,
                      comp.plain, lib, args,
                      tensor_bytes(*args, out, comp.BR_v, comp.epi_coef),
                      2.0 * (128 + comp.sl + len(comp.taps) + comp.k + 1)
                      * X.numel(), PEAK_FP32, k_launch)
            times[name], dev_t[name] = r[0], r[1]
            extra[name] = (*r[2], r[3])
        del epi_in, out, args, XN, BR0

    print("== phase 5h: tails_traced and completion_traced at L1's x-axis "
          "shapes, the learnable calls and L2's training step (CUDA events, "
          f"median of {4 * N_TIMED // 2} calls each)", flush=True)
    with torch.no_grad():
        X, Gcat, Btot32, Rcat32, Nt8 = traced_in
        q, n, S = X.shape[0], X.shape[1], Gcat.shape[0]
        bk = kcomp.tails_traced(X, Gcat)
        yk = kcomp.completion_traced(X, Btot32, Rcat32, Nt8)
        # one torch.matmul each: x (q·n, 128) by Gᵀ, and [x, Nᵀ] by
        # [Btotᵀ; Rcatᵀ] (both operands staged outside the timed call)
        XN = torch.cat([X, Nt8[:, :S].permute(2, 0, 1)], dim=2)
        BR = torch.cat([Btot32.t(), Rcat32.t()])
        check(rel_err(torch.matmul(X.reshape(-1, 128), Gcat.t()).reshape(
            q, n, S).permute(1, 2, 0), bk[:, :S]) <= 1e-5
            and rel_err(torch.matmul(XN, BR), yk) <= 1e-5,
            "L1: the library calls compute the traced kernels' functions")
        r = timed("L1 x tails_traced", kcomp.tails_traced,
                  kcomp.tails_traced_plain,
                  lambda v, g: torch.matmul(v.reshape(-1, 128), g.t()),
                  (X, Gcat), tensor_bytes(X, Gcat, bk), 2.0 * S * X.numel(),
                  PEAK_FP64, main_launches["tails_traced"])
        times["tails_traced"], dev_t["tails_traced"] = r[0], r[1]
        extra["tails_traced"] = (*r[2], r[3])
        r = timed("L1 x completion_traced", kcomp.completion_traced,
                  kcomp.completion_traced_plain,
                  lambda *a: torch.matmul(XN, BR), (X, Btot32, Rcat32, Nt8),
                  tensor_bytes(X, Btot32, Rcat32, Nt8, yk),
                  2.0 * (128 + S) * X.numel(), PEAK_FP32,
                  main_launches["completion_traced"])
        times["completion_traced"], dev_t["completion_traced"] = r[0], r[1]
        extra["completion_traced"] = (*r[2], r[3])
        del bk, yk, XN, BR, traced_in, X, Nt8
        whole_call("L1 LearnableRecFilter forward 4096²", l1, x_l1, H * W,
                   top=True)
        whole_call("L3 biquad forward 8 x 65,536", l3, x_l3, x_l3.numel(),
                   top=True)
    step = trainer(l2, y_l1, 2e-3)
    step_ms = statistics.median(timing.call_times_ms(step, x_l1,
                                                     iterations=10, warmup=2))
    prof = timing.device_profile(step, x_l1, iterations=5)
    print(f"  L2 training step (forward, backward, Adam) at 4096²: event "
          f"median {step_ms:.4f} ms; profile: call {prof['call_ms']:.4f} ms, "
          f"device busy {busy_text(prof)}, {prof['device_ops']:.0f} device "
          f"ops per step on {card}; top: " + ", ".join(
              f"{nm[:40]} {ms:.4f} ms" for nm, ms in prof["top"]))

    # the cross-tile solve on each side of the branch point (128 tiles)
    from recfilter_tpu_torch import learnable as tlrn

    # (a step's time does not depend on its rate: a small one keeps the
    # filter stable while Adam follows the near-zero gradients of a fit to
    # its own output)
    with torch.no_grad():
        step3 = trainer(l3, l3(x_l3), 2e-4)
    solve_branches(tlrn, "L1/L2", l1, x_l1, step, card)
    solve_branches(tlrn, "L3", l3, x_l3, step3, card)

    for name, r in carry_times.items():
        times[name], dev_t[name], extra[name] = r[0], r[1], (*r[2], r[3])
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"recfilter_tpu_torch/kernels/csrc/{src or name}.cu",
         "replaces": replaces, "launches": main_launches[name],
         "max_abs_err": max_abs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": extra[name][0],
         "bound_by": extra[name][1], "library_ms": extra[name][2]}
        for name, src, replaces in (
            ("moments2d", None, "recfilter_tpu/kernels/final2d.py:409"),
            ("final2d", None, "recfilter_tpu/kernels/final2d.py:853"),
            ("tails", None, "recfilter_tpu/kernels/completion.py:750"),
            ("completion", None, "recfilter_tpu/kernels/completion.py:464"),
            ("rows_tails", None, "recfilter_tpu/kernels/final2d.py:1185"),
            ("rows_final", None, "recfilter_tpu/kernels/final2d.py:1251"),
            ("fir_band", None, "recfilter_tpu/kernels/fir_band.py:222"),
            ("int_scan", None, "recfilter_tpu/kernels/int_scan.py:384"),
            ("int_seg_scan", None, "recfilter_tpu/kernels/int_scan.py:225"),
            ("final2d_stencil", None,
             "recfilter_tpu/kernels/final2d.py:999"),
            ("tails_extra", "tails", "recfilter_tpu/kernels/completion.py:750"),
            ("completion_rot", "completion",
             "recfilter_tpu/kernels/completion.py:464"),
            ("completion_rot_tails", "completion",
             "recfilter_tpu/kernels/completion.py:464"),
            ("tails_traced", "tails",
             "recfilter_tpu/kernels/completion.py:823"),
            ("completion_traced", "completion",
             "recfilter_tpu/kernels/completion.py:881"),
            ("stencil2d", None, "recfilter_tpu/kernels/stencil2d.py:109"),
            ("final2d_epi", "final2d",
             "recfilter_tpu/kernels/final2d.py:619"),
            ("completion_epi", "completion",
             "recfilter_tpu/kernels/completion.py:273"),
            ("completion_rot_epi", "completion",
             "recfilter_tpu/kernels/completion.py:273"),
            ("moments2d_k", "moments2d",
             "recfilter_tpu/kernels/final2d.py:1323"),
            ("final2d_k", "final2d", "recfilter_tpu/kernels/final2d.py:72"),
            ("dim_pass_rows", "fused", "recfilter_tpu/kernels/fused.py:230"),
            ("dim_pass_cols", "fused", "recfilter_tpu/kernels/fused.py:261"),
            ("bsolve", None, "recfilter_tpu/kernels/final2d.py:1412"),
            ("moments2d_naf", "moments2d",
             "recfilter_tpu/kernels/final2d.py:495"),
            ("copy", None, "bench.py:161"))
    ]
    print("== summary: each kernel at its main-path shape — CUDA-event "
          "median of single calls, and device time from the profiler",
          flush=True)
    for k in kernels:
        d_k, d_p, d_l = dev_t[k["name"]]
        print(f"  {k['name']}: event {k['ms']:.4f} ms, device {d_k:.4f} ms;"
              f" bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({100 * k['bound_ms'] / k['ms']:.1f} % of the event time, "
              f"{100 * k['bound_ms'] / d_k:.1f} % of the device time); "
              f"twin event {k['plain_ms']:.4f}, device {d_p:.4f} ms; library "
              + ("none" if k["library_ms"] is None else
                 f"event {k['library_ms']:.4f}, device {d_l:.4f} ms"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
