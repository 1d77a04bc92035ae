"""The port's epilogue structure reader (``recfilter_tpu_torch.epilogue``):
which epilogues are affine, by their ``torch.fx`` graph alone, and which
are elementwise — the latter held to the JAX package's ``_is_elementwise``
verdicts on the same callables (``tests/test_api.py:495-602``'s cases).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import api as japi
from recfilter_tpu.spec import Dim as JDim
from recfilter_tpu.spec import FilterSpec as JSpec

from recfilter_tpu_torch.epilogue import (MAX_AUX, Affine, affine_form,
                                          arity, is_elementwise)

W = np.float64(0.25)
SCALE = torch.tensor(3.0)      # a captured one-element tensor
FULL = torch.ones(64, 64)      # a captured full-size tensor



def usm_default_weight(blur, img, w=0.5):
    """A weight passed by default: it folds as a constant."""
    return (1 + w) * img - w * blur


# name: (epilogue, its Affine)
AFFINE = {
    "usm-default-weight": (usm_default_weight, Affine(-0.5, (1.5,), 0.0)),
    "usm": (lambda blur, image: (1.0 + 1.0) * image - 1.0 * blur,
            Affine(-1.0, (2.0,), 0.0)),
    "usm-numpy-weight": (lambda blur, image: (1 + W) * image - W * blur,
                         Affine(-0.25, (1.25,), 0.0)),
    "2u-3v": (lambda u, v: 2.0 * u - 3.0 * v, Affine(2.0, (-3.0,), 0.0)),
    "x/4+1": (lambda x: x / 4 + 1, Affine(0.25, (), 1.0)),
    "numpy-scalars": (lambda u, v: np.float32(0.5) * u + v * np.float64(2),
                      Affine(0.5, (2.0,), 0.0)),
    "-o": (lambda o: -o, Affine(-1.0, (), 0.0)),
    "torch-ops": (lambda u, v: torch.sub(torch.mul(u, 2), v.div(4)),
                  Affine(2.0, (-0.25,), 0.0)),
    "nested": (lambda y, a, b: 1 - (y - 2 * (a + b / 2)),
               Affine(-1.0, (2.0, 1.0), 1.0)),
    "four-aux": (lambda y, a, b, c, d: y + a - b + 2 * c - d / 2,
                 Affine(1.0, (1.0, -1.0, 2.0, -0.5), 0.0)),
}

# name: epilogue whose structure is not affine
NOT_AFFINE = {
    "u*v": lambda u, v: u * v,
    "clamp": lambda u, v: torch.clamp(2 * u - 3 * v, -50, 50),
    "where": lambda u: torch.where(u > 0, u, -u),
    "tensor-closure": lambda u: SCALE * u,
    "comparison": lambda u: u > 0.1,
    "cast": lambda u: u.to(torch.float64),
    "abs": lambda u: u.abs(),
    "division-by-input": lambda u, v: u / v,
    "variadic": lambda *a: a[0],
}


@pytest.mark.parametrize("name", list(AFFINE))
def test_affine_forms(name):
    """The form read from the graph, and its torch twin equal to the
    epilogue on random float64 tensors."""
    fn, want = AFFINE[name]
    got = affine_form(fn)
    assert got == want
    rng = np.random.default_rng(len(name))
    ins = [torch.from_numpy(rng.standard_normal((3, 5)))
           for _ in range(1 + got.k)]
    torch.testing.assert_close(got.apply(ins[0], ins[1:]), fn(*ins),
                               rtol=1e-12, atol=1e-12)
    coef = got.coefficients()
    assert coef.dtype == torch.float32 and coef.shape == (2 + MAX_AUX,)
    assert coef[:2].tolist() == [got.scale, got.bias]


@pytest.mark.parametrize("name", list(NOT_AFFINE))
def test_not_affine(name):
    assert affine_form(NOT_AFFINE[name]) is None


def test_a_failing_trace_is_not_affine_nor_elementwise():
    """Control flow on values cannot be traced: None and False, not an
    exception."""
    def branchy(y):
        return y if y.sum() > 0 else -y

    assert affine_form(branchy) is None
    assert not is_elementwise(branchy, (8, 8), torch.float32, 0)


def test_arity_and_an_explicit_input_count():
    assert arity(lambda y, a, b: y) == 3
    assert arity(lambda *a: a[0]) is None
    assert arity(usm_default_weight) == 2  # w has a default
    # the count given must match the graph's inputs
    assert affine_form(lambda u, v: u - v, 3) is None
    assert affine_form(lambda u, v: u - v, 2) == Affine(1.0, (-1.0,), 0.0)


# name: (JAX callable, torch callable, aux count) — the same consumer
# written for each package
ELEMENTWISE = {
    "usm-combine": (lambda b, i: 2.0 * i - 1.0 * b,) * 2 + (1,),
    "usm-default-weight": (usm_default_weight,) * 2 + (1,),
    "scale": (lambda b: 2.0 * b,) * 2 + (0,),
    "square": (lambda b: b * b,) * 2 + (0,),
    "transpose": (lambda b: b.T,) * 2 + (0,),
    "comparison": (lambda b: b > 0.1,) * 2 + (0,),
    "cast": (lambda b: b.astype(jnp.bfloat16),
             lambda b: b.to(torch.bfloat16), 0),
    "exp": (lambda b: jnp.exp(b), lambda b: torch.exp(b), 0),
    "sum": (lambda b: b.sum(),) * 2 + (0,),
    "scalar-closure": (lambda b: jnp.float32(3.0) * b,
                       lambda b: SCALE * b, 0),
}


@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_is_elementwise_agrees_with_jax(name):
    jfn, tfn, n_aux = ELEMENTWISE[name]
    js = JSpec("E", (JDim("y", 64), JDim("x", 64)), (), dtype="float32")
    want = japi._is_elementwise(jfn, js, n_aux)
    assert is_elementwise(tfn, (64, 64), torch.float32, n_aux) == want


def test_clamp_and_where_are_elementwise():
    """``torch.clamp`` and ``torch.where`` are elementwise and keep the
    dtype. (The JAX reader says False for ``jnp.clip`` and ``jnp.where``:
    their jaxprs wrap the elementwise primitives in a nested ``jit``
    equation, a primitive name its list does not hold.)"""
    for fn in (lambda b: torch.clamp(b, -50, 50),
               lambda b: torch.where(b > 0, b, -b)):
        assert is_elementwise(fn, (64, 64), torch.float32, 0)


def test_a_full_size_closure_is_not_elementwise():
    """A captured tensor of the image's size does not broadcast against
    the executors' tiled layouts: only one-element captures pass."""
    assert not is_elementwise(lambda b: FULL * b, (64, 64), torch.float32,
                              0)


# ------------------------------------------- the routes on the executors


def _gauss_spec(mod, dims, axes, times=1, border="zero"):
    w3 = tuple(mod.gaussian_weights(5.0, 3))
    scans = [mod.Scan(ax, c, w3[0], w3[1:]) for ax in axes
             for _ in range(times) for c in (True, False)]
    return mod.FilterSpec("G", tuple(mod.Dim(n, e) for n, e in dims),
                          tuple(scans), border=border,
                          tile_widths=tuple(128 for _ in dims))


# epi: (epilogue, route of it)
EPIS = {
    "affine": (lambda b, i: 2.0 * i - b, "kernel"),
    "default-weight": (lambda b, i, w=1.0: (1 + w) * i - w * b, "kernel"),
    "clamp": (lambda b, i: torch.clamp(2.0 * i - b, -0.05, 0.05), "torch"),
}
JCLIP = lambda b, i: jnp.clip(2.0 * i - b, -0.05, 0.05)  # noqa: E731

# name: (dims, scanned axes, times per axis, module type)
ROUTES = {
    "2-D 3-touch": ([("y", 256), ("x", 256)], (0, 1), 1, "Fused2DPx"),
    "last axis, 16 lines": ([("c", 16), ("x", 1024)], (1,), 1,
                            "FusedLastAxis"),
    "rotation chain, ΣK = 12": ([("y", 256), ("x", 256)], (1, 0), 2,
                                "RotationChain"),
}


@pytest.mark.parametrize("epi", list(EPIS))
@pytest.mark.parametrize("case", list(ROUTES))
def test_epilogue_routes_match_jax(case, epi):
    """An affine epilogue rides the final completion kernel (its twin on
    the CPU), a clamp runs as torch ops; both within 1e-5 of the peak of
    the JAX package's ``apply_filter_fused(epilogue=)`` and within 2e-6
    of the f64 oracle's combine."""
    from recfilter_tpu import dimfuse as jdf
    from recfilter_tpu import scan_core as jsc
    import recfilter_tpu as jrf

    import recfilter_tpu_torch as rft
    from recfilter_tpu_torch import dimfuse as tdf

    dims, axes, times, kind = ROUTES[case]
    ts = _gauss_spec(rft, dims, axes, times)
    js = _gauss_spec(jrf, dims, axes, times)
    fn, route = EPIS[epi]
    mod = tdf.fused_filter_module(ts, epilogue=fn)
    assert type(mod).__name__ == kind
    x = (np.random.default_rng(len(case)).standard_normal(
        [e for _, e in dims]) * 0.01).astype(np.float32)
    got = mod(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    last = {"Fused2DPx": mod, "FusedLastAxis": getattr(mod, "body", None),
            "RotationChain": mod.passes[-1] if kind == "RotationChain"
            else None}[kind]
    assert last.epilogue_route == route
    blur = jsc.oracle_apply(js, x.astype(np.float64))
    want = 2.0 * x - blur
    if epi == "clamp":
        want = np.clip(want, -0.05, 0.05)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * peak
    jfn = JCLIP if epi == "clamp" else (lambda b, i: 2.0 * i - b)
    jgot = np.asarray(jdf.apply_filter_fused(
        js, jnp.asarray(x), matmul_precision="px6", epilogue=jfn,
        eaux=(jnp.asarray(x),)))
    assert np.abs(got - jgot).max() <= 1e-5 * peak
