"""Reading an epilogue's structure from its ``torch.fx`` graph.

An epilogue ``fn(y, *aux)`` is a pointwise consumer of a filter's output
(the unsharp mask's ``(1 + w)·image − w·blur``, a dry/wet mix, a DoG-style
difference of Tuple components). Two readers decide what the port does
with one, both by the structure of the graph that
``torch.fx.symbolic_trace`` records, never by evaluating ``fn`` on numbers:

  * :func:`affine_form` — ``Affine(scale, aux_weights, bias)`` when ``fn``
    is built only from its inputs, real constants (Python or numpy
    scalars) and ``+ − × ÷``, unary ``−``/``+`` (``operator`` and their
    ``torch.*``/``Tensor.*`` twins), every product and quotient having a
    constant on one side; else None. The completion kernels apply such a
    form in their store loop, ``a·y + Σᵢ bᵢ·auxᵢ + c``, and a Tuple filter
    folds a bias-free one into its input (one channel filtered instead of
    k). A tensor captured by the closure (a ``get_attr`` node), a
    ``clamp``, ``where``, comparison or cast, or a trace that raises,
    gives None: the epilogue then runs as torch ops after the kernel.
  * :func:`is_elementwise` — ``compute_at``'s test (the JAX package's
    ``api._is_elementwise``): every node is an elementwise operation,
    captured tensors hold one element, and on ``meta`` tensors of the
    filter's shape and dtype the output keeps both.

The JAX package tells a linear Tuple combine by probing it on small random
draws (``api._tuple_linear_coeffs``); a clip at ±50 passes that probe and
is folded, wrongly. Here a clip is a ``clamp`` node, so it is not affine.
"""

from __future__ import annotations

import dataclasses
import inspect
import numbers
import operator
from typing import Optional, Tuple

import numpy as np
import torch
import torch.fx as fx

from .kernels.launch import MAX_AUX


@dataclasses.dataclass(frozen=True)
class Affine:
    """``scale·y + Σᵢ aux_weights[i]·aux[i] + bias``."""

    scale: float
    aux_weights: Tuple[float, ...]
    bias: float

    @property
    def k(self) -> int:
        return len(self.aux_weights)

    def coefficients(self) -> torch.Tensor:
        """The kernels' float32 operand: [a, c, b₀, …, b₃] (zeros past k)."""
        b = list(self.aux_weights) + [0.0] * (MAX_AUX - self.k)
        return torch.tensor([self.scale, self.bias, *b], dtype=torch.float32)

    def apply(self, y: torch.Tensor, aux) -> torch.Tensor:
        """The form as torch ops (the kernels' plain twin)."""
        out = self.scale * y
        for b, a in zip(self.aux_weights, aux):
            out = out + b * a
        return out + self.bias if self.bias else out


class _Proxy(fx.Proxy):
    # numpy scalars defer to the proxy (``np.float64(0.5) * y``)
    __array_ufunc__ = None


class _Tracer(fx.Tracer):
    def proxy(self, node):
        return _Proxy(node, self)

    def create_arg(self, a):
        if isinstance(a, np.generic) and isinstance(a, numbers.Real):
            a = a.item()
        return super().create_arg(a)


def _trace(fn, n_in: int) -> Optional[fx.GraphModule]:
    """``fn``'s graph as called with ``n_in`` positional tensors: its
    defaulted parameters (``def combine(blur, img, w=1.0)``) keep their
    defaults and fold as constants."""
    names = ", ".join(f"x{i}" for i in range(n_in))
    call = eval(f"lambda {names}: fn({names})", {"fn": fn})  # noqa: S307
    tracer = _Tracer()
    try:
        graph = tracer.trace(call)
        return fx.GraphModule(tracer.root, graph)
    except Exception:
        return None


def arity(fn) -> Optional[int]:
    """The positional parameters of ``fn`` without a default (the filter
    output and its aux arrays), or None for a variadic or unreadable
    signature."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    n = 0
    for p in params:
        if p.kind == p.VAR_POSITIONAL:
            return None
        if (p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty):
            n += 1
    return n


_AFFINE_FUNCS = {
    operator.add: "add", torch.add: "add",
    operator.sub: "sub", torch.sub: "sub", torch.subtract: "sub",
    operator.mul: "mul", torch.mul: "mul", torch.multiply: "mul",
    operator.truediv: "div", torch.div: "div", torch.divide: "div",
    torch.true_divide: "div",
    operator.neg: "neg", torch.neg: "neg", torch.negative: "neg",
    operator.pos: "pos", torch.positive: "pos",
}
_AFFINE_METHODS = {
    "add": "add", "sub": "sub", "subtract": "sub", "mul": "mul",
    "multiply": "mul", "div": "div", "divide": "div", "true_divide": "div",
    "neg": "neg", "negative": "neg", "positive": "pos",
}


def _const(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def _combine(op: str, a, b, n_in: int):
    """One operation on values that are constants (floats) or linear forms
    (numpy vectors: one coefficient per input, then the bias); None where
    the result is not affine."""
    ca, cb = not isinstance(a, np.ndarray), not isinstance(b, np.ndarray)
    if op in ("add", "sub"):
        if not (ca and cb):  # a constant enters a form as its bias
            a, b = (_lift(v, n_in) for v in (a, b))
        return a + b if op == "add" else a - b
    if op == "mul":
        return a * b if (ca or cb) else None
    if op == "div":
        return a / b if cb and b != 0 else None
    raise AssertionError(op)


def _lift(v, n_in: int) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    out = np.zeros(n_in + 1)
    out[n_in] = v
    return out


def affine_form(fn, n_in: Optional[int] = None) -> Optional[Affine]:
    """``Affine(scale, aux_weights, bias)`` of ``fn(y, *aux)`` with
    ``n_in`` inputs (its positional arity when not given), read from its
    ``torch.fx`` graph, or None where ``fn`` is not affine by its
    structure (module docstring)."""
    n_in = arity(fn) if n_in is None else n_in
    if not n_in:
        return None
    gm = _trace(fn, n_in)
    if gm is None:
        return None
    vals, placeholders = {}, 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            v = np.zeros(n_in + 1)
            v[placeholders] = 1.0
            vals[node], placeholders = v, placeholders + 1
            continue
        if node.op == "output":
            out = node.args[0]
            if not isinstance(out, fx.Node):
                return None
            v = vals[out]
            if not isinstance(v, np.ndarray):
                return None
            return Affine(float(v[0]), tuple(float(c) for c in
                                             v[1:n_in]), float(v[n_in]))
        if node.op == "call_function":
            op = _AFFINE_FUNCS.get(node.target)
        elif node.op == "call_method":
            op = _AFFINE_METHODS.get(node.target)
        else:
            return None  # get_attr (a captured tensor), call_module
        if op is None or node.kwargs:
            return None
        args = []
        for a in node.args:
            if isinstance(a, fx.Node):
                args.append(vals[a])
            elif _const(a):
                args.append(float(a))
            else:
                return None
        if op in ("neg", "pos"):
            if len(args) != 1:
                return None
            vals[node] = -args[0] if op == "neg" else args[0]
            continue
        if len(args) != 2:
            return None
        v = _combine(op, *args, n_in)
        if v is None:
            return None
        vals[node] = v
    return None


def kernel_form(fn) -> Optional[Affine]:
    """The :class:`Affine` form the kernels' epilogue takes for ``fn(y,
    *aux)`` (at most :data:`MAX_AUX` aux arrays), or None: ``fn`` then
    runs as torch ops."""
    form = None if fn is None else affine_form(fn)
    return form if form is not None and form.k <= MAX_AUX else None


# the JAX package's _ELEMENTWISE_PRIMS, as torch callables and methods
_ELEMENTWISE_FUNCS = {
    operator.add, operator.sub, operator.mul, operator.truediv,
    operator.floordiv, operator.mod, operator.pow, operator.neg,
    operator.pos, operator.abs, operator.invert, operator.and_,
    operator.or_, operator.xor, operator.eq, operator.ne, operator.lt,
    operator.le, operator.gt, operator.ge,
    torch.add, torch.sub, torch.subtract, torch.mul, torch.multiply,
    torch.div, torch.divide, torch.true_divide, torch.neg, torch.negative,
    torch.positive, torch.abs, torch.sign, torch.maximum, torch.minimum,
    torch.pow, torch.exp, torch.log, torch.log1p, torch.expm1, torch.tanh,
    torch.sqrt, torch.rsqrt, torch.square, torch.sigmoid, torch.erf,
    torch.sin, torch.cos, torch.floor, torch.ceil, torch.round,
    torch.clamp, torch.clip, torch.where, torch.eq, torch.ne, torch.ge,
    torch.gt, torch.le, torch.lt, torch.isfinite, torch.logical_and,
    torch.logical_or, torch.logical_xor, torch.logical_not,
    torch.bitwise_and, torch.bitwise_or, torch.bitwise_xor,
    torch.bitwise_not, torch.nn.functional.sigmoid,
}
_ELEMENTWISE_METHODS = {
    "add", "sub", "subtract", "mul", "multiply", "div", "divide",
    "true_divide", "neg", "negative", "abs", "sign", "maximum", "minimum",
    "pow", "exp", "log", "log1p", "expm1", "tanh", "sqrt", "rsqrt",
    "square", "sigmoid", "erf", "sin", "cos", "floor", "ceil", "round",
    "clamp", "clip", "eq", "ne", "ge", "gt", "le", "lt", "isfinite",
    "logical_and", "logical_or", "logical_xor", "logical_not", "to",
    "type", "float", "double", "half", "bfloat16", "int", "long", "bool",
    "detach", "clone",
}


def is_elementwise(fn, shape, dtype, n_aux: int) -> bool:
    """True when ``fn(out, *aux)`` is provably elementwise work on arrays
    of ``shape`` and ``dtype``: every node of its graph is an elementwise
    operation, a captured tensor holds one element (a scalar broadcast),
    and on ``meta`` tensors the output is one tensor of the same shape and
    dtype (a comparison or cast changes the dtype: the fused executor
    emits in the filter's)."""
    gm = _trace(fn, 1 + n_aux)
    if gm is None:
        return False
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            t = getattr(gm, node.target, None)
            if not isinstance(t, torch.Tensor) or t.numel() != 1:
                return False
        elif node.op == "call_function":
            if node.target not in _ELEMENTWISE_FUNCS:
                return False
        elif node.op == "call_method":
            if node.target not in _ELEMENTWISE_METHODS:
                return False
        elif node.op not in ("placeholder", "output"):
            return False
    try:
        metas = [torch.empty(tuple(shape), dtype=dtype, device="meta")
                 for _ in range(1 + n_aux)]
        out = gm(*metas)
    except Exception:
        return False
    return (isinstance(out, torch.Tensor) and tuple(out.shape) == tuple(shape)
            and out.dtype == dtype)
