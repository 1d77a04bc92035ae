"""The split-bf16 chunk algebra of the reduced precision grades.

The JAX package's px kernels reach a float32 grade on the TPU's bf16 matrix
unit by splitting each float32 operand into bf16 chunks and summing chunk
products in float32 (``recfilter_tpu/kernels/completion.py:62-160``). A
grade is a product count ``nprod``:

  * ``default`` — 1 product, one chunk a side (the throughput mode);
    in the port only on the image rows of a contraction (below);
  * ``px3`` — 3 products of 2 chunks: (0,1), (1,0), (0,0);
  * ``px4`` — 4 products of 2 chunks: (1,1), (0,1), (1,0), (0,0);
  * ``px6`` — 6 products of 3 chunks (3 chunks carry the whole float32
    mantissa).

A pair (i, j) multiplies chunk i of the constant by chunk j of the data;
:func:`prods` lists them smallest magnitude first, the order every kernel
sums them in.

Every split contraction of the port is [image rows | carry rows]: 128
samples of a tile, then its carries (the 8 slots of ``final2d_split`` and
``rows_final``, the sl slots of ``completion_split``). The carry rows take
:func:`carry_nprod` products — never fewer than 3 — because their terms
cancel: the carry matrices' columns are large and alternate in sign, so
one bf16 product loses 2^-9 of terms far larger than the result. With one
product on the carries too (the JAX package's ``default``) the 4096²
headline Gaussian lands past the grade's 3e-2 bound of the f64 oracle's
peak; with three, well inside it (``tests/torch_split_study.py`` measures
both). The carry rows are 8 of 136 (at most 56 of 184), so the extra
products cost little.

On the card the split grades run on bf16 tensor cores (``csrc/split.cuh``'s
``mma.sync`` for ``final2d_split``; ``csrc/wgmma.cuh``'s core, templated
on the product count, for ``completion_split``, ``rows_final`` and the
rotated completions, as for the px6 completions' six products):
a bf16 product is exact in float32, so each chunk product accumulates in
float32 as on the TPU. The twins here upcast the bf16 chunks to float32 and
take float32 products, the same arithmetic in another summation order.

Constants split from float64 exactly as the JAX package splits them
(``_split_const_np``): to float32, then to bfloat16, each step rounding to
nearest even, the residual taken in float64. Data splits in float32
(``_split_vmem``): each residual subtraction is exact, so three chunks
rebuild a float32 value bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# The port's grades and their product counts: the JAX package's
# ``dimfuse._kernel_nprod`` for float32 storage. At ``default`` its
# ``structural=False`` gives 0 (the einsum pass) where a kernel brings no
# structural win: ``dimfuse.LastAxisPass`` applies that rule to the rotated
# passes; the other routes take one product.
NPROD = {"default": 1, "px3": 3, "px4": 4, "px6": 6}


def prods(nprod: int) -> List[Tuple[int, int]]:
    """(constant chunk, data chunk) pairs of ``nprod`` products, smallest
    magnitude first (``completion._prods``)."""
    if nprod >= 6:
        return [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
    if nprod >= 4:
        return [(1, 1), (0, 1), (1, 0), (0, 0)]
    if nprod >= 3:
        return [(0, 1), (1, 0), (0, 0)]
    return [(0, 0)]


def nchunks(nprod: int) -> int:
    """Chunks per operand for ``nprod`` products."""
    return 3 if nprod >= 6 else (2 if nprod >= 3 else 1)


def carry_nprod(nprod: int) -> int:
    """Products on a contraction's carry rows at grade ``nprod``: at least
    3 (module docstring)."""
    return max(nprod, 3)


def level_groups(nprod: int) -> List[List[Tuple[int, int]]]:
    """:func:`prods` grouped by level i + j, smallest magnitude first."""
    pairs = prods(nprod)
    return [[(i, j) for i, j in pairs if i + j == lvl]
            for lvl in sorted({i + j for i, j in pairs}, reverse=True)]


def split_const(M, n: int) -> List[torch.Tensor]:
    """``n`` bf16 chunks of the float64 array ``M`` (CPU tensors): each
    chunk the float32-then-bfloat16 rounding of what the earlier ones left,
    the residual in float64 — the JAX package's ``_split_const_np``."""
    rem = np.asarray(M, np.float64)
    out = []
    for _ in range(n):
        c = torch.from_numpy(np.ascontiguousarray(rem, np.float32)).to(
            torch.bfloat16)
        out.append(c)
        rem = rem - c.double().numpy()
    return out


def split_data(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` bf16 chunks of the float32 tensor ``x``: the residual of each
    chunk taken in float32 (exact), the last chunk its rounding — the JAX
    package's ``_split_vmem``."""
    out, rem = [], x.float()
    for _ in range(n - 1):
        c = rem.to(torch.bfloat16)
        out.append(c)
        rem = rem - c.float()
    out.append(rem.to(torch.bfloat16))
    return out


def pair_sum(nprod: int, product, data: torch.Tensor,
             k_img: Optional[int] = None, dim: int = -1,
             pairs: Optional[List[Tuple[int, int]]] = None) -> torch.Tensor:
    """``Σ_(i,j) product(i, chunk_j(data))``, the data's bf16 chunks upcast
    to float32: the twins' form of a split product (``product(i, d)``
    contracts the constant's chunk i with ``d`` along ``dim``), over
    :func:`prods` of ``nprod`` (or the list ``pairs`` of the same chunks),
    smallest level first. With ``k_img``, only the data's first ``k_img``
    rows along ``dim`` do; the rest (the carries) take those of
    :func:`carry_nprod`, the carry slab first (the kernels' order)."""
    cn = nprod if k_img is None else carry_nprod(nprod)
    ds = [d.float() for d in split_data(data, nchunks(cn))]
    if cn == nprod:
        slabs = [(prods(nprod) if pairs is None else pairs, ds)]
    else:  # each slab's chunks with the other slab's rows zeroed
        rows = torch.arange(data.shape[dim], device=data.device)
        shape = [1] * data.dim()
        shape[dim] = -1
        img = (rows < k_img).reshape(shape)
        slabs = [(prods(cn), [d * ~img for d in ds]),
                 (prods(nprod), [d * img for d in ds])]
    y = None
    for pairs, chunks in slabs:
        for i, j in pairs:
            t = product(i, chunks[j])
            y = t if y is None else y + t
    return y
