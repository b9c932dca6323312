"""Sparse matrix containers — the port of `jl_tpu/ops/sparse.py`.

* `DIAMatrix` — diagonal storage: data (ndiag, n) + static offsets.  The
  natural format for stencil-structured PDE jacobians; its product is the
  hand-written CUDA kernel on the card (`ops/dia_spmv.py`).
* `ELLMatrix` — padded rows: data (n, k) + cols (n, k), -1 = padding.  One
  gather and a row sum.
* `BSRMatrix` — block-ELL: blocks (nb, k, bs, bs) + bcols (nb, k), -1 =
  padding.  An einsum over (bs, bs) blocks.

Each is a callable `J(v) = J @ v`, so it passes through the solvers as a
jacobian representation (a `jac_op` may return one).  `matvec` takes v of
shape (n,) or a batch (K, n).  The constructors that build from host data
(`from_dense`, `from_scipy`, `laplacian_1d_dia`) put the result on the
card unless they are given `device=`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from .. import DEFAULT_DTYPE, resolve_device
from .dia_spmv import dia_spmv


@dataclasses.dataclass(frozen=True, eq=False)
class DIAMatrix:
    data: torch.Tensor           # (ndiag, n)
    offsets: Tuple[int, ...]     # static

    @property
    def shape(self):
        n = self.data.shape[1]
        return (n, n)

    @property
    def nnz(self):
        return self.data.shape[0] * self.data.shape[1]

    def matvec(self, v):
        """sum_k data[k, i] * v[i + off_k], v zero outside [0, n); v is
        (n,) or (K, n)."""
        return dia_spmv(self, v.contiguous())

    __call__ = matvec

    def todense(self):
        n = self.data.shape[1]
        A = torch.zeros((n, n), dtype=self.data.dtype, device=self.data.device)
        for k, off in enumerate(self.offsets):
            m = n - abs(off)
            if m <= 0:
                continue
            idx = torch.arange(m, device=self.data.device)
            if off >= 0:
                A[idx, idx + off] = self.data[k, :m]
            else:
                A[idx - off, idx] = self.data[k, -off:]
        return A

    @classmethod
    def from_dense(cls, A, offsets: Sequence[int], device=None):
        if isinstance(A, torch.Tensor):
            dev = A.device if device is None else resolve_device(device)
            A = A.detach().cpu().numpy()
        else:
            dev = resolve_device(device)
            A = np.asarray(A)
        n = A.shape[0]
        data = np.zeros((len(offsets), n), A.dtype)
        for k, off in enumerate(offsets):
            if off >= 0:
                data[k, :n - off] = np.diag(A, off)
            else:
                data[k, -off:] = np.diag(A, off)
        return cls(torch.as_tensor(data, device=dev), tuple(offsets))


@dataclasses.dataclass(frozen=True, eq=False)
class ELLMatrix:
    data: torch.Tensor     # (n, k)
    cols: torch.Tensor     # (n, k) int64; -1 = padding

    @property
    def shape(self):
        n = self.data.shape[0]
        return (n, n)

    @property
    def nnz(self):
        return int(self.data.shape[0] * self.data.shape[1])

    def __call__(self, v):
        return self.matvec(v)

    def matvec(self, v):
        mask = self.cols >= 0
        safe = torch.where(mask, self.cols, 0)
        vals = v[..., safe] * torch.where(mask, self.data, 0.0)
        return torch.sum(vals, dim=-1)

    @classmethod
    def from_scipy(cls, A, device=None):
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        n = A.shape[0]
        k = int(np.diff(A.indptr).max())
        data = np.zeros((n, k), A.dtype)
        cols = np.full((n, k), -1, np.int64)
        for i in range(n):
            row = slice(A.indptr[i], A.indptr[i + 1])
            nzi = A.indptr[i + 1] - A.indptr[i]
            data[i, :nzi] = A.data[row]
            cols[i, :nzi] = A.indices[row]
        dev = resolve_device(device)
        return cls(torch.as_tensor(data, device=dev),
                   torch.as_tensor(cols, device=dev))

    def todense(self):
        n, k = self.data.shape
        A = torch.zeros((n, n), dtype=self.data.dtype, device=self.data.device)
        mask = self.cols >= 0
        rows = torch.arange(n, device=self.data.device)[:, None].expand(n, k)
        safe = torch.where(mask, self.cols, 0)
        return A.index_put((rows, safe), torch.where(mask, self.data, 0.0),
                           accumulate=True)


@dataclasses.dataclass(frozen=True, eq=False)
class BSRMatrix:
    blocks: Any    # (nbrows, k, bs, bs)
    bcols: Any     # (nbrows, k) int64; -1 = padding

    @property
    def bs(self):
        return self.blocks.shape[2]

    @property
    def shape(self):
        n = self.blocks.shape[0] * self.bs
        return (n, n)

    @property
    def nnz(self):
        return int(np.prod(tuple(self.blocks.shape)))

    def __call__(self, v):
        return self.matvec(v)

    def matvec(self, v):
        nb, k, bs, _ = self.blocks.shape
        vb = v.reshape(v.shape[:-1] + (nb, bs))
        mask = self.bcols >= 0
        safe = torch.where(mask, self.bcols, 0)
        vg = vb[..., safe, :]                       # (..., nb, k, bs)
        blocks = torch.where(mask[..., None, None], self.blocks, 0.0)
        out = torch.einsum("rkij,...rkj->...ri", blocks, vg)
        return out.reshape(v.shape)

    def diag_blocks(self):
        """The diagonal blocks (nb, bs, bs) (for block-Jacobi
        preconditioning)."""
        nb = self.blocks.shape[0]
        rows = torch.arange(nb, device=self.blocks.device)
        isdiag = self.bcols == rows[:, None]
        return torch.einsum("rk,rkij->rij", isdiag.to(self.blocks.dtype),
                            self.blocks)


def laplacian_1d_dia(n: int, h: float, dtype=DEFAULT_DTYPE,
                     device=None) -> DIAMatrix:
    """Standard Dirichlet 1D Laplacian as a DIA matrix."""
    dev = resolve_device(device)
    main = torch.full((n,), -2.0 / h ** 2, dtype=dtype, device=dev)
    off = torch.full((n,), 1.0 / h ** 2, dtype=dtype, device=dev)
    return DIAMatrix(torch.stack([off, main, off]), (-1, 0, 1))
