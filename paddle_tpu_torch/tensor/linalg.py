"""Linear algebra ops (counterpart of `paddle_tpu/tensor/linalg.py`).

Decompositions run on torch.linalg on the tensor's device. Where a
result is not unique (the signs of singular and eigen vectors), the port
and the JAX package may differ by those signs; the products they factor
agree."""
import builtins

import torch

from ..core.tensor import apply_op
from .math import _binop

__all__ = ["matmul", "mm", "dot", "bmm", "mv", "norm", "dist", "cross",
           "cholesky", "inverse", "inv", "pinv", "det", "slogdet", "svd",
           "qr", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank",
           "matrix_power", "solve", "triangular_solve", "cholesky_solve",
           "lstsq", "lu", "multi_dot", "histogram", "bincount", "cov",
           "corrcoef"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op(fn, x, y, name="matmul")


mm = matmul


def dot(x, y, name=None):
    return apply_op(lambda a, b: torch.sum(a * b, -1), x, y)


def bmm(x, y, name=None):
    return _binop(torch.matmul, x, y, "bmm")


def mv(x, vec, name=None):
    return _binop(torch.matmul, x, vec, "mv")


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    def fn(a):
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        if p == "fro" or (p == 2 and ax is None):
            if ax is None:
                return torch.sqrt(torch.sum(a * a))
            return torch.sqrt(torch.sum(a * a, ax, keepdim=keepdim))
        dims = tuple(range(a.dim())) if ax is None else ax
        if p == float("inf"):
            return torch.amax(torch.abs(a), dims, keepdim=keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(a), dims, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dims, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dims,
                                   keepdim=keepdim), 1.0 / p)
    return apply_op(fn, x)


def dist(x, y, p=2, name=None):
    return norm(x - y, p=float(p) if p != 2 else 2, axis=None)


def cross(x, y, axis=9, name=None):
    def fn(a, b):
        ax = axis if axis != 9 else next(i for i, s in enumerate(a.shape)
                                         if s == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return apply_op(fn, x, y)


def cholesky(x, upper=False, name=None):
    def fn(a):
        L = torch.linalg.cholesky(a)
        return L.transpose(-1, -2) if upper else L
    return apply_op(fn, x)


def inverse(x, name=None):
    return apply_op(torch.linalg.inv, x, name="inverse")


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                                hermitian=hermitian), x)


def det(x, name=None):
    return apply_op(torch.linalg.det, x, name="det")


def slogdet(x, name=None):
    def fn(a):
        sign, logdet = torch.linalg.slogdet(a)
        return torch.stack([sign, logdet])
    return apply_op(fn, x)


def svd(x, full_matrices=False, name=None):
    return apply_op(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x)


def qr(x, mode="reduced", name=None):
    def fn(a):
        q, r = torch.linalg.qr(a, mode=mode)
        return r if mode == "r" else (q, r)
    return apply_op(fn, x)


def eig(x, name=None):
    return apply_op(lambda a: tuple(torch.linalg.eig(a)), x)


def eigh(x, UPLO="L", name=None):
    return apply_op(lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), x)


def eigvals(x, name=None):
    return apply_op(torch.linalg.eigvals, x, name="eigvals")


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.matrix_rank(
        a, atol=tol, rtol=None if tol is None else 0.0,
        hermitian=hermitian), x)


def matrix_power(x, n, name=None):
    return apply_op(lambda a: torch.linalg.matrix_power(a, n), x)


def solve(x, y, name=None):
    return apply_op(torch.linalg.solve, x, y, name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return apply_op(fn, x, y)


def cholesky_solve(x, y, upper=False, name=None):
    return apply_op(lambda b, L: torch.cholesky_solve(b, L, upper=upper),
                    x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), each computed the
    same way on every device: the residuals (the squared column norms of
    A x - b) only for a full-rank tall A, as numpy and the JAX package
    give them."""
    def fn(a, b):
        sol = torch.linalg.pinv(a, rtol=rcond) @ b
        sv = torch.linalg.svdvals(a)
        rank = torch.linalg.matrix_rank(a)
        m, n = a.shape[-2], a.shape[-1]
        if m > n and int(rank) == n:
            res = torch.sum((a @ sol - b) ** 2, dim=-2)
        else:
            res = torch.zeros((0,), dtype=a.dtype, device=a.device)
        return sol, res, rank, sv
    return apply_op(fn, x, y)


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, pivots): LAPACK's packed factors and 1-based sequential row
    swaps, int32."""
    return apply_op(lambda a: tuple(torch.linalg.lu_factor(a)), x)


def multi_dot(x, name=None):
    return apply_op(lambda *xs: torch.linalg.multi_dot(xs), *x)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of `bins` equal bins over [min, max] (the data's range when
    both are 0); values outside are not counted."""
    def fn(a):
        f = a.reshape(-1).to(torch.float32) if not a.is_floating_point() \
            else a.reshape(-1)
        if min != 0 or max != 0:
            lo, hi = float(min), float(max)
        else:
            lo, hi = float(f.min()), float(f.max())
        return torch.histc(f, bins, lo, hi).to(torch.int64)
    return apply_op(fn, input)


def bincount(x, weights=None, minlength=0, name=None):
    def fn(a, *w):
        a = a.reshape(-1).long()
        if not w:
            return torch.bincount(a, minlength=minlength)
        n = builtins.max(int(a.max()) + 1 if a.numel() else 0, minlength)
        return torch.zeros(n, dtype=w[0].dtype, device=a.device).index_add(
            0, a, w[0].reshape(-1))          # differentiable in the weights
    args = (x, weights) if weights is not None else (x,)
    return apply_op(fn, *args)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply_op(lambda a: torch.cov(a if rowvar else a.T,
                                        correction=1 if ddof else 0), x)


def corrcoef(x, rowvar=True, name=None):
    return apply_op(lambda a: torch.corrcoef(a if rowvar else a.T), x)
