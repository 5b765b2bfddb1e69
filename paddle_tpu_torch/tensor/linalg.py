"""Linear algebra: ``matmul`` and the ``paddle.linalg`` namespace.

Counterpart of ``paddle_tpu/tensor/linalg.py``, on ``torch.linalg``
(cuSOLVER / cuBLAS on the card).  Where a decomposition's factors are not
unique (the signs and phases of ``qr``, ``svd``, ``eig``, ``eigh``), the
port's factors are torch's; what is unique (singular values, eigenvalues,
``det``, ``slogdet``, every reconstruction) matches JAX's.

``lstsq`` returns JAX's four outputs (solution, residuals, int32 rank,
singular values) from one SVD on every device: torch's own CUDA driver
(``gels``) assumes full rank and gives no rank or singular values, so a
rank-deficient system is solved as JAX solves it, by the pseudo-inverse
with the singular values below ``rcond`` dropped.  ``eig`` / ``eigvals``
give real results when every eigenvalue is real, as JAX's numpy path
does (a host read).
"""

from __future__ import annotations

import builtins

import torch

from ..ops.dispatch import apply, as_tensor
from .tensor import wrap_array

__all__ = [
    "matmul", "dot", "bmm", "mv", "norm", "vector_norm", "matrix_norm",
    "dist", "cross", "cholesky", "cholesky_solve", "inv", "inverse", "det",
    "slogdet", "svd", "qr", "eig", "eigh", "eigvals", "eigvalsh", "solve",
    "triangular_solve", "lstsq", "pinv", "matrix_power", "matrix_rank",
    "cond", "lu", "lu_unpack", "corrcoef", "cov", "householder_product",
    "multi_dot", "svd_lowrank", "pca_lowrank", "matrix_exp", "ormqr",
    "cholesky_inverse",
]

_INF = float("inf")


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, each operand's last two axes swapped first when asked."""
    tx, ty = bool(transpose_x), bool(transpose_y)

    def fn(a, b):
        if tx and a.dim() > 1:
            a = a.transpose(-1, -2)
        if ty and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply("matmul", fn, as_tensor(x), as_tensor(y))


def dot(x, y, name=None):
    return apply("dot", lambda a, b: torch.sum(a * b, dim=-1),
                 as_tensor(x), as_tensor(y))


def bmm(x, y, name=None):
    return apply("bmm", torch.matmul, as_tensor(x), as_tensor(y))


def mv(x, vec, name=None):
    return apply("mv", torch.matmul, as_tensor(x), as_tensor(vec))


def multi_dot(x, name=None):
    ts = [as_tensor(t) for t in x]
    return apply("multi_dot", lambda *arrs: torch.linalg.multi_dot(arrs),
                 *ts)


def _l2(a, dim=None, keepdim=False):
    return torch.sqrt(torch.sum(a * a, dim=dim, keepdim=keepdim)) \
        if dim is not None else torch.sqrt(torch.sum(a * a))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """JAX's rules: the Frobenius norm by default, a vector p-norm over
    one axis (or all), an induced matrix norm over a pair of axes."""
    x = as_tensor(x)
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def fn(a):
        if ax is None:
            flat = a.reshape(-1)
            if p == "fro" or p == 2:
                r = _l2(flat)
            elif p == _INF:
                r = flat.abs().max()
            elif p == -_INF:
                r = flat.abs().min()
            elif p == 0:
                r = (flat != 0).sum().to(a.dtype)
            else:
                r = torch.sum(flat.abs() ** p) ** (1.0 / p)
            return r.reshape((1,) * a.dim()) if keepdim else r
        if p == "fro":
            return _l2(a, ax, keepdim)
        if p == "nuc":
            s = torch.linalg.svdvals(a)
            return torch.sum(s, dim=-1, keepdim=keepdim)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(a, ord=p, dim=ax,
                                            keepdim=keepdim)
        if p == _INF:
            return torch.amax(a.abs(), dim=ax, keepdim=keepdim)
        if p == -_INF:
            return torch.amin(a.abs(), dim=ax, keepdim=keepdim)
        if p == 0:
            return (a != 0).sum(dim=ax, keepdim=keepdim).to(a.dtype)
        if p == 1:
            return torch.sum(a.abs(), dim=ax, keepdim=keepdim)
        return torch.sum(a.abs() ** p, dim=ax, keepdim=keepdim) ** (1.0 / p)

    return apply("norm", fn, x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return norm(x, p=p, axis=list(axis), keepdim=keepdim)


def dist(x, y, p=2, name=None):
    def fn(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return (d != 0).sum().to(a.dtype)
        if p == _INF:
            return d.abs().max()
        if p == -_INF:
            return d.abs().min()
        return torch.sum(d.abs() ** p) ** (1.0 / p)
    return apply("dist", fn, as_tensor(x), as_tensor(y))


def cross(x, y, axis=9, name=None):
    x, y = as_tensor(x), as_tensor(y)
    ax = axis
    if ax == 9:              # Paddle's default: the first axis of size 3
        ax = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return apply("cross", lambda a, b: torch.linalg.cross(a, b, dim=ax),
                 x, y)


def cholesky(x, upper=False, name=None):
    def fn(a):
        low = torch.linalg.cholesky(a)
        return low.mH if upper else low
    return apply("cholesky", fn, as_tensor(x))


def cholesky_solve(x, y, upper=False, name=None):
    return apply("cholesky_solve", lambda b, c: torch.cholesky_solve(
        b, c, upper=upper), as_tensor(x), as_tensor(y))


def inverse(x, name=None):
    return apply("inverse", torch.linalg.inv, as_tensor(x))


inv = inverse


def det(x, name=None):
    return apply("det", torch.linalg.det, as_tensor(x))


def slogdet(x, name=None):
    """[sign, log|det|] stacked on a new leading axis, as JAX's."""
    def fn(a):
        sign, logabs = torch.linalg.slogdet(a)
        return torch.stack([sign, logabs])
    return apply("slogdet", fn, as_tensor(x))


def svd(x, full_matrices=False, name=None):
    """(U, S, VH): VH is the conjugate transpose of V."""
    return apply("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), as_tensor(x))


def qr(x, mode="reduced", name=None):
    x = as_tensor(x)
    if mode == "r":
        return apply("qr_r", lambda a: torch.linalg.qr(a, mode="r")[1], x)
    return apply("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)), x)


def _real_if_real(*arrs):
    """numpy's rule for ``eig`` of a real matrix: real results when every
    eigenvalue's imaginary part is zero."""
    if bool((arrs[0].imag == 0).all()):
        return tuple(a.real.contiguous() for a in arrs)
    return arrs


def eig(x, name=None):
    a = as_tensor(x)._data.detach()
    w, v = torch.linalg.eig(a)
    if not a.is_complex():
        w, v = _real_if_real(w, v)
    return wrap_array(w), wrap_array(v)


def eigvals(x, name=None):
    a = as_tensor(x)._data.detach()
    w = torch.linalg.eigvals(a)
    if not a.is_complex():
        (w,) = _real_if_real(w)
    return wrap_array(w)


def _sym(a):
    return (a + a.mH) / 2


def eigh(x, UPLO="L", name=None):
    """(ascending eigenvalues, eigenvectors) of the symmetrised input, as
    JAX's ``symmetrize_input``."""
    return apply("eigh", lambda a: tuple(torch.linalg.eigh(_sym(a),
                                                           UPLO=UPLO)),
                 as_tensor(x))


def eigvalsh(x, UPLO="L", name=None):
    return apply("eigvalsh", lambda a: torch.linalg.eigvalsh(_sym(a)),
                 as_tensor(x))


def solve(x, y, name=None):
    def fn(a, b):
        if b.dim() == a.dim() - 1:
            return torch.linalg.solve(a, b[..., None])[..., 0]
        return torch.linalg.solve(a, b)
    return apply("solve", fn, as_tensor(x), as_tensor(y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        up = upper
        if transpose:
            a, up = a.mT, not upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return apply("triangular_solve", fn, as_tensor(x), as_tensor(y))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) of min ||x @ sol - y||
    for a 2-D ``x``, by JAX's SVD recipe: singular values below ``rcond``
    times the largest (eps * max(m, n) by default) are dropped, so a
    rank-deficient ``x`` gives the minimum-norm solution; the rank is
    int32; the residuals are ||y - x @ sol||^2 per column."""
    def fn(a, b):
        vec = b.dim() == 1
        if vec:
            b = b[:, None]
        m, n = a.shape[-2], a.shape[-1]
        eps = torch.finfo(a.dtype).eps
        rc = eps * builtins.max(m, n) if rcond is None else (
            eps if rcond < 0 else rcond)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        mask = s >= rc * s[..., :1]
        safe = torch.where(mask, s, torch.ones_like(s))
        s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[..., None]
        sol = vh.mH @ (s_inv * (u.mH @ b))
        resid = torch.linalg.vector_norm(b - a @ sol, dim=-2) ** 2
        rank = mask.sum(-1).to(torch.int32)
        if vec:
            sol = sol.reshape(-1)
        return sol, resid, rank, s

    return apply("lstsq", fn, as_tensor(x), as_tensor(y))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), as_tensor(x))


def matrix_power(x, n, name=None):
    return apply("matrix_power", lambda a: torch.linalg.matrix_power(a, n),
                 as_tensor(x))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a, rtol=tol).to(torch.int64), as_tensor(x))


def cond(x, p=None, name=None):
    return apply("cond", lambda a: torch.linalg.cond(a, p), as_tensor(x))


def lu(x, pivot=True, get_infos=False, name=None):
    """(packed LU, 1-based int32 pivots[, int32 infos])."""
    x = as_tensor(x)
    lu_t, piv_t = apply("lu", lambda a: tuple(torch.linalg.lu_factor(a)), x)
    if get_infos:
        info = wrap_array(torch.zeros(x.shape[:-2] or [1], dtype=torch.int32,
                                      device=x._data.device))
        return lu_t, piv_t, info
    return lu_t, piv_t


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) with x's matrix = P @ L @ U."""
    return apply("lu_unpack", lambda a, p: tuple(torch.lu_unpack(
        a, p.to(torch.int32))), as_tensor(x), as_tensor(y))


def corrcoef(x, rowvar=True, name=None):
    return apply("corrcoef", lambda a: torch.corrcoef(a if rowvar else a.T),
                 as_tensor(x))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = as_tensor(x)
    corr = int(bool(ddof))

    def rows(a):
        return a if rowvar or a.dim() < 2 else a.T

    if fweights is not None:
        return apply("cov", lambda a, f: torch.cov(
            rows(a), correction=corr, fweights=f), x, as_tensor(fweights))
    if aweights is not None:
        return apply("cov", lambda a, w: torch.cov(
            rows(a), correction=corr, aweights=w), x, as_tensor(aweights))
    return apply("cov", lambda a: torch.cov(rows(a), correction=corr), x)


def householder_product(x, tau, name=None):
    return apply("householder_product", torch.linalg.householder_product,
                 as_tensor(x), as_tensor(tau))


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    from .manipulation import getitem
    u, s, v = svd(x)
    qq = builtins.min(q, s.shape[-1])
    return (getitem(u, (Ellipsis, builtins.slice(None, qq))),
            getitem(s, (Ellipsis, builtins.slice(None, qq))),
            getitem(v, (Ellipsis, builtins.slice(None, qq))))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    x = as_tensor(x)
    if q is None:
        q = builtins.min(6, *x.shape[-2:])
    if center:
        from .math import mean, subtract
        x = subtract(x, mean(x, axis=-2, keepdim=True))
    return svd_lowrank(x, q=q, niter=niter)


def matrix_exp(x, name=None):
    return apply("matrix_exp", torch.linalg.matrix_exp, as_tensor(x))


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """``y`` multiplied by the full Q (or Q^T) of the Householder
    reflectors in ``x`` and ``tau`` (LAPACK's geqrf layout)."""
    return apply("ormqr", lambda a, t, b: torch.ormqr(
        a, t, b, left=left, transpose=transpose),
        as_tensor(x), as_tensor(tau), as_tensor(y))


def cholesky_inverse(x, upper=False, name=None):
    return apply("cholesky_inverse", lambda c: torch.cholesky_inverse(
        c, upper=upper), as_tensor(x))
