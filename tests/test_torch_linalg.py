"""``paddle.linalg`` on the port held against paddle_tpu's on the CPU.

Where the result is unique (products, norms, ``det`` / ``slogdet``,
``inv``, ``solve``, ``cholesky``, LU with partial pivoting, the
eigenvalues of a symmetric matrix, singular values, ``lstsq``'s
minimum-norm solution, the Householder products) the port's values, and
their gradients where JAX differentiates them, are held against JAX's
within 1e-5 relative and absolute (f32 factorizations: LAPACK's
and XLA's own orders of the same sums).  Where the factors are unique
only up to signs or phases (``qr``, ``svd``, ``eig``, ``eigh``'s
vectors), the port is held by its invariants: the reconstruction, the
orthogonality and the eigen-equation within 1e-5, and the unique parts
(|diag R|, singular values, eigenvalues) against JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
R = np.random.RandomState(1)
A = R.randn(4, 4).astype(np.float32)
B = R.randn(4, 3).astype(np.float32)
V = R.randn(4).astype(np.float32)
SPD = (A @ A.T + 4 * np.eye(4)).astype(np.float32)
SYM = (A + A.T).astype(np.float32)
BAT = R.randn(2, 4, 4).astype(np.float32)
BAT2 = R.randn(2, 4, 3).astype(np.float32)
TALL = R.randn(6, 3).astype(np.float32)
Y6 = R.randn(6, 2).astype(np.float32)
# rank 2 in a 6 x 4: the third and fourth columns repeat the first two
DEF = np.concatenate([TALL[:, :2], TALL[:, :2] * 2.0], axis=1)
TRI = np.triu(A) + 3 * np.eye(4, dtype=np.float32)
C3 = R.randn(3, 5).astype(np.float32)
D3 = R.randn(3, 5).astype(np.float32)
IN = dict(A=A, B=B, V=V, SPD=SPD, SYM=SYM, BAT=BAT, BAT2=BAT2, TALL=TALL,
          Y6=Y6, DEF=DEF, TRI=TRI, C3=C3, D3=D3,
          TAU=R.rand(3).astype(np.float32),
          FW=np.array([1, 2, 1, 3, 1], np.int64),
          AW=R.rand(5).astype(np.float32))


@pytest.fixture(autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _run(pkg, fn, names, grad):
    ts = [pkg.to_tensor(IN[n], stop_gradient=not (
        grad and IN[n].dtype.kind == "f")) for n in names]
    out = fn(pkg, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    vals = [(o.numpy(), o.dtype.name) for o in outs]
    grads = []
    if grad:
        loss = None
        for k, o in enumerate(outs):
            if o.dtype.name != "float32":
                continue
            g = np.asarray(np.random.RandomState(50 + k).randn(*o.shape),
                           np.float32)
            term = (o * pkg.to_tensor(g)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [None if t.grad is None else t.grad.numpy() for t in ts]
    return vals, grads


def C(op_id, fn, names, grad=True, tol=None):
    return pytest.param(fn, names, grad, tol, id=op_id)


UNIQUE = [
    C("matmul", lambda p, a, b: p.matmul(a, b, transpose_x=True), ["A", "B"]),
    C("dot", lambda p, a, b: p.dot(a, b), ["C3", "D3"]),
    C("bmm", lambda p, a, b: p.bmm(a, b), ["BAT", "BAT2"]),
    C("mv", lambda p, a, v: p.mv(a, v), ["A", "V"]),
    C("multi_dot", lambda p, a, b, c: p.linalg.multi_dot([a, b, c]),
      ["A", "A", "B"]),
    C("norm", lambda p, a: p.linalg.norm(a), ["A"]),
    C("norm_p1_axis", lambda p, a: p.linalg.norm(a, p=1, axis=1), ["A"]),
    C("norm_inf", lambda p, a: p.linalg.norm(a, p=float("inf")), ["A"]),
    C("norm_p3_keepdim", lambda p, a: p.linalg.norm(a, p=3, axis=0,
                                                    keepdim=True), ["A"]),
    C("norm_nuc", lambda p, a: p.linalg.norm(a, p="nuc", axis=[0, 1]),
      ["A"]),
    C("norm_induced_2", lambda p, a: p.linalg.norm(a, p=2, axis=[1, 2]),
      ["BAT"], False),
    C("vector_norm", lambda p, a: p.linalg.vector_norm(a, p=2.0, axis=1),
      ["A"]),
    C("matrix_norm", lambda p, a: p.linalg.matrix_norm(a, p=1), ["BAT"]),
    C("dist", lambda p, a, b: p.linalg.dist(a, b, p=3), ["C3", "D3"]),
    C("cross", lambda p, a, b: p.linalg.cross(a, b), ["C3", "D3"]),
    C("cholesky", lambda p, a: p.linalg.cholesky(a), ["SPD"]),
    C("cholesky_upper", lambda p, a: p.linalg.cholesky(a, upper=True),
      ["SPD"]),
    C("cholesky_solve", lambda p, b, a: p.linalg.cholesky_solve(
        b, p.linalg.cholesky(a)), ["B", "SPD"]),
    C("inv", lambda p, a: p.linalg.inv(a), ["SPD"]),
    C("inverse", lambda p, a: p.inverse(a), ["BAT"]),
    C("det", lambda p, a: p.linalg.det(a), ["BAT"]),
    C("slogdet", lambda p, a: p.linalg.slogdet(a), ["A"]),
    C("solve", lambda p, a, b: p.linalg.solve(a, b), ["SPD", "B"]),
    C("solve_vector", lambda p, a, v: p.linalg.solve(a, v), ["A", "V"]),
    C("triangular_solve", lambda p, a, b: p.linalg.triangular_solve(a, b),
      ["TRI", "B"]),
    C("triangular_solve_transpose_unit", lambda p, a, b:
      p.linalg.triangular_solve(a, b, transpose=True, unitriangular=True),
      ["TRI", "B"]),
    C("pinv", lambda p, a: p.linalg.pinv(a), ["TALL"]),
    C("matrix_power", lambda p, a: p.linalg.matrix_power(a, 3), ["A"]),
    C("matrix_power_negative", lambda p, a: p.linalg.matrix_power(a, -2),
      ["SPD"]),
    C("matrix_rank", lambda p, a: p.linalg.matrix_rank(a), ["DEF"], False),
    C("cond", lambda p, a: p.linalg.cond(a), ["SPD"], False),
    C("lu", lambda p, a: p.linalg.lu(a, get_infos=True), ["A"], False),
    C("lu_unpack", lambda p, a: p.linalg.lu_unpack(*p.linalg.lu(a)), ["A"],
      False),
    C("corrcoef", lambda p, a: p.linalg.corrcoef(a), ["C3"]),
    C("cov", lambda p, a: p.linalg.cov(a, rowvar=False), ["TALL"]),
    C("cov_fweights", lambda p, a, f: p.linalg.cov(a, fweights=f),
      ["C3", "FW"]),
    C("cov_aweights_biased", lambda p, a, w: p.linalg.cov(
        a, ddof=False, aweights=w), ["C3", "AW"]),
    C("householder_product", lambda p, a, t: p.linalg.householder_product(
        a, t), ["TALL", "TAU"], False),
    C("matrix_exp", lambda p, a: p.linalg.matrix_exp(a * 0.3), ["A"],
      False),
    C("ormqr", lambda p, a, t, b: p.linalg.ormqr(a, t, b),
      ["TALL", "TAU", "Y6"], False),
    C("ormqr_right_transpose", lambda p, a, t, b: p.linalg.ormqr(
        a, t, p.transpose(b, [1, 0]), left=False, transpose=True),
      ["TALL", "TAU", "Y6"], False),
    C("cholesky_inverse", lambda p, a: p.linalg.cholesky_inverse(
        p.linalg.cholesky(a)), ["SPD"]),
    C("eigvalsh", lambda p, a: p.linalg.eigvalsh(a), ["SYM"]),
    C("lstsq_full_rank", lambda p, a, b: p.linalg.lstsq(a, b), ["TALL", "Y6"],
      False),
    C("lstsq_rank_deficient", lambda p, a, b: p.linalg.lstsq(a, b),
      ["DEF", "Y6"], False),
    C("lstsq_rcond", lambda p, a, b: p.linalg.lstsq(a, b, rcond=0.5),
      ["TALL", "Y6"], False),
]


@pytest.mark.parametrize("fn, names, grad, tol", UNIQUE)
def test_unique_results_match_jax(fn, names, grad, tol):
    (jv, jg), (tv, tg) = _run(jp, fn, names, grad), _run(tp, fn, names, grad)
    assert len(tv) == len(jv)
    for (a, ad), (b, bd) in zip(tv, jv):
        assert ad == bd and a.shape == b.shape, (ad, bd, a.shape, b.shape)
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, **(tol or TOL))
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tg, jg):
        if a is None or b is None:
            assert a is None and b is None or not np.any(
                a if a is not None else b)
            continue
        np.testing.assert_allclose(a, b, **(tol or TOL))


def _np(t):
    return np.asarray(t.numpy())


def test_lstsq_rank_deficient_gives_jax_rank_and_min_norm_solution():
    jx, jr, jk, js = (_np(t) for t in jp.linalg.lstsq(
        jp.to_tensor(DEF), jp.to_tensor(Y6)))
    tx, tr, tk, ts = tp.linalg.lstsq(tp.to_tensor(DEF), tp.to_tensor(Y6))
    assert tk.dtype.name == "int32" and int(tk) == int(jk) == 2
    np.testing.assert_allclose(_np(tx), jx, **TOL)
    np.testing.assert_allclose(_np(tr), jr, **TOL)
    np.testing.assert_allclose(_np(ts), js, **TOL)
    # the minimum-norm solution: orthogonal to the null space of DEF
    null = np.array([[2.0, 0.0, -1.0, 0.0], [0.0, 2.0, 0.0, -1.0]],
                    np.float32)
    np.testing.assert_allclose(null @ _np(tx), 0.0, atol=1e-4)


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_by_invariants(mode):
    jq, jr = (_np(t) for t in jp.linalg.qr(jp.to_tensor(TALL), mode=mode))
    tq, tr = (_np(t) for t in tp.linalg.qr(tp.to_tensor(TALL), mode=mode))
    assert tq.shape == jq.shape and tr.shape == jr.shape
    np.testing.assert_allclose(tq @ tr, TALL, **TOL)
    np.testing.assert_allclose(tq.T @ tq, np.eye(tq.shape[1]), **TOL)
    np.testing.assert_allclose(np.tril(tr, -1), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.diag(tr)), np.abs(np.diag(jr)),
                               **TOL)
    r_only = _np(tp.linalg.qr(tp.to_tensor(TALL), mode="r"))
    np.testing.assert_allclose(np.abs(r_only), np.abs(tr[:r_only.shape[0]]),
                               **TOL)


@pytest.mark.parametrize("full", [False, True])
def test_svd_by_invariants(full):
    ju, js, jvh = (_np(t) for t in jp.linalg.svd(jp.to_tensor(BAT2),
                                                 full_matrices=full))
    tu, ts, tvh = (_np(t) for t in tp.linalg.svd(tp.to_tensor(BAT2),
                                                 full_matrices=full))
    assert (tu.shape, ts.shape, tvh.shape) == (ju.shape, js.shape, jvh.shape)
    np.testing.assert_allclose(ts, js, **TOL)
    k = ts.shape[-1]
    rec = tu[..., :, :k] * ts[..., None, :] @ tvh[..., :k, :]
    np.testing.assert_allclose(rec, BAT2, **TOL)
    eye = np.eye(tu.shape[-1])
    np.testing.assert_allclose(np.swapaxes(tu, -1, -2) @ tu,
                               np.broadcast_to(eye, (2,) + eye.shape),
                               **TOL)


def test_eigh_by_invariants():
    jw, _ = (_np(t) for t in jp.linalg.eigh(jp.to_tensor(SYM)))
    tw, tv = (_np(t) for t in tp.linalg.eigh(tp.to_tensor(SYM)))
    np.testing.assert_allclose(tw, jw, **TOL)
    np.testing.assert_allclose(SYM @ tv, tv * tw[None, :], **TOL)
    np.testing.assert_allclose(tv.T @ tv, np.eye(4), **TOL)


@pytest.mark.parametrize("which", ["complex", "real"])
def test_eig_by_invariants(which):
    a = A if which == "complex" else SYM
    jw, _ = jp.linalg.eig(jp.to_tensor(a))
    tw, tv = tp.linalg.eig(tp.to_tensor(a))
    assert tw.dtype.name == jw.dtype.name and tv.dtype.name == tw.dtype.name
    w, v = _np(tw), _np(tv)
    np.testing.assert_allclose(a @ v, v * w[None, :], **TOL)
    np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(_np(jw)),
                               **TOL)
    tev = tp.linalg.eigvals(tp.to_tensor(a))
    jev = jp.linalg.eigvals(jp.to_tensor(a))
    assert tev.dtype.name == jev.dtype.name
    np.testing.assert_allclose(np.sort_complex(_np(tev)),
                               np.sort_complex(_np(jev)), **TOL)


def test_lowrank_by_invariants():
    for name in ("svd_lowrank", "pca_lowrank"):
        j = [_np(t) for t in getattr(jp.linalg, name)(jp.to_tensor(TALL),
                                                      q=2)]
        t = [_np(t) for t in getattr(tp.linalg, name)(tp.to_tensor(TALL),
                                                      q=2)]
        assert [a.shape for a in t] == [a.shape for a in j]
        np.testing.assert_allclose(t[1], j[1], **TOL)


def test_linalg_namespace_is_jax_all():
    from paddle_tpu.tensor import linalg as jl
    missing = [n for n in jl.__all__ if not hasattr(tp.linalg, n)]
    assert not missing
