"""paddle.linalg namespace of the port (counterpart of
`paddle_tpu/linalg.py`): re-exports of `tensor.linalg` and
`tensor.extras`."""
from .tensor.linalg import (  # noqa: F401
    cholesky, cholesky_solve, corrcoef, cov, det, eig, eigh, eigvals, eigvalsh,
    inv, lstsq, lu, matmul, matrix_power, matrix_rank, multi_dot, norm, pinv,
    qr, slogdet, solve, svd, triangular_solve,
)
from .tensor.extras import (  # noqa: F401
    cdist, cond, householder_product, lu_unpack, matrix_exp, vector_norm,
)
