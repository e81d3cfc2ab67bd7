"""Small-matrix linear algebra as unrolled elementwise code.

Every linear solve in this framework is small (n <= ~50: Riccati H,
contact-QP KKT, least-squares Gram matrices), so Gauss-Jordan is unrolled
at trace time into pure elementwise/broadcast ops that XLA fuses into the
surrounding computation, fully vmappable and differentiable, instead of a
generic batched ``jnp.linalg.solve`` library call.  Whether batched
Cholesky is faster on the GPU at n = 3..16 is not measured yet.

No pivoting: callers pass SPD or regularized diagonally-dominant systems
(Riccati H = R + B'PB, PDIP H = P + C'WC + eps I, Gram + ridge).  For
general matrices use jnp.linalg.solve.
"""
from __future__ import annotations

import jax.numpy as jnp

# Above this size, defer to XLA's solver (asymptotics win eventually).
_UNROLL_LIMIT = 64


def solve_spd(A, b):
    """Solve A x = b for SPD/diagonally-dominant A, batched over any leading
    dims.  A: (..., n, n); b: (..., n) or (..., n, k)."""
    n = A.shape[-1]
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    if n > _UNROLL_LIMIT:
        x = jnp.linalg.solve(A, b)
        return x[..., 0] if vec else x

    M = jnp.concatenate([A, b], axis=-1)          # (..., n, n+k)
    for k in range(n):
        piv = M[..., k:k + 1, k:k + 1]
        row_k = M[..., k:k + 1, :] / piv
        factors = M[..., :, k:k + 1]
        M = M - factors * row_k
        M = M.at[..., k, :].set(row_k[..., 0, :])
    x = M[..., n:]
    return x[..., 0] if vec else x


def inv_spd(A):
    """Inverse of small SPD/diagonally-dominant matrices (batched)."""
    n = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    return solve_spd(A, eye)
