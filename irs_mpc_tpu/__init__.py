"""irs_mpc_tpu — iterative Randomized-Smoothing MPC on an accelerator.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
hjsuh94/irs_mpc (reference mounted at /root/reference): smoothed
time-varying linearization by Monte-Carlo sampling, on-device TV-LQR
(Riccati scan / associative scan / boxed QP), receding-horizon descent,
CEM baselines, differentiable quasistatic contact dynamics, and
multi-device sharding of the sample/knot axes over a jax.sharding.Mesh.
"""

from .models.base import System
from .models.pendulum import make_pendulum
from .models.bicycle import make_bicycle
from .models.quadrotor import make_quadrotor
from .models.three_cart import make_three_cart
from .ops.estimators import SmoothingConfig, estimate_tv_matrices
from .ops import lqr
from .ops.solvers import get_solver
from .solvers.irs_mpc import IrsMpc, IrsMpcParams, IterationStats
from .solvers.cem import CemParams, CrossEntropyMethod

__version__ = "0.1.0"

__all__ = [
    "System", "make_pendulum", "make_bicycle", "make_quadrotor",
    "make_three_cart", "SmoothingConfig", "estimate_tv_matrices",
    "lqr", "get_solver", "IrsMpc", "IrsMpcParams", "IterationStats",
    "CemParams", "CrossEntropyMethod",
]


def contact_systems():
    """Convenience accessor for the contact-system factory module
    (analogue of the reference's ``irs_lqr/all.py`` star re-exports)."""
    from .models.contact import systems
    return systems
