"""Symplectic integrators for Hamiltonian dynamics.

Rewrite of ref integrators.py.  The reference caches the potential
gradient in the state so each leapfrog step costs exactly one fresh logprob
gradient (ref integrators.py:64-66); we keep that invariant with
``jax.value_and_grad``.  The reference obtains the position drift as the
gradient of the kinetic energy (ref integrators.py:61) which makes
dense-metric drift automatic; we do the same via ``jax.grad`` — under XLA the
grad of ``0.5 * p^T M^{-1} p`` fuses to the matvec ``M^{-1} p``, so this costs
nothing over hand-writing the drift while supporting any differentiable
kinetic energy.
"""

from typing import Callable

import jax

from aehmc_tpu.types import IntegratorState


def new_integrator_state(
    potential_fn: Callable,
    position: jax.Array,
    momentum: jax.Array,
) -> IntegratorState:
    """Create an integrator state, computing U and its gradient once.

    Mirrors ref integrators.py:14-24.
    """
    potential_energy, potential_energy_grad = jax.value_and_grad(potential_fn)(
        position
    )
    return IntegratorState(
        position=position,
        momentum=momentum,
        potential_energy=potential_energy,
        potential_energy_grad=potential_energy_grad,
    )


def velocity_verlet(
    potential_fn: Callable,
    kinetic_energy_fn: Callable,
) -> Callable:
    """The velocity Verlet (Störmer-Verlet) integrator.

    A two-stage palindromic integrator of the form (a1, b1, a2, b1, a1) with
    a1 = 0: half-kick, drift, half-kick.  Numerically stable for step sizes in
    (0, 2) when the mass matrix is the identity.  Mirrors ref
    integrators.py:27-75.

    Returns
    -------
    ``one_step(state, step_size) -> state`` performing one leapfrog step;
    costs one fresh potential gradient.
    """
    b1 = 0.5
    a2 = 1.0

    potential_vag = jax.value_and_grad(potential_fn)
    kinetic_grad = jax.grad(kinetic_energy_fn)

    def one_step(state: IntegratorState, step_size: jax.Array) -> IntegratorState:
        momentum = state.momentum - b1 * step_size * state.potential_energy_grad
        position = state.position + a2 * step_size * kinetic_grad(momentum)
        potential_energy, potential_energy_grad = potential_vag(position)
        momentum = momentum - b1 * step_size * potential_energy_grad
        return IntegratorState(
            position=position,
            momentum=momentum,
            potential_energy=potential_energy,
            potential_energy_grad=potential_energy_grad,
        )

    return one_step


def mclachlan(
    potential_fn: Callable,
    kinetic_energy_fn: Callable,
) -> Callable:
    """McLachlan's minimum-norm two-stage palindromic integrator:
    B(b1) A(1/2) B(1-2b1) A(1/2) B(b1).

    Two gradient evaluations per step with a larger stability region per
    gradient than velocity Verlet (Blanes-Casas-Sanz-Serna); new capability
    vs the reference (which has only velocity Verlet).
    """
    b1 = 0.1931833275037836
    a1 = 0.5
    b2 = 1.0 - 2.0 * b1

    potential_vag = jax.value_and_grad(potential_fn)
    kinetic_grad = jax.grad(kinetic_energy_fn)
    grad_fn = jax.grad(potential_fn)

    def one_step(state: IntegratorState, step_size: jax.Array) -> IntegratorState:
        q, p, g = state.position, state.momentum, state.potential_energy_grad
        p = p - b1 * step_size * g
        q = q + a1 * step_size * kinetic_grad(p)
        g = grad_fn(q)
        p = p - b2 * step_size * g
        q = q + a1 * step_size * kinetic_grad(p)
        potential_energy, g = potential_vag(q)
        p = p - b1 * step_size * g
        return IntegratorState(q, p, potential_energy, g)

    return one_step


def yoshida(
    potential_fn: Callable,
    kinetic_energy_fn: Callable,
) -> Callable:
    """Three-stage palindromic integrator
    B(b1) A(a1) B(b2) A(1-2a1) B(b2) A(a1) B(b1) with the
    Blanes-Casas-Sanz-Serna minimum-error coefficients."""
    b1 = 0.11888010966548
    a1 = 0.29619504261126
    b2 = 0.5 - b1
    a2 = 1.0 - 2.0 * a1

    potential_vag = jax.value_and_grad(potential_fn)
    kinetic_grad = jax.grad(kinetic_energy_fn)
    grad_fn = jax.grad(potential_fn)

    def one_step(state: IntegratorState, step_size: jax.Array) -> IntegratorState:
        q, p, g = state.position, state.momentum, state.potential_energy_grad
        p = p - b1 * step_size * g
        q = q + a1 * step_size * kinetic_grad(p)
        g = grad_fn(q)
        p = p - b2 * step_size * g
        q = q + a2 * step_size * kinetic_grad(p)
        g = grad_fn(q)
        p = p - b2 * step_size * g
        q = q + a1 * step_size * kinetic_grad(p)
        potential_energy, g = potential_vag(q)
        p = p - b1 * step_size * g
        return IntegratorState(q, p, potential_energy, g)

    return one_step
