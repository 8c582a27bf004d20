"""Pure-NumPy single-chain iterative NUTS with *externalized randomness*.

The differential-testing oracle for NUTS transition implementations: all
random inputs — the momentum, the
per-doubling directions and biased-sampling uniforms, the per-leaf
progressive-sampling uniforms — are passed in, so the transition is a pure
deterministic function and two implementations can be compared exactly.

Semantics match :mod:`aehmc_tpu.trajectory` (canonical iterative NUTS,
NumPyro checkpoint scheme): subtree of exactly ``2**d`` leaves at doubling
``d``; progressive-*uniform* sampling within a subtree; progressive-*biased*
across doublings; rejected subtrees still merge ``sum_log_p_accept``;
checkpoint writes at even leaves, U-turn checks at odd leaves with
closed-form index ranges.

The per-leaf uniform for leaf ``i`` of doubling ``d`` is read at the static
index ``2**d - 1 + i`` of ``u_leaf`` so kernel and oracle consume the same
stream regardless of early stopping.
"""

import numpy as np


def _logistic_potential(q, X, y, prior_precision):
    logits = X @ q
    loglik = np.sum(y * logits - np.logaddexp(0.0, logits))
    return -loglik + 0.5 * prior_precision * np.sum(q * q)


def _logistic_grad(q, X, y, prior_precision):
    logits = X @ q
    resid = 1.0 / (1.0 + np.exp(-logits)) - y
    return X.T @ resid + prior_precision * q


def _popcount(n):
    return bin(int(n)).count("1")


def _trailing_ones(n):
    count = 0
    while n & 1:
        count += 1
        n >>= 1
    return count


def nuts_transition_oracle(
    q0,
    p0,
    X,
    y,
    inverse_mass,
    step_size,
    directions,
    u_bias,
    u_leaf,
    max_num_expansions,
    divergence_threshold=1000.0,
    prior_precision=1.0,
):
    """One NUTS transition for the logistic family, single chain.

    Returns a dict with the proposal position/potential, flags and counters.
    """
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    potential = lambda q: _logistic_potential(q, X, y, prior_precision)  # noqa: E731
    grad = lambda q: _logistic_grad(q, X, y, prior_precision)  # noqa: E731
    return nuts_transition_oracle_generic(
        potential, grad, q0, p0, inverse_mass, step_size, directions,
        u_bias, u_leaf, max_num_expansions, divergence_threshold,
    )


def nuts_transition_oracle_generic(
    potential,
    grad,
    q0,
    p0,
    inverse_mass,
    step_size,
    directions,
    u_bias,
    u_leaf,
    max_num_expansions,
    divergence_threshold=1000.0,
):
    """One NUTS transition for an ARBITRARY potential, single chain.

    ``potential(q) -> float`` and ``grad(q) -> ndarray`` take float64
    positions.
    """
    q0 = np.asarray(q0, np.float64)
    p0 = np.asarray(p0, np.float64)
    im = np.asarray(inverse_mass, np.float64)
    eps = float(step_size)

    # scalar/diag im applies elementwise; dense (ndim 2) as a matmul
    if im.ndim == 2:
        apply_im = lambda p: im @ p  # noqa: E731
    else:
        apply_im = lambda p: im * p  # noqa: E731
    ke = lambda p: 0.5 * np.sum(p * apply_im(p))  # noqa: E731

    def leapfrog(q, p, g, direction):
        d_eps = direction * eps
        p1 = p - 0.5 * d_eps * g
        q1 = q + d_eps * apply_im(p1)
        g1 = grad(q1)
        p1 = p1 - 0.5 * d_eps * g1
        return q1, p1, g1

    U0 = potential(q0)
    g0 = grad(q0)
    E0 = U0 + ke(p0)

    # proposal: (q, U, g, energy, weight, slpa)
    prop = dict(q=q0, U=U0, g=g0, energy=E0, weight=0.0, slpa=-np.inf)
    left = dict(q=q0, p=p0, U=U0, g=g0)
    right = dict(q=q0, p=p0, U=U0, g=g0)
    psum = p0.copy()

    K = max_num_expansions
    num_doublings = 0
    total_leaves = 0
    is_diverging = False
    is_turning = False
    accept_prob = 0.0
    energy_out = E0

    def is_turning_fn(p_l, p_r, rho_sum):
        rho = rho_sum - (p_r + p_l) / 2.0
        v = apply_im(rho)
        return (np.sum(p_l * v) <= 0) or (np.sum(p_r * v) <= 0)

    for d in range(max_num_expansions):
        direction = float(directions[d])
        start = right if direction > 0 else left
        ck_p = np.zeros((K,) + q0.shape)
        ck_s = np.zeros((K,) + q0.shape)

        sub_prop = None
        sub_psum = np.zeros_like(q0)
        q, p, g = start["q"], start["p"], start["g"]
        sub_len = 0
        sub_div = False
        sub_term = False
        for i in range(2**d):
            q, p, g = leapfrog(q, p, g, direction)
            U = potential(q)
            energy = U + ke(p)
            delta = E0 - energy
            if np.isnan(delta):
                delta = -np.inf
            leaf_div = abs(delta) > divergence_threshold
            leaf = dict(
                q=q, U=U, g=g, energy=energy, weight=delta,
                slpa=min(delta, 0.0),
            )
            if i == 0:
                sub_prop = leaf
            else:
                u = float(u_leaf[2**d - 1 + i])
                # logit-space progressive-uniform compare:
                # u < sigmoid(x) <=> logit(u) < x; a NaN
                # weight delta compares False = reject
                with np.errstate(divide="ignore"):
                    u_logit = np.log(u) - np.log1p(-u)
                delta_w = leaf["weight"] - sub_prop["weight"]
                merged = dict(
                    weight=np.logaddexp(sub_prop["weight"], leaf["weight"]),
                    slpa=np.logaddexp(sub_prop["slpa"], leaf["slpa"]),
                )
                picked = leaf if u_logit < delta_w else sub_prop
                sub_prop = dict(
                    q=picked["q"], U=picked["U"], g=picked["g"],
                    energy=picked["energy"], **merged,
                )
            sub_psum = sub_psum + p
            sub_len += 1
            # checkpoint write at even leaves
            idx_max = _popcount(i >> 1)
            idx_min = idx_max - _trailing_ones(i) + 1
            if i % 2 == 0:
                ck_p[idx_max] = p
                ck_s[idx_max] = sub_psum
            # U-turn check at odd leaves
            term = False
            if i % 2 == 1:
                for k in range(idx_min, idx_max + 1):
                    rho_sum = sub_psum - ck_s[k] + ck_p[k]
                    if is_turning_fn(ck_p[k], p, rho_sum):
                        term = True
                        break
            if leaf_div or term:
                sub_div = bool(leaf_div)
                sub_term = bool(term)
                break

        total_leaves += sub_len
        num_doublings = d + 1
        sub_state = dict(q=q, p=p, U=potential(q), g=g)
        if direction > 0:
            new_left, new_right = left, sub_state
        else:
            new_left, new_right = sub_state, right
        psum = psum + sub_psum
        accept_prob = float(np.exp(sub_prop["slpa"]) / sub_len)

        merged_slpa = np.logaddexp(sub_prop["slpa"], prop["slpa"])
        if sub_div or sub_term:
            prop = dict(prop, slpa=merged_slpa)
        else:
            u = float(u_bias[d])
            p_accept = min(1.0, np.exp(sub_prop["weight"] - prop["weight"]))
            merged = dict(
                weight=np.logaddexp(prop["weight"], sub_prop["weight"]),
                slpa=merged_slpa,
            )
            picked = sub_prop if u < p_accept else prop
            prop = dict(
                q=picked["q"], U=picked["U"], g=picked["g"],
                energy=picked["energy"], **merged,
            )
        left, right = new_left, new_right
        turning = is_turning_fn(left["p"], right["p"], psum)
        is_diverging = sub_div
        is_turning = bool(turning)
        energy_out = prop["energy"]
        if sub_div or turning or sub_term:
            break

    return dict(
        position=prop["q"],
        potential_energy=prop["U"],
        potential_energy_grad=prop["g"],
        energy=energy_out,
        acceptance_probability=accept_prob,
        num_doublings=num_doublings,
        num_integration_steps=total_leaves,
        is_diverging=bool(is_diverging),
        is_turning=bool(is_turning),
    )
