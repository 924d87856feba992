"""The plain-jnp energy gradient and update against an independent numpy
reference.

The reference is built only from numpy/scipy primitives — ``np.gradient``
for every first derivative, an edge-padded 1-(-2)-1 stencil for the
Laplacian, ``scipy.ndimage.map_coordinates`` for the trilinear resample
and ``scipy.ndimage.convolve1d`` for the Sobolev filter — and follows the
energy definitions in ``ops/terms.py``'s module docstring. Cases cover
band-union masking × Killing/Tikhonov × level-set on/off × Sobolev taps ×
an odd-sized volume and an edge-dominated one.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from levelsetfusion_tpu.models import SolverParams, solve_single_level
from levelsetfusion_tpu.ops import sobolev
from levelsetfusion_tpu.ops.gradient import SmoothingMode, warp_energy_gradient

BAND_EPS = 1e-5
GAMMA = 0.1


def resample_ref(field, warp):
    """Trilinear resample at x + u(x), +1 outside the grid."""
    grid = np.meshgrid(*[np.arange(n) for n in field.shape], indexing="ij")
    coords = [g + warp[..., a] for a, g in enumerate(grid)]
    return ndimage.map_coordinates(
        field, coords, order=1, mode="grid-constant", cval=1.0
    )


def laplacian_ref(u):
    """Per-component 1-(-2)-1 Laplacian with replicated edges."""
    d = u.ndim - 1
    out = np.zeros_like(u)
    for ax in range(d):
        pad = [(0, 0)] * u.ndim
        pad[ax] = (1, 1)
        up = np.pad(u, pad, mode="edge")
        n = u.shape[ax]
        out += (
            np.take(up, range(2, n + 2), axis=ax)
            - 2 * u
            + np.take(up, range(0, n), axis=ax)
        )
    return out


def sobolev_kernel_ref(size, strength):
    """Unit-sum central column of (I - λ L)^-1, L the 1-(-2)-1 matrix."""
    lap = -2 * np.eye(size) + np.eye(size, k=1) + np.eye(size, k=-1)
    delta = np.zeros(size)
    delta[size // 2] = 1.0
    k = np.linalg.solve(np.eye(size) - strength * lap, delta)
    return k / k.sum()


def gradient_ref(canonical, live, warp, *, band_union, killing, w_ls,
                 taps, w_smooth=0.2):
    d = canonical.ndim
    warped = resample_ref(live, warp)
    g = np.stack(np.gradient(warped), axis=-1)
    if band_union:
        mask = (np.abs(canonical) < 1 - BAND_EPS) | (
            np.abs(warped) < 1 - BAND_EPS
        )
    else:
        mask = np.ones(canonical.shape, bool)
    diff = np.where(mask, warped - canonical, 0.0)
    total = diff[..., None] * g
    e_data = 0.5 * np.sum(diff * diff)

    jac = np.stack(
        [np.stack(np.gradient(warp[..., c]), axis=-1) for c in range(d)],
        axis=-2,
    )  # J[..., c, ax] = d u_c / d x_ax
    lap = laplacian_ref(warp)
    if killing:
        div = sum(np.gradient(warp[..., c], axis=c) for c in range(d))
        gdiv = np.stack(np.gradient(div), axis=-1)
        g_s = -(1 + GAMMA) * lap - gdiv
        sym = jac + np.swapaxes(jac, -1, -2)
        e_s = 0.5 * (0.5 * np.sum(sym * sym) + GAMMA * np.sum(jac * jac))
    else:
        g_s = -lap
        e_s = 0.5 * np.sum(jac * jac)
    total = total + w_smooth * g_s
    e_s = w_smooth * e_s

    e_ls = 0.0
    if w_ls:
        hess = np.stack(
            [np.stack(np.gradient(g[..., i]), axis=-1) for i in range(d)],
            axis=-2,
        )
        norm = np.sqrt(np.sum(g * g, axis=-1))
        scale = np.where(mask, (norm - 1) / (norm + 1e-5), 0.0)
        g_ls = scale[..., None] * np.einsum("...ij,...j->...i", hess, g)
        total = total + w_ls * g_ls
        e_ls = w_ls * 0.5 * np.sum(np.where(mask, (norm - 1) ** 2, 0.0))

    if taps:
        k = sobolev_kernel_ref(taps, 0.1)
        for ax in range(d):
            total = ndimage.convolve1d(
                total, k, axis=ax, mode="constant", cval=0.0
            )
    return total, (e_data, e_s, e_ls)


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape)
    canonical = np.tanh(base * 0.5)
    live = np.tanh(np.roll(base, 1, axis=0) * 0.5 + 0.1)
    # Mostly small motion plus a few voxels pushed far out of the grid.
    warp = rng.uniform(-1.5, 1.5, shape + (3,))
    warp[0, 0, 0] = (4.0, -3.0, 2.5)
    return canonical, live, warp


SHAPES = {"odd": (9, 7, 11), "edges": (3, 4, 5)}
CASES = list(
    itertools.product(
        [True, False],  # band_union
        [True, False],  # killing
        [0.0, 0.1],  # level-set weight
        [None, 5, 7],  # Sobolev taps
        sorted(SHAPES),
    )
)


@pytest.mark.parametrize("band_union,killing,w_ls,taps,shape", CASES)
def test_gradient_matches_numpy_reference(band_union, killing, w_ls, taps,
                                          shape):
    canonical, live, warp = _fields(SHAPES[shape], seed=len(shape) + 3)
    ref, (e_d, e_s, e_l) = gradient_ref(
        canonical, live, warp, band_union=band_union, killing=killing,
        w_ls=w_ls, taps=taps,
    )
    kernel = (
        jnp.asarray(sobolev.generate_1d_sobolev_kernel(taps, 0.1))
        if taps else None
    )
    mode = SmoothingMode.KILLING if killing else SmoothingMode.TIKHONOV
    got = jax.jit(
        lambda c, l, w: warp_energy_gradient(
            c, l, w, smoothing_term_weight=0.2, level_set_term_weight=w_ls,
            smoothing_mode=mode, rigidity_enforcement_factor=GAMMA,
            band_union_only=band_union, sobolev_kernel=kernel,
        )
    )(*(jnp.asarray(a, jnp.float32) for a in (canonical, live, warp)))
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(
        np.asarray(got.gradient), ref, rtol=2e-4, atol=2e-5 * scale
    )
    np.testing.assert_allclose(float(got.energies.data), e_d, rtol=1e-4)
    np.testing.assert_allclose(float(got.energies.smoothing), e_s, rtol=1e-4)
    np.testing.assert_allclose(
        float(got.energies.level_set), e_l, rtol=1e-4, atol=1e-6
    )


@pytest.mark.parametrize("killing", [True, False])
def test_solver_update_step_matches_reference(killing):
    """One solver iteration: u' = u − η·g, and the telemetry row holds the
    term energies and the max/mean update length."""
    canonical, live, warp = _fields((9, 7, 11), seed=11)
    rate = 0.3
    params = SolverParams(
        learning_rate=rate, max_iterations=1, convergence_threshold=0.0,
        smoothing_term_weight=0.2, level_set_term_weight=0.1,
        smoothing_mode=(
            SmoothingMode.KILLING if killing else SmoothingMode.TIKHONOV
        ),
        rigidity_enforcement_factor=GAMMA, sobolev_smoothing=True,
    )
    ref, (e_d, e_s, e_l) = gradient_ref(
        canonical, live, warp, band_union=True, killing=killing, w_ls=0.1,
        taps=7,
    )
    upd = -rate * ref
    ulen = np.sqrt(np.sum(upd * upd, axis=-1))
    res = solve_single_level(
        jnp.asarray(canonical, jnp.float32), jnp.asarray(live, jnp.float32),
        params, initial_warp=jnp.asarray(warp, jnp.float32),
    )
    np.testing.assert_allclose(
        np.asarray(res.warp), warp + upd, rtol=1e-5, atol=2e-5
    )
    tel = res.telemetry
    np.testing.assert_allclose(float(tel.data_energy[0]), e_d, rtol=1e-4)
    np.testing.assert_allclose(float(tel.smoothing_energy[0]), e_s, rtol=1e-4)
    np.testing.assert_allclose(float(tel.level_set_energy[0]), e_l, rtol=1e-4)
    np.testing.assert_allclose(float(tel.max_warp_update[0]), ulen.max(),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tel.mean_warp_update[0]), ulen.mean(),
                               rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(res.max_abs_displacement),
        np.max(np.abs(np.stack([warp, warp + upd])), axis=(0, 1, 2, 3)),
        rtol=1e-5,
    )
