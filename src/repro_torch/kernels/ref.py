"""Oracles for the kernels (the allclose targets of the tests and of the
card check).

The attention kernel's plain version lives beside it
(:func:`~repro_torch.kernels.flash_attention.flash_attention_plain`, an
independent full-softmax formulation); the sweep's oracle is the
production planner's own grid, as in ``repro.kernels.ref``."""
from __future__ import annotations


def jdob_sweep_ref(profile, fleet, edge, t_free=0.0, rho=0.03e9,
                   device=None):
    """Oracle = the batched core's (ñ × f_e) grid."""
    from repro_torch.core.jdob import jdob_energy_grid
    return jdob_energy_grid(profile, fleet, edge, t_free=t_free, rho=rho,
                            device=device)
