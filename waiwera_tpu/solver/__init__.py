"""Sparse linear algebra and nonlinear solvers in JAX.

From-scratch replacement for the PETSc stack the reference delegates to
(SURVEY.md section 2.8): block-CSR matrices, Krylov methods (BiCGStab,
GMRES), block preconditioners, and a SNES-style Newton driver.
"""
