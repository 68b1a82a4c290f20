"""waiwera_tpu: a JAX geothermal flow simulation framework.

A from-scratch JAX/XLA rebuild of the capabilities of Waiwera
(parallel geothermal flow simulator): multi-phase, multi-component
subsurface flow on unstructured finite-volume meshes with Newton-Krylov
implicit timestepping.

Importing this package enables float64 in JAX (the physics requires it;
hot linear-algebra paths downcast internally where safe).
"""

import jax

jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
