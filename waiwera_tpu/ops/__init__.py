"""Sparse compute kernels in XLA-friendly layouts.

- dia: gather-free banded (DIA) SpMV and preconditioners for
  rectilinear meshes
- ell: scatter-free block-sparse SpMV (ELL layout)
- mg: geometric multigrid on the pressure block (CPR)
"""

from waiwera_tpu.ops.dia import (  # noqa: F401
    DIAMatrix,
    DIAStructure,
    dia_structure,
    to_dia,
)
from waiwera_tpu.ops.ell import (  # noqa: F401
    ELLMatrix,
    ELLStructure,
    ell_structure,
    to_ell,
)
