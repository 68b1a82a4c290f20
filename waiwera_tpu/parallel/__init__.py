"""Multi-device domain decomposition.

The JAX counterpart of the reference's MPI parallelism
(DMPlexDistribute with overlap 1, PetscSF halo exchange —
mesh.F90:143-171, dm_utils.F90:1343-1448): cells are partitioned into
per-device blocks by recursive coordinate bisection, each device holds
its owned cells plus an overlap-1 halo, and halo exchange runs as XLA
collectives inside shard_map over a jax.sharding.Mesh.
"""

from waiwera_tpu.parallel.partition import PartitionPlan, build_partition
from waiwera_tpu.parallel.spmd import DistributedSimulation, DistributedSystem
