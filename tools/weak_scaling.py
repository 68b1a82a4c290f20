"""Weak-scaling proxy on the virtual CPU device mesh.

Real multi-chip hardware is unavailable in this environment, so this
records the quantities that DO transfer from a virtual CPU mesh to
multi-card scaling (BASELINE.md >=80% DOF/s target,
/root/reference/doc/user/run.rst:140-144):

- Krylov iteration counts per step vs device count (preconditioner
  quality under domain decomposition — the reason MPI codes lose
  efficiency beyond granularity limits);
- halo traffic per step from the p2p exchange plan (bytes crossing
  device boundaries; O(surface), and on hardware it crosses the
  card-to-card links);
- whether the distributed gather-free banded path engages (per-device
  compute efficiency);
- wall time per step on the virtual mesh (NOT predictive of a GPU —
  CPU devices share host cores — but the trend exposes
  software-overhead regressions).

Fixed work per device (weak scaling): cells/device held constant while
the box grows along z with the device count.

Usage: python tools/weak_scaling.py [cells_per_device] > SCALING.md
"""

import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# fix the platform via jax.config before any backend initialises
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def build(nx, ny, nz):
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation

    n = nx * ny * nz
    top0 = n - nx * ny
    config = {
        "eos": {"name": "wge"},
        "initial": {"primary": [5.0e6, 220.0, 1.0e5], "region": 1},
        "rock": {
            "types": [
                {
                    "name": "res",
                    "permeability": [5e-14, 5e-14, 2e-14],
                    "porosity": 0.1,
                }
            ]
        },
        "boundaries": [
            {
                "primary": [1.0e5, 20.0, 1.0e3],
                "region": 1,
                "faces": {
                    "cells": list(range(top0, n)),
                    "normal": [0.0, 0.0, 1.0],
                },
            }
        ],
        "source": [
            {
                "cell": top0 + nx + 1,
                "deliverability": {"productivity": 1e-12,
                                   "pressure": 5.0e5},
                "direction": "production",
            },
            {"cell": nx + 1, "rate": 2.0, "enthalpy": 500.0e3},
        ],
    }
    mesh = rectangular_mesh(
        [50.0] * nx, [50.0] * ny, [20.0] * nz, origin=[0, 0, -20.0 * nz]
    )
    return Simulation(config, mesh=mesh)


def halo_bytes_per_sync(plan, npv):
    """Bytes sent across device boundaries per halo exchange: each
    p2p round sends the packed owned slots of one edge per device
    (f64 cell rows of npv values)."""
    total_slots = 0
    for d in range(plan.num_devices):
        for r in range(plan.p2p_send.shape[1]):
            # count real (non-pad) recv slots on the paired receiver:
            # send buffers are padded to the round's max edge; count
            # actual halo entries via recv (pad sentinel = n_local)
            total_slots += int(
                (plan.p2p_recv[d, r] < plan.n_local).sum()
            )
    return total_slots * npv * 8


def main():
    from waiwera_tpu.parallel.spmd import DistributedSystem
    from waiwera_tpu.solver.newton import NewtonParams

    # Fixed GLOBAL problem, varying device count: preconditioner
    # quality under decomposition is the solver-side quantity that
    # bounds scaling efficiency, and it must be measured on one
    # problem (a growing box changes the physics, not just the
    # partition). bjacobi (production default) is partition-invariant
    # by construction; asm (local DILU = restricted additive Schwarz
    # over the overlap-1 halos) is where decomposition can bite.
    nx, ny, nz = 24, 24, 24  # 13,824 cells / 41,472 dof
    sim = build(nx, ny, nz)
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    dt = jnp.asarray(1.0e4)

    rows = []
    for D in (1, 2, 4, 8):
        ds = DistributedSystem(sim, D)
        yl = ds.to_local(sim.y0)
        rl = ds.to_local(sim.region0)
        tl = ds.to_local(fluid0.temperature)
        Ll = ds.to_local(lhs0)
        args = (yl, rl, tl, Ll, Ll, jnp.asarray(0.0), dt, dt,
                jnp.asarray(1.0))
        row = dict(
            D=D, cells=nx * ny * nz,
            plan=ds._face_plan_common is not None,
            halo_bytes=halo_bytes_per_sync(
                ds.plan, sim.eos.num_primary_variables
            ),
        )
        for pc in ("bjacobi", "asm"):
            # gmres: monotone, near-deterministic iteration
            # counts (BiCGStab's counts are chaotic under reduction
            # reordering, which would swamp the partition effect)
            params = NewtonParams(
                max_iterations=8, min_iterations=1, linear_pc=pc,
                linear_method="gmres", linear_restart=40,
                # f64 end-to-end: in f32 this problem sits near
                # stagnation where iteration counts are chaotic and
                # would swamp the partition effect being measured
            )
            step = ds.make_step_fn(params, "beuler")
            res = step(*args)  # compile + warm
            float(np.asarray(res[0].max_residual))
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                r2 = step(*args)
                float(np.asarray(r2[0].max_residual))
                best = min(best, time.perf_counter() - t0)
            row[f"{pc}_its"] = int(res[0].linear_iterations)
            row[f"{pc}_newton"] = int(res[0].iterations)
            row[f"{pc}_s"] = best
        rows.append(row)
        print(
            f"# D={D} bjacobi={row['bjacobi_its']} its "
            f"({row['bjacobi_s']:.2f}s) asm={row['asm_its']} its "
            f"({row['asm_s']:.2f}s) halo/sync="
            f"{row['halo_bytes']/1e3:.1f}kB plan={row['plan']}",
            file=sys.stderr, flush=True,
        )

    r1 = rows[0]
    print("# Scaling proxy: preconditioner quality and halo traffic "
          "vs device count\n")
    print(f"One fixed eos_wge box ({nx}x{ny}x{nz} = {nx*ny*nz} cells, "
          "one BE step, virtual CPU mesh). Krylov iteration growth "
          "under decomposition is the solver-side bound on scaling "
          "efficiency and carries over to real multi-card hardware; "
          "CPU step "
          "times do not (devices share host cores) and are omitted "
          "from the table.\n")
    print("| devices | bjacobi Krylov its | vs 1-dev | asm Krylov its "
          "| vs 1-dev | halo kB/exchange | banded plan |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['D']} | {r['bjacobi_its']} | "
            f"{r['bjacobi_its'] / max(r1['bjacobi_its'], 1):.2f}x | "
            f"{r['asm_its']} | "
            f"{r['asm_its'] / max(r1['asm_its'], 1):.2f}x | "
            f"{r['halo_bytes'] / 1e3:.1f} | "
            f"{'yes' if r['plan'] else 'no'} |"
        )
    print()
    last = rows[-1]
    surf = last["halo_bytes"] / max(last["D"], 1)
    state = last["cells"] / last["D"] * 3 * 8
    print(
        f"At {last['D']} devices each device sends ~{surf/1e3:.1f} kB "
        f"per halo exchange vs ~{state/1e6:.2f} MB of local solution "
        "state — the O(N^(2/3)) surface term that crosses the "
        "card-to-card links (NVLink on a four-H100 host) beside the "
        "banded SpMV (parallel/spmd.py sync / "
        "linear_operator_from_parts)."
    )
    print(
        "\nbjacobi (production default) is exactly partition-"
        "invariant: identical preconditioning at any device count, so "
        "the solver imposes NO efficiency loss under decomposition; "
        "per-device work and the O(surface) halo term set the scaling "
        "limit (>=10k cells/device keeps the surface term small, the "
        "granularity guidance of run.rst:140-144)."
    )


if __name__ == "__main__":
    main()
