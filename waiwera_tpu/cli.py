"""Command-line driver.

Counterpart of waiwera.F90: reads a JSON model file, builds the
simulation, runs the timestepper, writes HDF5 output and a YAML log.

Usage: python -m waiwera_tpu.cli model.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _apply_overrides(config: dict, overrides):
    """Layer `path.to.key=value` command-line overrides onto the JSON
    config — the analogue of the reference's PETSc option database
    over JSON (waiwera.F90:75-84, SNES/KSPSetFromOptions). Values are
    parsed as JSON literals, falling back to strings."""
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"--set expects path=value, got {item!r}")
        path, _, raw = item.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        keys = path.split(".")
        d = config
        for k in keys[:-1]:
            nxt = d.get(k)
            if not isinstance(nxt, dict):
                nxt = {}
                d[k] = nxt
            d = nxt
        d[keys[-1]] = value


def run_json(filename: str, echo_log: bool = False, platform=None,
             num_devices: int = 0, overrides=None, profile_dir=None):
    """Load a JSON model file and run it. Returns the Timestepper.

    num_devices > 1 runs the simulation domain-decomposed over that
    many devices of the jax platform (the analogue of `mpiexec -np N
    waiwera`, doc/user/run.rst:140-144); 0 reads
    config["parallel"]["devices"] (default 1 = single device).
    overrides: list of "path.to.key=value" strings layered over the
    JSON before anything reads it.
    """
    import jax

    base = os.path.dirname(os.path.abspath(filename))
    with open(filename) as f:
        config = json.load(f)
    _apply_overrides(config, overrides)

    if platform:
        jax.config.update("jax_platforms", platform)
    jax.config.update("jax_enable_x64", True)
    from waiwera_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # pre-read parallel.devices BEFORE any backend initialisation:
    # Simulation(config) initialises the JAX backend, after which
    # jax_num_cpu_devices has no effect and a config-driven
    # multi-device CPU run would build a mesh smaller than its
    # partition (waiwera.F90's mpiexec -np N analogue must be known
    # up front)
    cfg_devices = int((config.get("parallel", {}) or {}).get("devices", 1))
    eff_devices = num_devices if num_devices else cfg_devices
    if eff_devices > 1:
        resolved = platform or os.environ.get(
            "JAX_PLATFORMS", ""
        ).split(",")[0]
        if resolved in ("", "cpu"):
            try:
                jax.config.update("jax_num_cpu_devices", eff_devices)
            except RuntimeError:
                # backends already initialised (an in-process caller):
                # the CPU device count is fixed, and DistributedSystem
                # reports too few devices itself
                pass

    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.sim.timestepper import Timestepper
    from waiwera_tpu.sim.output import HDF5Output
    from waiwera_tpu.utils.logging import Logger

    # mesh / restart filenames are relative to the JSON file
    mesh_cfg = config.get("mesh")
    if isinstance(mesh_cfg, str):
        config["mesh"] = os.path.join(base, mesh_cfg)
    elif isinstance(mesh_cfg, dict) and "filename" in mesh_cfg:
        mesh_cfg["filename"] = os.path.join(base, mesh_cfg["filename"])
    ic = config.get("initial")
    if isinstance(ic, dict) and ic.get("filename"):
        ic["filename"] = os.path.join(base, ic["filename"])

    ocfg = config.get("output", {}) or {}
    out_filename = ocfg.get(
        "filename",
        os.path.splitext(os.path.basename(filename))[0] + ".h5",
    )
    if not os.path.isabs(out_filename):
        out_filename = os.path.join(os.getcwd(), out_filename)

    lcfg = config.get("logfile", {}) or {}
    log_filename = None
    if lcfg.get("filename") or lcfg == {}:
        log_filename = lcfg.get(
            "filename",
            os.path.splitext(out_filename)[0] + ".yaml",
        )
    logger = Logger(
        filename=log_filename, echo=echo_log or bool(lcfg.get("echo"))
    )

    # default-value tracking on every config read (fson_mpi.F90:18-56)
    from waiwera_tpu.utils.config import TrackedConfig

    config = TrackedConfig(config)
    sim = Simulation(config)
    num_devices = eff_devices
    if num_devices > 1:
        from waiwera_tpu.parallel import DistributedSimulation

        sim = DistributedSimulation(sim, num_devices)
    output = HDF5Output(out_filename, sim)
    ts = Timestepper(config, sim, output=output, logger=logger)
    config.defaults.log_to(logger)
    try:
        if profile_dir:
            # jax profiler trace with the named scopes around the hot
            # sections (the reference's -log_view / PetscLogEvent
            # analogue, profiling.F90:28-64)
            import jax.profiler

            with jax.profiler.trace(profile_dir):
                ts.run()
        else:
            ts.run()
    finally:
        output.close()
        logger.close()
    return ts


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="waiwera-tpu",
        description="JAX geothermal flow simulator",
    )
    parser.add_argument("filename", help="JSON model input file")
    parser.add_argument(
        "-v", "--version", action="version", version="waiwera_tpu 0.1.0"
    )
    parser.add_argument(
        "--echo-log", action="store_true", help="echo log to stdout"
    )
    parser.add_argument(
        "--platform", default=None, help="jax platform override (cpu/gpu)"
    )
    parser.add_argument(
        "--devices", type=int, default=0,
        help="run domain-decomposed over N devices (like mpiexec -np N)",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a jax profiler trace of the run to DIR "
        "(the -log_view analogue; view with tensorboard)",
    )
    parser.add_argument(
        "--set", action="append", default=[], metavar="PATH=VALUE",
        help="override a JSON config entry, e.g. "
        "--set time.step.solver.linear.type=gmres (the PETSc "
        "command-line option layering analogue)",
    )
    args = parser.parse_args(argv)
    ts = run_json(args.filename, echo_log=args.echo_log,
                  platform=args.platform, num_devices=args.devices,
                  overrides=args.set, profile_dir=args.profile)
    return 0 if not ts.aborted else 1


if __name__ == "__main__":
    sys.exit(main())
