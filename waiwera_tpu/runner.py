"""pywaiwera-equivalent runner tooling.

The reference ships `pywaiwera` (utils/pywaiwera), a PyPI package whose
job is to run Waiwera conveniently from Python or a console script
(`waiwera-dkr`): pick a parallel process count, forward extra
arguments, and report the package version
(pywaiwera/docker.py:538-614, 671-760; pywaiwera/common.py:6).

This build needs no container: the runtime environment IS the
Python environment. This module reproduces the useful surface —

- run_waiwera(filename, ...): programmatic run (the
  DockerEnv.run_waiwera analogue); num_devices maps to the reference's
  mpiexec `-np` (run.rst:140-144), executing the model over a
  jax.sharding device mesh in-process.
- main(): the `waiwera-tpu-run` console entry point mirroring
  `waiwera-dkr`'s argument set where it still makes sense
  (`-np/--num_processes` kept as an alias of --devices).
- get_pkg_version(): pywaiwera/common.py analogue.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def get_pkg_version() -> str:
    """Package version string (pywaiwera/common.py:6-16)."""
    from waiwera_tpu import __version__

    return __version__


def run_waiwera(
    filename: str,
    waiwera_args: Optional[List[str]] = None,
    num_processes: int = 1,
    verbose: bool = False,
    platform: Optional[str] = None,
):
    """Run a model from Python (DockerEnv.run_waiwera analogue,
    pywaiwera/docker.py:538-614).

    num_processes: device count for domain decomposition (the `-np`
    of the reference's mpiexec runs). Extra CLI arguments (e.g.
    `--set key value`) pass through to the CLI parser.
    """
    from waiwera_tpu import cli

    argv = [filename]
    if num_processes and int(num_processes) > 1:
        argv += ["--devices", str(int(num_processes))]
    if platform:
        argv += ["--platform", platform]
    if verbose:
        argv += ["--echo-log"]
    argv += list(waiwera_args or [])
    return cli.main(argv)


def main(argv=None):
    """`waiwera-tpu-run` console script (waiwera-dkr analogue,
    pywaiwera/docker.py:671-760; docker-specific options — repo/tag,
    image update, interactive shells — have no meaning without a
    container and are omitted)."""
    examples = "\n".join(
        [
            "examples:",
            "  python -m waiwera_tpu.runner input.json",
            "  python -m waiwera_tpu.runner -np 2 input.json",
            "  python -m waiwera_tpu.runner input.json "
            "--set time.step.size 1e5",
        ]
    )
    parser = argparse.ArgumentParser(
        description=(
            "Runs waiwera_tpu, the JAX parallel geothermal "
            "flow simulator"
        ),
        epilog=examples,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "filename", metavar="FILENAME", nargs="?", default="",
        help="model JSON input file",
    )
    parser.add_argument(
        "-np", "--num_processes", default=1,
        help="number of devices for domain decomposition "
        "(default 1; the reference's mpiexec -np)",
    )
    parser.add_argument(
        "--platform", default=None,
        help="JAX platform override (cpu/gpu)",
    )
    parser.add_argument(
        "-v", "--version", action="store_true",
        help="print the version and exit",
    )
    parser.add_argument(
        "waiwera_args", metavar="...", nargs=argparse.REMAINDER,
        help="additional arguments passed through to the CLI",
    )
    args = parser.parse_args(argv)
    if args.version:
        print(get_pkg_version())
        return 0
    if not args.filename:
        parser.print_help()
        return 1
    return run_waiwera(
        args.filename,
        waiwera_args=args.waiwera_args,
        num_processes=args.num_processes,
        platform=args.platform,
    )


if __name__ == "__main__":
    sys.exit(main() or 0)
