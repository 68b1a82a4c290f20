"""Smoke check: the implicit timestep runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one GPU:

    python3 chip_smoke.py

Phases, all in this one process:

1. device: platform, device kind and count, the card's name and power
   limit from nvidia-smi, whether the native host library built and
   whether h5py imports;
2. spmv: the band SpMV (ops.dia.jnp_matvec) at the flagship width
   (524,288 cells, 3x3 blocks, 7 bands) against the BSR gather matvec
   in f64 and f32, and its achieved bandwidth beside a plain-JAX copy
   moving the same bytes;
3. numerics: a 16x16x8 eos_wge box for 3 accepted steps on the GPU and
   on the host CPU backend, final primaries compared;
4. main: the 128x64x64 eos_wge flagship written as a Waiwera JSON and
   run through the CLI (waiwera_tpu.cli.main) for 3 accepted steps.

With --four-cards only the domain-decomposition path runs: the
flagship through the CLI with --devices 4 against the same model on
one card.

Every check raises on failure. Only a passing run prints its last
line, one JSON object naming the device. The script exits non-zero
when JAX's first device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = (128, 64, 64)
NUMERICS_BOX = (16, 16, 8)
STEPS = 3
SEED = 0
FOUR_CARDS = 4

# Band SpMV against the BSR reference, per row relative to |A||x|: a
# row sum of 21 products rounds by at most ~23 units of roundoff (f64
# 2.6e-15, f32 1.4e-6). TF32 products (2^-11) would miss the f32 bound.
F64_TOL = 1e-12
F32_TOL = 1e-5
# Final fields of two runs of one model, max |a - b| / max(max |b|, 1)
# per field: the runs differ in the f32 Krylov solves' rounding and
# reduction order, which moves a converged Newton iterate by a fraction
# of the linear tolerance (1e-5) times the last update. f32 against
# f64 Krylov solves differ by ~5e-9 at 16x16x8 on a CPU.
FIELD_TOL = 1e-6

_COMPILE_EVENT = "/jax/core/compile/"


def _pin_environment() -> None:
    """Deterministic hashing, so traces and the compile cache repeat
    across processes, and the CPU backend beside the GPU for the
    numerics phase. Re-executes once when either needs changing."""
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = "0"
    platforms = env.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        env["JAX_PLATFORMS"] = platforms + ",cpu"
    if env != dict(os.environ):
        os.execve(sys.executable, [sys.executable] + sys.argv, env)


def require_gpu(devices):
    """The first JAX device if it is a GPU; exits non-zero otherwise."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); this check needs an NVIDIA GPU"
        )
    return dev


def flagship_json(dims, steps, title="flagship") -> dict:
    """The benchmark's flagship box as a Waiwera JSON model: generated
    rectangular mesh, mixed-precision Newton-Krylov as in bench.py."""
    import bench

    nx, ny, nz = dims
    config = bench.flagship_config(nx, ny, nz)
    config["title"] = title
    config["mesh"] = {
        "type": "rectangular",
        "dx": [50.0] * nx,
        "dy": [50.0] * ny,
        "dz": [20.0] * nz,
    }
    config["time"]["step"].update({
        "maximum": {"number": steps},
        "solver": {
            "nonlinear": {"minimum": {"iterations": 1}},
            "linear": {
                "type": "bcgs",
                "preconditioner": {"type": "bjacobi"},
                "dtype": "float32",
                "jacobian_dtype": "float32",
            },
        },
    })
    return config


_LOG_LINE = re.compile(r"^- \[(\w+), ([\w.]+), ([\w.]+), \{(.*)\}\]$")


def read_log(path):
    """[(source, event, {key: value})] from a Waiwera YAML log."""
    out = []
    with open(path) as f:
        for line in f:
            m = _LOG_LINE.match(line.strip())
            if not m:
                continue
            data = {}
            for item in filter(None, m.group(4).split(", ")):
                k, _, v = item.partition(": ")
                try:
                    data[k] = json.loads(v)
                except json.JSONDecodeError:
                    data[k] = v
            out.append((m.group(2), m.group(3), data))
    return out


class CompileClock:
    """Host seconds spent tracing, lowering and compiling, from JAX's
    monitoring events. Nested jits report nested intervals, so the
    clock measures the union of the intervals, not their sum."""

    def __init__(self):
        import jax

        self.intervals = []
        jax.monitoring.register_event_duration_secs_listener(self._record)

    def _record(self, event, seconds, **_):
        if event.startswith(_COMPILE_EVENT):
            end = time.perf_counter()
            self.intervals.append((end - seconds, end))

    def seconds(self, start, end):
        """Length of the union of compile intervals within [start, end]."""
        total, reach = 0.0, start
        for a, b in sorted(self.intervals):
            a, b = max(a, reach), min(b, end)
            if b > a:
                total += b - a
                reach = b
        return total


def run_cli(json_path, workdir, tag, devices=1):
    """Run one model through the CLI, with output and log in workdir.
    Where h5py is missing the same objects are driven without HDF5
    output, as cli.run_json does. Returns the log records, the final
    fields and the host-clock interval of the run."""
    out = os.path.join(workdir, f"{tag}.h5")
    log = os.path.join(workdir, f"{tag}.yaml")
    args = [json_path, "--set", f"output.filename={out}",
            "--set", f"logfile.filename={log}"]
    if devices > 1:
        args += ["--devices", str(devices)]
    t0 = time.perf_counter()
    if _have_h5py():
        from waiwera_tpu import cli

        rc = cli.main(args)
        fields = _final_h5_fields(out)
    else:
        rc, fields = _run_without_output(json_path, log, devices)
    return rc, read_log(log), fields, (t0, time.perf_counter())


def _have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def _final_h5_fields(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {
            k: np.asarray(f["cell_fields"][k][-1])
            for k in f["cell_fields"]
            if np.issubdtype(f["cell_fields"][k].dtype, np.floating)
        }


def _run_without_output(json_path, log, devices):
    import jax
    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.sim.timestepper import Timestepper
    from waiwera_tpu.utils.compile_cache import enable_compile_cache
    from waiwera_tpu.utils.config import TrackedConfig
    from waiwera_tpu.utils.logging import Logger

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    with open(json_path) as f:
        config = TrackedConfig(json.load(f))
    sim = Simulation(config)
    if devices > 1:
        from waiwera_tpu.parallel import DistributedSimulation

        sim = DistributedSimulation(sim, devices)
    logger = Logger(filename=log)
    try:
        ts = Timestepper(config, sim, output=None, logger=logger)
        config.defaults.log_to(logger)
        ts.run()
    finally:
        logger.close()
    y = ts.final_y
    if devices > 1:
        y = sim.to_global(y)
    return (1 if ts.aborted else 0), {"primary_scaled": np.asarray(y)}


def summarize(records):
    """Tries, accepted steps, per-try counts, loop seconds and the
    banded-plan flag from a run's log records."""

    def pick(source, event):
        return [d for s, e, d in records if (s, e) == (source, event)]

    tries = pick("nonlinear_solver", "end")
    steps = pick("timestep", "end")
    end = pick("timestepper", "end")
    dof = pick("simulation", "dof")
    return {
        "tries": len(tries),
        "accepted": len(steps),
        "converged": [d["converged"] is True for d in tries],
        "newton": [int(d["iterations"]) for d in tries],
        "krylov": [int(d["linear_iterations"]) for d in tries],
        "elapsed": float(end[-1]["elapsed_seconds"]) if end else None,
        "banded": dof[-1].get("banded") if dof else None,
    }


def field_mismatch(a, b):
    """max over fields of max |a - b| / max(max |b|, 1)."""
    worst = 0.0
    for k in b:
        scale = max(float(np.max(np.abs(b[k]))), 1.0)
        worst = max(worst, float(np.max(np.abs(a[k] - b[k]))) / scale)
    return worst


def _assert_finite(fields, what):
    for k, v in fields.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{what}: non-finite values in {k}")


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------


def device_phase(devices):
    import jax
    from waiwera_tpu import native
    from waiwera_tpu.utils.compile_cache import enable_compile_cache

    dev = devices[0]
    print(f"# device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)} jax={jax.__version__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print("# nvidia-smi --query-gpu=name,power.limit:")
    print(smi)
    print(f"# native host library: {native.available()}; "
          f"h5py: {_have_h5py()}")
    print(f"# compile cache: {enable_compile_cache()}", flush=True)


def _chain_seconds(step, x0, *operands):
    """Device seconds per application of step(x, *operands) from a
    jitted fori_loop chain (slope between two chain lengths)."""
    import jax
    from jax import lax

    import bench

    def make_chain(k):
        @jax.jit
        def run(x, *ops):
            return lax.fori_loop(0, k, lambda i, v: step(v, *ops), x)[:1]

        return lambda: run(x0, *operands)

    return bench.time_fori(make_chain, 10, 110)


def spmv_phase(dims):
    """Band SpMV against the BSR gather matvec at the given width, and
    its bandwidth beside a copy of the same bytes."""
    import jax.numpy as jnp

    import bench
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.ops import dia
    from waiwera_tpu.solver import bsr

    nx, ny, nz = dims
    mesh = rectangular_mesh([50.0] * nx, [50.0] * ny, [20.0] * nz)
    n = mesh.num_cells
    st = bsr.build_structure(n, np.asarray(mesh.face_cells), 3)
    ds = dia.dia_structure(st, np.asarray(mesh.is_ghost))
    if ds is None or len(ds.offsets) != 7:
        raise AssertionError(f"band structure not detected: {ds}")
    rng = np.random.default_rng(SEED)
    data = jnp.asarray(rng.standard_normal((st.indices.shape[0], 3, 3)))
    x = jnp.asarray(rng.standard_normal((n, 3)))
    mat = bsr.BSRMatrix(structure=st, data=data)
    y_ref = np.asarray(mat.matvec(x))
    scale = np.asarray(
        bsr.BSRMatrix(structure=st, data=jnp.abs(data)).matvec(jnp.abs(x))
    )
    print(f"# spmv: {n} cells, block 3, bands {ds.offsets}")
    for dtype, tol in ((jnp.float64, F64_TOL), (jnp.float32, F32_TOL)):
        m = dia.to_dia(mat, ds, dtype)
        y = np.asarray(dia.jnp_matvec(m, x.astype(dtype)))
        rel = float(np.max(np.abs(y - y_ref) / scale))
        name = jnp.dtype(dtype).name
        print(f"# spmv {name}: max |y - y_bsr| / (|A||x|) = {rel:.3e} "
              f"(limit {tol:.0e})")
        if not rel <= tol:
            raise AssertionError(f"band SpMV {name} off the BSR reference")
        # the chain rescales by 1/||A||_inf so iterates stay bounded
        row_sums = jnp.sum(
            jnp.abs(m.bands).reshape(-1, 3, 3, m.bands.shape[-1]),
            axis=(0, 2),
        )
        inv_norm = 1.0 / float(jnp.max(row_sums))
        offsets = m.offsets

        def step(v, bands, offsets=offsets, inv_norm=inv_norm):
            mm = dia.DIAMatrix(offsets, bands, 3, n)
            return dia.jnp_matvec(mm, v) * jnp.asarray(inv_norm, v.dtype)

        secs = _chain_seconds(step, x.astype(dtype), m.bands)
        nbytes = m.bands.nbytes + 2 * x.astype(dtype).nbytes
        copy = bench.measure_bandwidth(nbytes)
        print(f"# spmv {name}: {secs * 1e6:.1f} us/apply, "
              f"{nbytes / secs / 1e9:.1f} GB/s over {nbytes / 1e6:.1f} MB; "
              f"copy of the same bytes {copy / 1e9:.1f} GB/s; "
              f"ratio {nbytes / secs / copy:.3f}", flush=True)


def numerics_phase(dims, steps, workdir):
    """One small model on the GPU and on the host CPU backend."""
    import jax
    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.sim.timestepper import Timestepper
    from waiwera_tpu.utils.logging import Logger

    config = flagship_json(dims, steps, title="numerics")
    finals = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        log = os.path.join(workdir, f"numerics_{dev.platform}.yaml")
        with jax.default_device(dev):
            cfg = json.loads(json.dumps(config))
            sim = Simulation(cfg)
            logger = Logger(filename=log)
            try:
                ts = Timestepper(cfg, sim, output=None, logger=logger)
                ok = ts.run()
            finally:
                logger.close()
        y = ts.final_y
        if y.devices() != {dev}:
            raise AssertionError(f"numerics ran on {y.devices()}, not {dev}")
        if not (ok and ts.taken == steps):
            raise AssertionError(f"numerics on {dev.platform}: aborted")
        s = summarize(read_log(log))
        print(f"# numerics {dev.platform}: {s['accepted']} steps in "
              f"{s['tries']} tries, newton {s['newton']}, "
              f"krylov {s['krylov']}", flush=True)
        finals.append({"primary_scaled": np.asarray(y)})
    _assert_finite(finals[0], "numerics")
    rel = field_mismatch(finals[0], finals[1])
    print(f"# numerics: GPU vs CPU final primaries {rel:.3e} "
          f"(limit {FIELD_TOL:.0e})")
    if not rel <= FIELD_TOL:
        raise AssertionError("GPU and CPU runs disagree")


def _report_run(what, rc, records, fields, interval, clock, steps):
    s = summarize(records)
    if rc != 0:
        raise AssertionError(f"{what}: run aborted")
    if s["accepted"] < steps:
        raise AssertionError(f"{what}: {s['accepted']} accepted steps")
    _assert_finite(fields, what)
    compile_s = clock.seconds(*interval)
    # the timestepper's loop ends just before the CLI returns; compile
    # events that finished inside the loop are taken off its time
    loop_start = interval[1] - s["elapsed"]
    net = s["elapsed"] - clock.seconds(loop_start, interval[1])
    print(f"# {what}: {s['accepted']} accepted steps in {s['tries']} "
          f"tries; newton {s['newton']}; krylov {s['krylov']}; "
          f"banded plan {s['banded']}")
    print(f"# {what}: compile {compile_s:.1f} s; "
          f"{net / s['accepted']:.3f} s per accepted step "
          f"(host clock; compile excluded; failed tries, output and "
          f"host work included); "
          f"run {interval[1] - interval[0]:.1f} s wall", flush=True)
    return s


def main_phase(dims, steps, workdir, clock):
    import jax

    path = os.path.join(workdir, "flagship.json")
    with open(path, "w") as f:
        json.dump(flagship_json(dims, steps), f)
    n = dims[0] * dims[1] * dims[2]
    if _have_h5py():
        print(f"# main: {n} cells eos_wge through waiwera_tpu.cli.main",
              flush=True)
    else:
        print(f"# main: {n} cells eos_wge; h5py missing, so Simulation "
              "and Timestepper run without HDF5 output as cli.run_json "
              "builds them", flush=True)
    rc, records, fields, interval = run_cli(path, workdir, "flagship")
    _report_run("main", rc, records, fields, interval, clock, steps)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"# main: peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
          "(process-wide, all phases so far)")


def four_card_phase(dims, steps, workdir, clock):
    """The flagship through the CLI on four cards and on one."""
    path = os.path.join(workdir, "flagship.json")
    with open(path, "w") as f:
        json.dump(flagship_json(dims, steps), f)
    runs = {}
    for devices in (FOUR_CARDS, 1):
        what = f"{devices} card{'s' if devices > 1 else ''}"
        rc, records, fields, interval = run_cli(
            path, workdir, f"flagship_{devices}", devices
        )
        runs[devices] = (
            _report_run(what, rc, records, fields, interval, clock, steps),
            fields,
        )
    (s4, f4), (s1, f1) = runs[FOUR_CARDS], runs[1]
    if s4["banded"] is not True:
        raise AssertionError("gather-free banded plan did not engage")
    # The same trajectory: every try ends the same way and each
    # converged solve takes the same Newton and about the same Krylov
    # iterations (bjacobi is partition-invariant). A failed try is a
    # diverging Newton solve; the iteration at which its chaotic
    # iterates trip a failure test depends on f32 rounding order, so
    # its counts are not compared.
    if s4["converged"] != s1["converged"]:
        raise AssertionError(
            f"try outcomes differ: {s4['converged']} vs {s1['converged']}"
        )

    def converged_only(s, key):
        return [v for v, ok in zip(s[key], s["converged"]) if ok]

    n4, n1 = converged_only(s4, "newton"), converged_only(s1, "newton")
    if n4 != n1:
        raise AssertionError(f"Newton iterations differ: {n4} vs {n1}")
    k4 = sum(converged_only(s4, "krylov"))
    k1 = sum(converged_only(s1, "krylov"))
    if not k4 <= 1.2 * k1 + 2:
        raise AssertionError(f"Krylov iterations {k4} vs {k1} on one card")
    rel = field_mismatch(f4, f1)
    print(f"# four cards vs one: converged solves Newton {n4} vs {n1}, "
          f"Krylov {k4} vs {k1}; final fields {rel:.3e} "
          f"(limit {FIELD_TOL:.0e})")
    if not rel <= FIELD_TOL:
        raise AssertionError("four-card and one-card fields disagree")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the flagship over four cards against one card",
    )
    args = parser.parse_args(argv)
    _pin_environment()

    import jax

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    dev = require_gpu(devices)
    if args.four_cards and len(devices) < FOUR_CARDS:
        raise SystemExit(f"chip_smoke: --four-cards needs {FOUR_CARDS} "
                         f"GPUs, found {len(devices)}")
    clock = CompileClock()
    device_phase(devices)
    with tempfile.TemporaryDirectory() as workdir:
        if args.four_cards:
            four_card_phase(FLAGSHIP, STEPS, workdir, clock)
        else:
            spmv_phase(FLAGSHIP)
            numerics_phase(NUMERICS_BOX, STEPS, workdir)
            main_phase(FLAGSHIP, STEPS, workdir, clock)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
