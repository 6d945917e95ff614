"""Console entry point — the equivalent of the reference's
main.cpp (argument parsing, config load, run, progress UI;
reference: src/main.cpp:59-159, 376-459, 464-579).

Usage:
    python -m hipims_tpu --config-file model.xml [--quiet] [--mesh N]
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="hipims-tpu",
        description="2D shallow-water flood simulator (JAX)")
    ap.add_argument("--config-file", "-c", required=True,
                    help="XML configuration file (HiPIMS schema)")
    ap.add_argument("--log-file", "-l", default=None)
    ap.add_argument("--quiet-mode", "-q", "-s", action="store_true",
                    help="no user feedback (-s is the reference's alias)")
    ap.add_argument("--disable-screen", "-n", action="store_true",
                    help="plain line-by-line progress output")
    ap.add_argument("--mpi-mode", "-m", action="store_true",
                    help="accepted for reference compatibility; rank "
                         "gating is automatic under --distributed")
    ap.add_argument("--code-dir", "-x", default=None,
                    help="accepted for reference compatibility; there is "
                         "no OpenCL code to locate (ignored)")
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard over this many devices (2-D mesh)")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu, gpu); like the "
                         "reference's deviceFilter")
    ap.add_argument("--mesh-shape", default=None,
                    help="explicit mesh shape, e.g. 2x4")
    ap.add_argument("--distributed", default=None, metavar="SPEC",
                    help="multi-host init: 'env' (everything from the "
                         "cluster environment) or "
                         "'coordinator:port,num_processes,process_id'")
    ap.add_argument("--precision", default=None,
                    choices=("double", "float", "compensated"),
                    help="override the XML floatingPointPrecision (e.g. "
                         "run a reference 'double' model in native f64 "
                         "instead of the compensated f32 mode)")
    ap.add_argument("--io-mode", default=None,
                    choices=("auto", "gather", "stream"),
                    help="output/checkpoint gathering: full-grid gather, "
                         "bounded streamed chunks (large grids), or "
                         "auto by grid size (default)")
    ap.add_argument("--mass-balance", action="store_true",
                    help="log the domain water volume at every output "
                         "time (the papers' <1%% budget check as a "
                         "runtime observable)")
    ap.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="(re)write a resumable checkpoint (.npz) at "
                         "every output time")
    ap.add_argument("--resume", default=None, metavar="FILE",
                    help="resume from a checkpoint written with "
                         "--checkpoint (skips already-written outputs)")
    return ap.parse_args(argv)


def _set_platform(platform: str) -> bool:
    """Apply a jax_platforms hint; returns False when it cannot take
    effect (the JAX backend was already initialised in-process by an
    embedding caller).  The probe uses a private symbol, so the OUTCOME
    is verified directly afterwards — on any JAX version, a silent no-op
    update is detected by checking the actual backend platform."""
    import jax
    try:
        from jax._src import xla_bridge
        if xla_bridge.backends_are_initialized():
            return False
    except (ImportError, AttributeError):
        pass                                # verified below instead
    try:
        jax.config.update("jax_platforms", platform)
    except RuntimeError:
        return False
    try:
        want = platform.split(",")[0].strip().lower()
        return jax.devices()[0].platform.lower() == want
    except RuntimeError:
        return False


def main(argv=None):
    args = parse_args(argv)

    platform_warning = None
    if args.platform:
        if not _set_platform(args.platform):
            platform_warning = (
                f"WARNING: --platform {args.platform} ignored: the JAX "
                "backend was already initialised before cli.main() ran; "
                "set JAX_PLATFORMS in the environment instead")

    coordinator = True
    if args.distributed is not None:
        # Multi-host SPMD: every process runs this same program; only the
        # coordinator logs and writes outputs (reference: rank-0-only
        # console under --mpi-mode, src/main.cpp:561-578).
        from .parallel.distributed import initialize_cluster, is_coordinator
        if args.distributed.strip().lower() == "env":
            initialize_cluster()
        else:
            addr, n_proc, proc_id = args.distributed.split(",")
            initialize_cluster(addr.strip(), int(n_proc), int(proc_id))
        coordinator = is_coordinator()

    from .io.xml_config import load_config
    from .utils.logging import Logger
    from .runtime.progress import ProgressReporter

    log = Logger(path=args.log_file if coordinator else None,
                 quiet=args.quiet_mode or not coordinator)
    log.block("Model configuration")
    if platform_warning:
        log.line(platform_warning)
    if args.mpi_mode:
        log.line("note: --mpi-mode is a no-op here; multi-process runs "
                 "use --distributed (rank gating is automatic)")
    if args.code_dir:
        log.line("note: --code-dir ignored (no OpenCL sources to locate)")
    try:
        model = load_config(args.config_file)
    except FileNotFoundError as e:
        log.error(f"Cannot open model file: {e.filename or e}")
        return 1
    except (ValueError, KeyError) as e:
        log.error(f"Invalid model configuration: {e}")
        return 1
    log.line(f"  Name:        {model.name}")
    log.line(f"  Scheme:      {model.config.scheme}")
    log.line(f"  Duration:    {model.config.duration:.0f} s")
    log.line(f"  Output freq: {model.config.output_frequency:.0f} s")
    if args.precision:
        model.config.dtype = {"double": "float64", "float": "float32",
                              "compensated": "float32c"}[args.precision]
    if args.io_mode:
        model.config.io_mode = args.io_mode
    log.line(f"  Grid:        {model.domain.rows} x {model.domain.cols} "
             f"@ {model.domain.dx} m")
    log.line(f"  Precision:   {model.config.dtype}")
    if model.platform_hint and not args.platform:
        # <executor deviceFilter="CPU"> and no --platform override: honour
        # the config's platform preference (reference: device-type filter,
        # src/OpenCL/Executors/CExecutorControlOpenCL.cpp:211-281).
        if args.distributed is not None:
            # initialize_cluster already initialised the JAX backend, so
            # a jax_platforms update here would be ineffective (or raise)
            # — the launcher environment owns platform choice.
            log.line("WARNING: deviceFilter platform hint ignored "
                     "under --distributed (backend already "
                     "initialised); use --platform or JAX_PLATFORMS")
        elif _set_platform(model.platform_hint):
            log.line(f"  Platform:    {model.platform_hint} "
                     "(from deviceFilter)")
        else:
            log.line("WARNING: deviceFilter platform hint ignored "
                     "(JAX backend already initialised in-process); "
                     "use JAX_PLATFORMS or --platform at launch")

    import jax
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    devices = jax.devices()
    log.line(f"  Device:      {devices[0].platform} "
             f"{devices[0].device_kind} x{len(devices)}")

    mesh = None
    if args.mesh or args.mesh_shape:
        from .parallel import make_mesh
        shape = None
        if args.mesh_shape:
            a, b = args.mesh_shape.lower().split("x")
            shape = (int(a), int(b))
        mesh = make_mesh(args.mesh, shape=shape)
        log.line(f"  Mesh:        {mesh.devices.shape} "
                 f"({mesh.devices.size} devices)")

    try:
        sim = model.simulation(mesh=mesh)
    except ValueError as e:
        log.error(f"Invalid model configuration: {e}")
        return 1
    if mesh is not None:
        # Per-device block table (the reference's per-domain table,
        # src/CModel.cpp:343-462 — static under SPMD lock-step).
        from .runtime.progress import device_table
        for ln in device_table(sim):
            log.line(ln)
    if not coordinator:
        # Non-coordinator processes must run the output path too — its
        # state gathers are global collectives, so skipping them would
        # deadlock the cluster at the first output — but must not
        # double-write files (reference: rank-0-only output,
        # src/main.cpp:561-578).
        sim.write_outputs = False
    if args.resume:
        from .runtime.checkpoint import load_checkpoint
        try:
            load_checkpoint(args.resume, sim)
        except (ValueError, FileNotFoundError) as e:
            log.error(f"Cannot resume: {e}")
            return 1
        log.line(f"  Resumed:     t={sim.t:.1f} s from {args.resume}")
    if args.checkpoint:
        sim.checkpoint_path = args.checkpoint
    if args.mass_balance:
        # Ride the writer chain so the volume comes from the output
        # event's already-gathered snapshot (no extra collectives).
        from .runtime.output import domain_volume
        inner_writer = sim.output_writer
        vol0 = sim.volume()

        def mass_writer(view, t):
            if inner_writer is not None:
                inner_writer(view, t)
            vol = domain_volume(view, sim.domain)
            log.line(f"  Mass balance: t={t:.1f}s volume={vol:.3f} m3 "
                     f"(delta {vol - vol0:+.3f} vs start)")

        sim.output_writer = mass_writer
    reporter = ProgressReporter(log, sim, quiet=args.quiet_mode
                                or not coordinator)

    log.block("Simulation")
    t0 = time.monotonic()
    try:
        sim.run(progress=reporter)
    except KeyboardInterrupt:
        log.line("Interrupted — writing final state")
        sim.emit_output(sim.t)
        return 2
    wall = time.monotonic() - t0
    reporter.final(wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
