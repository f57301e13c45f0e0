"""Command-line interface.

Mirror of the reference's Typer CLI (``src/eradiate/cli/__init__.py:24-77``:
``eradiate sys-info``, ``eradiate data ...``, ``eradiate srf trim``),
implemented with argparse (typer is not available in this environment).

Run as ``python -m eradiate_tpu.cli <command>``.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_sys_info(args):
    """Environment diagnostics (mirror of ``cli/sys_info.py``)."""
    import platform

    import jax
    import numpy

    info = {
        "eradiate_tpu": __import__("eradiate_tpu").__version__,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "jax": jax.__version__,
        "numpy": numpy.__version__,
        "devices": [str(d) for d in jax.devices()],
        "default_backend": jax.default_backend(),
    }
    print(json.dumps(info, indent=2))


def cmd_data_paths(args):
    from .data import data_paths

    for p in data_paths():
        exists = "present" if p.exists() else "absent"
        print(f"{p}  [{exists}]")


def cmd_data_list(args):
    from .data import data_paths

    for base in data_paths():
        if not base.exists():
            continue
        for f in sorted(base.rglob("*.npz")):
            print(f.relative_to(base))


def cmd_data_install(args):
    """Install a dataset archive/directory into the user data dir (offline
    analog of ``eradiate data install``, ``cli/data.py:29-124``)."""
    from .data.asset_manager import install

    dest = install(args.source, name=args.name, sha256=args.sha256)
    print(f"installed -> {dest}")
    return 0


def cmd_data_remove(args):
    from .data.asset_manager import remove

    if remove(args.name):
        print(f"removed {args.name}")
        return 0
    print(f"no installed asset named {args.name!r}", file=sys.stderr)
    return 1


def cmd_data_installed(args):
    from .data.asset_manager import list_installed

    for name, entry in sorted(list_installed().items()):
        print(f"{name}\t{entry['path']}")
    return 0


def cmd_data_validate(args):
    from .data.validation import DatasetSchemaError, validate_dataset
    from .xr import Dataset

    if not str(args.path).endswith(".npz"):
        print(
            "validate supports the native .npz dataset format (import "
            "NetCDF data first; see eradiate_tpu.data.netcdf)",
            file=sys.stderr,
        )
        return 1
    ds = Dataset.from_npz(args.path)
    try:
        validate_dataset(ds, args.schema)
    except DatasetSchemaError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"{args.path}: valid ({args.schema})")
    return 0


def cmd_srf_trim(args):
    """Trim an SRF dataset (mirror of ``eradiate srf trim``,
    ``cli/srf.py:27``)."""
    import numpy as np

    from .srf_tools import trim_srf

    d = np.load(args.input)
    w, srf = trim_srf(
        d["w"], d["srf"], threshold=args.threshold, keep_integral=args.keep
    )
    np.savez(args.output, w=w, srf=srf)
    print(f"trimmed {d['w'].size} -> {w.size} points -> {args.output}")


def cmd_render(args):
    """Render a JSON experiment config end to end.

    Multi-process launches need no user code: initialization happens
    here from the ``ERADIATE_TPU_COORDINATOR`` /
    ``ERADIATE_TPU_NUM_PROCESSES`` / ``ERADIATE_TPU_PROCESS_ID`` env vars
    (plus ``ERADIATE_TPU_LOCAL_DEVICE_IDS`` when several processes share
    one host: one GPU each), BEFORE any backend-initializing JAX call, and
    the render runs on the global device mesh::

        ERADIATE_TPU_COORDINATOR=host0:1234 ERADIATE_TPU_NUM_PROCESSES=2 \\
            ERADIATE_TPU_PROCESS_ID=0 \\
            python -m eradiate_tpu.cli render scene.json --mesh auto
    """
    # the platform override uses the config API (it wins over the
    # JAX_PLATFORMS env var) and must precede any backend-initializing call
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.cpu_devices:
            jax.config.update("jax_num_cpu_devices", args.cpu_devices)

    # must precede any jax backend touch (see parallel.multihost)
    from .parallel import initialize

    multi = initialize()

    import eradiate_tpu
    from .experiments import AtmosphereExperiment, CanopyAtmosphereExperiment

    with open(args.config) as f:
        cfg = json.load(f)
    eradiate_tpu.set_mode(cfg.pop("mode", "mono"))
    cls = (
        CanopyAtmosphereExperiment if "canopy" in cfg else AtmosphereExperiment
    )
    exp = cls(**cfg)
    mesh = {"auto": "auto", "none": None}[args.mesh]
    result = eradiate_tpu.run(exp, mesh=mesh)
    import jax

    if multi and jax.process_index() != 0:
        return  # only the coordinator writes/prints results
    if args.output:
        result.to_npz(args.output)
        print(f"results -> {args.output}")
    else:
        print(result)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="eradiate_tpu", description="radiative transfer for Earth observation (CLI)"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("sys-info", help="show environment info").set_defaults(
        fn=cmd_sys_info
    )

    data = sub.add_parser("data", help="data store management")
    data_sub = data.add_subparsers(dest="data_command", required=True)
    data_sub.add_parser("paths", help="show search paths").set_defaults(
        fn=cmd_data_paths
    )
    data_sub.add_parser("list", help="list installed datasets").set_defaults(
        fn=cmd_data_list
    )
    validate = data_sub.add_parser(
        "validate", help="validate a dataset file against a schema"
    )
    validate.add_argument("path")
    validate.add_argument(
        "--schema", default="srf_v1",
        help="schema name (srf_v1, particle_dataset_v1)",
    )
    validate.set_defaults(fn=cmd_data_validate)
    inst = data_sub.add_parser(
        "install", help="install a local dataset archive or directory"
    )
    inst.add_argument("source", help="path to .zip/.tar[.gz] archive, "
                      "directory, or single data file")
    inst.add_argument("--name", default=None, help="install name")
    inst.add_argument("--sha256", default=None, help="expected checksum")
    inst.set_defaults(fn=cmd_data_install)
    rm = data_sub.add_parser("remove", help="remove an installed asset")
    rm.add_argument("name")
    rm.set_defaults(fn=cmd_data_remove)
    data_sub.add_parser(
        "installed", help="list assets installed via 'data install'"
    ).set_defaults(fn=cmd_data_installed)

    srf = sub.add_parser("srf", help="SRF tools")
    srf_sub = srf.add_subparsers(dest="srf_command", required=True)
    trim = srf_sub.add_parser("trim", help="trim an SRF dataset")
    trim.add_argument("input")
    trim.add_argument("output")
    trim.add_argument("--threshold", type=float, default=1e-3)
    trim.add_argument("--keep", type=float, default=None)
    trim.set_defaults(fn=cmd_srf_trim)

    render = sub.add_parser("render", help="run an experiment from JSON config")
    render.add_argument("config")
    render.add_argument("-o", "--output", default=None)
    render.add_argument(
        "--mesh", choices=["auto", "none"], default="auto",
        help="device mesh: 'auto' = all visible devices (multi-host "
        "honors ERADIATE_TPU_COORDINATOR et al.), 'none' = single device",
    )
    render.add_argument(
        "--platform", choices=["default", "cpu"], default="default",
        help="force the CPU backend via the jax config API (needed for "
        "CPU multi-process runs)",
    )
    render.add_argument(
        "--cpu-devices", type=int, default=None,
        help="with --platform cpu: number of local virtual CPU devices",
    )
    render.set_defaults(fn=cmd_render)

    args = parser.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
