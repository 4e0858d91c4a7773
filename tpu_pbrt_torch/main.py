"""Command-line entry point of the port (port of tpu_pbrt/main.py).

    python -m tpu_pbrt_torch.main scene.pbrt [-o out.exr] [--quick] [--device cpu]
        [--checkpoint ck.npz --checkpoint-every N] [--spp-chunk N] ...

pbrt-v3's flags (--outfile, --quick, --quiet, --verbose, --cropwindow,
--nthreads) and the reference's runtime tier (--spp-chunk, --checkpoint,
--checkpoint-every). The render runs on CUDA unless `--device cpu` asks
for the CPU (the counterpart of the reference's JAX_PLATFORMS=cpu); with
no GPU and no such request it exits with code 1. `--spp-chunk N` sets
the camera samples per render chunk (the reference parses it without
reading it). `--trace OUT.json` exports the render phases' span timeline
as a Chrome trace, `--metrics-path OUT.prom` the host metrics registry
as Prometheus text on exit, and `--faults PLAN` installs a chaos fault
plan (tpu_pbrt_torch/chaos grammar) before either comes online.
`--serve` runs the render service's stdin/JSONL daemon (protocol:
`python -m tpu_pbrt_torch.serve --help`) on the same device, with the
scenes on the command line submitted as its first jobs.

`--mesh N` (or the reference's `2,4`: their product) renders over N
ranks (parallel/mesh.py): N spawned processes, one card each (NCCL), or
N CPU processes under `--device cpu` (gloo); rank 0 writes the image and
the checkpoints. More ranks than cards renders on one card, with a
warning. `--multihost` joins a process group described by the
environment instead (RANK, WORLD_SIZE, LOCAL_RANK and
TORCH_PBRT_COORDINATOR_ADDRESS="host:port" of rank 0, as torchrun sets
them up): every process runs this command, and the mesh spans the group.
`--serve` with `--mesh N` serves over N ranks: rank 0 runs in this
process, submits the command line's scenes and reads the JSONL stream,
and the others follow its decisions (serve/service.py); `--serve
--multihost` does the same over the environment's group. A scene error
exits with code 1.
"""

from __future__ import annotations

import argparse
import sys


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-pbrt-torch",
        description="physically based renderer (pbrt-v3 scene compatible), PyTorch/CUDA port",
    )
    p.add_argument("scenes", nargs="*", help=".pbrt scene file(s) to render")
    p.add_argument(
        "--serve", action="store_true",
        help="run as a persistent render service: scenes given on the command line are "
        "submitted as initial jobs, then a stdin/JSONL daemon accepts submit/poll/preempt/"
        "cancel ops (protocol: python -m tpu_pbrt_torch.serve --help)",
    )
    p.add_argument("--outfile", "-o", default="", help="output image filename (overrides scene Film)")
    p.add_argument("--quick", action="store_true", help="reduce samples/resolution for a fast preview")
    p.add_argument("--quiet", action="store_true", help="suppress progress/warning messages")
    p.add_argument("--verbose", "-v", action="store_true", help="verbose logging")
    p.add_argument(
        "--cropwindow", nargs=4, type=float, metavar=("X0", "X1", "Y0", "Y1"),
        help="render only this fraction of the image",
    )
    p.add_argument("--nthreads", type=int, default=0, help="host threads for scene compile (0 = all)")
    p.add_argument("--spp-chunk", type=int, default=0,
                   help="camera samples per render chunk (0 = the device default)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint file: resume from it if present, write to it while rendering")
    p.add_argument("--checkpoint-every", type=int, default=16, help="chunks between checkpoint writes")
    p.add_argument("--device", default=None,
                   help="torch device to render on: cuda (the default) or cpu")
    p.add_argument("--trace", default="", metavar="OUT.json",
                   help="export a Chrome-trace span timeline of the render phases "
                   "(also TORCH_PBRT_TRACE_PATH)")
    p.add_argument("--metrics-path", default="", metavar="OUT.prom",
                   help="write a Prometheus text snapshot of the host metrics registry "
                   "on exit (also TORCH_PBRT_METRICS_PATH; TORCH_PBRT_METRICS=0 disables)")
    p.add_argument("--faults", default="", metavar="PLAN",
                   help="chaos fault plan, e.g. 'dispatch:poison@chunk=3,ckpt:torn@write=2' "
                   "(also TORCH_PBRT_FAULTS)")
    p.add_argument("--mesh", default="",
                   help="render over N ranks, e.g. '2' or '2,4' (their product): one process "
                   "and one card each, or CPU processes under --device cpu")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group the environment describes (RANK, WORLD_SIZE, "
                   "LOCAL_RANK, TORCH_PBRT_COORDINATOR_ADDRESS) and render over it")
    return p


def _mesh_ranks(args) -> int:
    from tpu_pbrt_torch.parallel.mesh import mesh_ranks

    return mesh_ranks(args.mesh)


def _render_rank(mesh, argv):
    """One rank of `--mesh N`: the command line again, on this rank's
    device, rendering over the group."""
    args = build_arg_parser().parse_args(argv)
    if mesh.rank:
        args.trace = args.metrics_path = ""
        args.quiet = True
    return _render_scenes(args, mesh.device)


def _serve_rank(mesh, argv):
    """One rank of `--serve --mesh N`: the daemon on rank 0, a follower
    of its decisions elsewhere."""
    args = build_arg_parser().parse_args(argv)
    if mesh.rank:
        args.trace = args.metrics_path = ""
        args.quiet = True
    return _render_scenes(args, mesh.device, mesh)


def main(argv=None) -> int:
    from tpu_pbrt_torch.config import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_arg_parser().parse_args(argv)
    if not args.scenes and not args.serve:
        print("tpu-pbrt-torch: no scene files (and no --serve)", file=sys.stderr)
        return 1
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"tpu-pbrt-torch: {e} (on the command line: --device cpu)", file=sys.stderr)
        return 1
    import torch

    n = _mesh_ranks(args)
    if args.multihost:
        import torch.distributed as dist

        from tpu_pbrt_torch.parallel.mesh import maybe_init_distributed

        if maybe_init_distributed(argparse.Namespace(multihost=True, device=device.type)):
            # this process is one rank of the group; the mesh spans it
            args.mesh = str(dist.get_world_size())
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            if args.serve and dist.get_rank():
                args.trace = args.metrics_path = ""
                args.quiet = True
        return _render_scenes(args, device)
    if n > 1 and args.serve:
        from tpu_pbrt_torch.serve.__main__ import launch_serving

        return launch_serving(_serve_rank, n, argv, device)
    if n > 1:
        cards = torch.cuda.device_count() if device.type == "cuda" else n
        if cards >= n:
            from tpu_pbrt_torch.parallel.mesh import launch

            try:
                codes = launch(_render_rank, n, args=(argv,), device=device.type)
            except RuntimeError as e:
                print(f"tpu-pbrt-torch: {e}", file=sys.stderr)
                return 1
            return max(codes)
        from tpu_pbrt_torch.utils.error import Warning as _W

        _W(f"--mesh {args.mesh}: {n} ranks asked for, {cards} card(s) visible; "
           "rendering on one device")
        args.mesh = ""
    return _render_scenes(args, device)


def _render_scenes(args, device, mesh=None) -> int:
    from tpu_pbrt_torch.scene.api import Options, render_file
    from tpu_pbrt_torch.utils.error import PbrtError

    opts = Options(
        n_threads=args.nthreads,
        quick_render=args.quick,
        quiet=args.quiet,
        verbose=args.verbose,
        image_file=args.outfile,
        crop_window=tuple(args.cropwindow) if args.cropwindow else None,
        spp_chunk=args.spp_chunk,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        mesh_shape=(_mesh_ranks(args),) if args.mesh else None,
        multihost=args.multihost,
    )
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.obs.trace import TRACE

    # chaos before the telemetry: a plan that targets the first dispatch
    # must be installed when the instrumentation comes online
    if args.faults:
        from tpu_pbrt_torch.chaos import CHAOS

        CHAOS.install(args.faults)
    if args.trace:
        TRACE.configure(args.trace)
    if args.metrics_path:
        METRICS.configure(args.metrics_path)
    if args.serve:
        from tpu_pbrt_torch.serve import RenderService
        from tpu_pbrt_torch.serve.__main__ import run_daemon

        if mesh is None and opts.mesh_shape:
            from tpu_pbrt_torch.parallel.mesh import resolve_mesh

            mesh = resolve_mesh(opts.mesh_shape, device=device)
        service = RenderService(mesh=mesh, device=device, quiet=args.quiet)

        def lead(service):
            for i, scene in enumerate(args.scenes):
                # one --checkpoint path cannot be shared by several jobs:
                # key it per scene when more than one is submitted
                ckpt = args.checkpoint
                if ckpt and len(args.scenes) > 1:
                    ckpt = f"{ckpt}.{i}"
                job = service.submit(scene, options=opts, checkpoint_path=ckpt,
                                     checkpoint_every=args.checkpoint_every,
                                     outfile=args.outfile)
                if not args.quiet:
                    print(f"tpu-pbrt-torch: submitted {scene} as {job}", file=sys.stderr)
            return run_daemon(service)

        try:
            return service.lead_or_follow(lead) or 0
        finally:
            TRACE.maybe_export()
            METRICS.maybe_export()
    try:
        for scene in args.scenes:
            try:
                with TRACE.span("main/render_file", scene=scene):
                    render_file(scene, opts, device=device)
            except PbrtError as e:
                print(f"tpu-pbrt-torch: {e}", file=sys.stderr)
                return 1
        return 0
    finally:
        # render() exports as it ends; this export adds the outer span,
        # on the failure path too
        TRACE.maybe_export()
        METRICS.maybe_export()


if __name__ == "__main__":
    sys.exit(main())
