"""Write the JAX package's side of the served-mesh decisions that
tests/test_torch_serve_mesh.py holds the port's rank 0 to.

The script is the reference's tests/test_serve.py acceptance case over a
mesh: the Cornell box under `path` at 32x32, 1 spp, maxdepth 3, in
slices of 256 camera rays (4 slices a job), two concurrent submits
(tenants alice and bob), three steps, a preempt of the second job, a
step, its resume and a drain, on a VirtualClock. Recorded: the
`schedule`, every job's poll dict (its preemptions among them) and the
phases of each job's FLIGHT file with their chunk fields.

It is run twice on the reference: on one device, and over a mesh of two
of eight virtual CPU devices. The scheduler's decisions do not depend on
the mesh, so both records hold the same decisions; when the mesh run
does not complete under the installed JAX (its multi-device programs
fail here), the file says so and keeps its error, and the test holds the
port to the one-device record alone.

`run_script` runs either package: `"tpu_pbrt"` here, `"tpu_pbrt_torch"`
(on rank 0 of a mesh of gloo ranks) in the test.

Run from the repository root (a minute or two, most of it XLA compiling
the chunk program):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_serve_mesh_reference.py

Writes tests/torch_golden/serve_mesh_reference.json.
"""

import importlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "serve_mesh_reference.json")
sys.path.insert(0, HERE)
import make_serve_reference as base  # noqa: E402

CHUNK = base.CHUNK


def run_script(pkg: str, workdir: str, mesh=None, device=None):
    """The served-mesh script. Returns (the recorded dict, {job id:
    image}); on a mesh of the port, rank 0 drives it (the caller's
    followers run `follow()`)."""
    serve = importlib.import_module(f"{pkg}.serve")
    clock_m = importlib.import_module(f"{pkg}.utils.clock")
    flight = importlib.import_module(f"{pkg}.obs.flight")
    text = base.scene_text(pkg)
    kw = {} if device is None else {"device": device}
    os.makedirs(os.path.join(workdir, "spool"), exist_ok=True)
    flight.FLIGHT.configure(os.path.join(workdir, "flight.jsonl"))
    try:
        svc = serve.RenderService(
            mesh=mesh, chunk=CHUNK, seed=0, spool_dir=os.path.join(workdir, "spool"),
            clock=clock_m.VirtualClock(start=0.0, tick=1e-6), **kw)
        j1 = svc.submit(text=text, tenant="alice")
        j2 = svc.submit(text=text, tenant="bob")
        for _ in range(3):
            svc.step()
        svc.preempt(j2)
        svc.step()
        svc.resume(j2)
        svc.drain()
        jobs = [j1, j2]
        out = {
            "schedule": [list(s) for s in svc.schedule],
            "polls": {j: svc.poll(j) for j in jobs},
            "flight": base._flight(workdir, jobs),
        }
        return out, {j: svc.result(j).image for j in jobs}, svc
    finally:
        flight.FLIGHT.configure(None)


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["one_device"] = run_script("tpu_pbrt", os.path.join(tmp, "one"))[0]
        try:
            from tpu_pbrt.parallel.mesh import make_mesh

            out["mesh"] = run_script("tpu_pbrt", os.path.join(tmp, "mesh"), mesh=make_mesh(2))[0]
        except Exception as e:  # noqa: BLE001 - recorded: the test then reads one_device
            out["mesh"] = None
            out["mesh_error"] = f"{type(e).__name__}: {str(e)[:300]}"
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {OUT}; mesh run {'completed' if out['mesh'] else 'failed'}")


if __name__ == "__main__":
    main()
