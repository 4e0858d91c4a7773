"""Write the JAX package's side of the render loop's recovery behaviour
that tests/test_torch_pipeline.py holds the port to: for each chaos plan
of CASES, the render's `stats["recovery"]` dict, the phases (and the
chunk, attempt and backoff fields) of its FLIGHT heartbeats, the error a
render that gives up raises, the checkpoint it leaves and the registry's
fired counts.

The scene is the Cornell box under `path` at 12x12, 2 spp, maxdepth 2,
in chunks of 96 camera rays (3 chunks, through the persistent pool), a
checkpoint after every chunk, the window at depth 2 (1 under the strict
firewall) and a 0.01 s backoff base on a virtual clock. `run_case` runs
either package: `run_case("tpu_pbrt", ...)` here,
`run_case("tpu_pbrt_torch", ...)` in the test.

Run from the repository root (a minute or two, most of it XLA compiling
the pool's chunk twice: without and with the nan:wave argument):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_infra_reference.py

Writes tests/torch_golden/infra_reference.json.
"""

import importlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "infra_reference.json")
RES, SPP, MAXDEPTH, CHUNK = 12, 2, 2, 96
#: name -> (fault plan, config overrides); every case checkpoints each chunk
CASES = {
    "clean": ("", {}),
    "dispatch_poison": ("dispatch:poison@chunk=2", {}),
    "dispatch_fail": ("dispatch:fail@chunk=1", {}),
    "nan_retry": ("nan:wave@1&chunk=1", {"nonfinite": "retry"}),
    # the torn second write is current when chunk 2's dispatch poisons the
    # film: the rollback loads through the .prev fallback
    "ckpt_torn": ("ckpt:torn@write=2,dispatch:poison@chunk=2", {}),
    # retry exhaustion: an emergency checkpoint, then the render raises
    "exhausted": ("dispatch:fail@chunk=1&times=99", {"retry_max": 2}),
}
#: heartbeat fields compared (render_s, t and elapsed_s are wall times)
FIELDS = ("chunks", "resumed_at", "spp", "chunk", "of", "attempt", "poisoned", "backoff_s",
          "backoff_total_ms", "error")


def run_case(pkg: str, name: str, workdir: str, device=None):
    """Render CASES[name] through package `pkg`; returns (result dict, the
    RenderResult or None)."""
    config = importlib.import_module(f"{pkg}.config")
    chaos = importlib.import_module(f"{pkg}.chaos")
    flight = importlib.import_module(f"{pkg}.obs.flight")
    scenes = importlib.import_module(f"{pkg}.scenes")
    clock = importlib.import_module(f"{pkg}.utils.clock")
    ck = importlib.import_module(f"{pkg}.parallel.checkpoint")
    plan, over = CASES[name]
    cfg = config.cfg
    knobs = {"chunk": CHUNK, "pipeline": 2, "retry_backoff": 0.01, "retry_max": 8,
             "nonfinite": "scrub", "telemetry": True, **over}
    saved = {k: getattr(cfg, k) for k in knobs}
    fpath = os.path.join(workdir, f"{name}.flight.jsonl")
    ckpt = os.path.join(workdir, f"{name}.npz")
    kw = {} if device is None else {"device": device}
    try:
        for k, v in knobs.items():
            setattr(cfg, k, v)
        chaos.CHAOS.install(plan)
        flight.FLIGHT.configure(fpath)
        scene, integ = scenes.compile_api(
            scenes.make_cornell(res=RES, spp=SPP, integrator="path", maxdepth=MAXDEPTH, **kw))
        integ.clock = clock.VirtualClock()
        out = {"plan": plan}
        res = None
        try:
            res = integ.render(scene, checkpoint_path=ckpt, checkpoint_every=1)
            out["recovery"] = res.stats.get("recovery")
            out["error"] = None
        except RuntimeError as e:
            out["recovery"] = None
            out["error"] = str(e)
        phases = []
        with open(fpath) as f:
            for line in f:
                d = json.loads(line)
                phases.append([d["phase"]] + [[k, d[k]] for k in FIELDS if k in d])
        out["flight"] = phases
        _, next_chunk, _, counters = ck.load_checkpoint(ckpt, "", **kw)
        out["checkpoint"] = {"next_chunk": next_chunk,
                             **{k: counters.get(k, 0) for k in
                                ("chunks_redispatched", "retry_backoff_ms")}}
        out["fired"] = chaos.CHAOS.report()
        return out, res
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)
        chaos.CHAOS.clear()
        flight.FLIGHT.configure(None)


def main(argv):
    ref = {}
    with tempfile.TemporaryDirectory() as d:
        for name in CASES:
            ref[name], _ = run_case("tpu_pbrt", name, d)
            print(name, ref[name]["recovery"], ref[name]["error"], flush=True)
    import subprocess

    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                cwd=HERE).stdout.strip()
    except OSError:
        commit = ""
    with open(OUT, "w") as f:
        json.dump({"commit": commit, "cases": ref}, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", OUT)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    main(sys.argv[1:])
