"""Which of the reference's compiled operations make the motion cell's
`path` render differ from the port's: the reference's render of the
small motion stand-in (16x16, 4 spp, the pool of 256 slots, 64-triangle
treelets: tests/torch_golden/motion_path_pool.npz) with named functions
computed eagerly, one operation at a time, through a host callback
(jax.pure_callback), against the port's render of the same scene.

XLA's CPU backend contracts a multiply whose one use is an add or a
subtract in the same loop fusion into one fused multiply-add; eager JAX
and the port round every operation apart. A function that, computed
eagerly inside the reference's program, brings the reference's rays and
image to the port's is where the renders part.

Run from the repository root (about 30 s per line, most of it XLA
compiling; the port's render once, first):

    JAX_PLATFORMS=cpu python tests/torch_golden/fma_study.py [module.function ...]

e.g. `tpu_pbrt.core.bxdf.bsdf_eval tpu_pbrt.core.bxdf.bsdf_sample` (every
BSDF, the hair lobes included) or `tpu_pbrt.integrators.path.make_interaction`.
`--scene=subsurface` studies the small subsurface stand-in
(tests/torch_golden/subsurface_path_pool.npz) instead, e.g. with
`tpu_pbrt.core.bssrdf.pdf_sp` or `tpu_pbrt.core.bssrdf.sr_eval`.
With no argument it renders the reference as compiled. Prints the rays,
the MSE against the port and against the stored golden, and how often
each callback ran.

`--barycentrics=fused` (or `=plain`) instead replaces the hit
barycentrics of the reference's `accel/stream.py::_finalize_hits` by a
host computation from the same rays and vertices: `fused` rounds them as
the compiled program's kernels do (read from its XLA dump's object code:
each cross-product component a_j b_k - a_k b_j as fma(a_j, b_k,
-(a_k b_j)), each dot product as fma(a2, b2, fma(a1, b1, a0 b0)), and
b0 = 1 - u - v as fma(-dot(d, qvec), inv, 1 - u)), `plain` rounds every
operation apart, as the port does. The fused one reproduces the
compiled render; the plain one gives the port's rays.

`--port-interaction=camera|probe|all` instead computes make_interaction
at that site with the port's code (a host callback): on the subsurface
scene the probe site leaves the reference 3.2e-14 from its golden (the
port rounds the probe hits as compiled), while any callback at the
camera site moves it 3.14e-12, even one that returns the reference's own
values for all but one field: the callback changes how XLA compiles the
bounce wave around it (ROADMAP Queue 3 item 14).
"""

import importlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
RES, SPP, LEAF_TRIS, POOL = 16, 4, 64, 256


def eager(fn, name, calls):
    """fn computed op by op on the host inside the jitted program."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_pbrt.integrators.common import Interaction

    def pack(o):
        return ("__I__", tuple(getattr(o, k) for k in Interaction.__slots__)) \
            if isinstance(o, Interaction) else o

    def wrapped(*args, **kw):
        leaves, tree = jax.tree_util.tree_flatten((args, kw))
        idx = [i for i, x in enumerate(leaves) if isinstance(x, (jax.Array, np.ndarray))
               or hasattr(x, "aval")]

        def rebuild(xs):
            out = list(leaves)
            for i, x in zip(idx, xs):
                out[i] = x
            return jax.tree_util.tree_unflatten(tree, out)

        is_it = {}

        def run(*xs):
            a, k = rebuild(xs)
            out = pack(fn(*a, **k))
            if isinstance(out, tuple) and len(out) == 2 and out[0] == "__I__":
                is_it["I"] = True
                return out[1]
            return out

        shapes = jax.eval_shape(run, *[leaves[i] for i in idx])

        def host(*xs):
            calls[name] = calls.get(name, 0) + 1
            with jax.disable_jit():
                out = run(*[jnp.asarray(x) for x in xs])
            return jax.tree_util.tree_map(np.asarray, out)

        res = jax.pure_callback(host, shapes, *[leaves[i] for i in idx])
        return Interaction(*res) if is_it.get("I") else res

    return wrapped


def _cross(a, b, fused):
    import numpy as np

    def c(j, k):
        if fused:
            return _fma(a[..., j], b[..., k], -(a[..., k] * b[..., j]))
        return a[..., j] * b[..., k] - a[..., k] * b[..., j]

    return np.stack([c(1, 2), c(2, 0), c(0, 1)], -1)


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the f64 product of two f32 is exact)."""
    import numpy as np

    return (a.astype(np.float64) * b + c).astype(np.float32)


def _dot(a, b, fused):
    if fused:
        return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def host_barycentrics(fused: bool, calls):
    """Replace _finalize_hits' (b0, b1) by a host computation from the
    program's own rays and vertices, rounded as `fused` says."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_pbrt.accel.stream as stream

    f32 = np.float32
    orig = stream._finalize_hits

    def host(o, d, tv, hit):
        calls["barycentrics"] = calls.get("barycentrics", 0) + 1
        o, d, tv = (np.asarray(x, f32) for x in (o, d, tv))
        v0 = tv[:, 0]
        e1, e2 = tv[:, 1] - v0, tv[:, 2] - v0
        pvec = _cross(d, e2, fused)
        det = _dot(e1, pvec, fused)
        inv = (f32(1) / np.where(det == 0, f32(1), det)).astype(f32)
        sv = o - v0
        u = (_dot(sv, pvec, fused) * inv).astype(f32)
        dq = _dot(d, _cross(sv, e1, fused), fused)
        b0 = _fma(-dq, inv, f32(1) - u) if fused else (f32(1) - u) - (dq * inv).astype(f32)
        return (np.where(hit, b0, f32(0)).astype(f32), np.where(hit, u, f32(0)).astype(f32))

    def finalize(tri_verts, o, d, t_raw, prim, *a, **k):
        h = orig(tri_verts, o, d, t_raw, prim, *a, **k)
        sh = jax.ShapeDtypeStruct(h.b0.shape, jnp.float32)
        b0, b1 = jax.pure_callback(host, (sh, sh), o, d, h.tv, prim >= 0)
        return h._replace(b0=b0, b1=b1)

    stream._finalize_hits = finalize


def port_interaction(site: str, scene_name: str, calls):
    """Replace the reference's make_interaction by the port's, computed on
    the host from the program's own hits (a host callback), at `site`:
    "camera" (each bounce wave's first call), "probe" (the subsurface
    probe wave's four chord calls) or "all". The port's interaction
    equals the compiled one where the reference's image stays at its
    golden; a callback at a site also changes how XLA compiles the code
    around it, which bounds what this can resolve."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import tpu_pbrt.integrators.path as rpath
    from tpu_pbrt.integrators.common import Interaction
    from tpu_pbrt_torch.accel.traverse import Hit
    from tpu_pbrt_torch.integrators.common import make_interaction

    orig = rpath.make_interaction
    per_wave = 5 if scene_name == "subsurface" else 1
    traced = [0]
    flds = ("p", "ng", "ns", "ss", "ts", "uv")

    def replaced(dev, hit, o, d):
        i = traced[0]
        traced[0] += 1
        it = orig(dev, hit, o, d)
        camera = i % per_wave == 0
        if site != "all" and (site == "camera") != camera:
            return it
        keys = [k for k in ("tri_verts", "tri_sh16", "tri_tanT") if k in dev]

        def host(prim, b0, b1, tv, o_, d_, *tables):
            calls["port_interaction"] = calls.get("port_interaction", 0) + 1
            t = {k: torch.from_numpy(np.array(v)) for k, v in zip(keys, tables)}
            h = Hit(torch.zeros(prim.shape), *(torch.from_numpy(np.array(x))
                                               for x in (prim, b0, b1, tv)))
            got = make_interaction(t, h, torch.from_numpy(np.array(o_)),
                                   torch.from_numpy(np.array(d_)))
            return tuple(getattr(got, f).numpy() for f in flds)

        tv = hit.tv if hit.tv is not None else dev["tri_verts"][jnp.maximum(hit.prim, 0)]
        shapes = tuple(jax.ShapeDtypeStruct(getattr(it, f).shape, jnp.float32) for f in flds)
        out = dict(zip(flds, jax.pure_callback(host, shapes, hit.prim, hit.b0, hit.b1, tv, o, d,
                                               *(dev[k] for k in keys))))
        return Interaction(mat=it.mat, light=it.light, wo=it.wo, valid=it.valid, **out)

    rpath.make_interaction = replaced


def port_render(scene_name="motion"):
    import torch

    from tpu_pbrt_torch import scenes
    from tpu_pbrt_torch.config import cfg

    cfg.leaf_tris, cfg.regen, cfg.pool = LEAF_TRIS, True, POOL
    make = getattr(scenes, f"make_{scene_name}_like")
    scene, integ = scenes.compile_api(make(RES, SPP, 5, "path", small=True, device="cpu"))
    torch.set_num_threads(os.cpu_count() or 1)
    res = integ.render(scene)
    return res.image, res.rays_traced


def main(targets):
    import numpy as np

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    os.environ["TPU_PBRT_REGEN"] = "1"
    os.environ["TPU_PBRT_POOL"] = str(POOL)
    from tpu_pbrt import config

    config.reload()
    scene_name = next((t.split("=", 1)[1] for t in targets if t.startswith("--scene=")), "motion")
    port_img, port_rays = port_render(scene_name)
    calls = {}
    for target in [t for t in targets if t.startswith("--barycentrics=")]:
        host_barycentrics(target.split("=", 1)[1] == "fused", calls)
    for target in [t for t in targets if t.startswith("--port-interaction=")]:
        port_interaction(target.split("=", 1)[1], scene_name, calls)
    for target in [t for t in targets if not t.startswith("--")]:
        mod, attr = target.rsplit(".", 1)
        m = importlib.import_module(mod)
        setattr(m, attr, eager(getattr(m, attr), target, calls))
    make = getattr(importlib.import_module(f"make_{scene_name}_reference"),
                   f"jax_{scene_name}_api")
    from tpu_pbrt.scenes import compile_api

    scene, integ = compile_api(make(RES, SPP, 5, "path", small=True))
    res = integ.render(scene)
    img = np.asarray(res.image, np.float64)
    gold = np.load(os.path.join(HERE, f"{scene_name}_path_pool.npz"))
    print(f"eager {targets or 'nothing'}: rays {res.rays_traced} (port {port_rays}, golden "
          f"{int(gold['rays_traced'])}); MSE against the port {np.mean((img - port_img) ** 2):.4e}, "
          f"against the golden {np.mean((img - gold['image']) ** 2):.4e}; callbacks {calls}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    main(sys.argv[1:])
