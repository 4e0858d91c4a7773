"""Write the JAX package's renders of the small scenes that the port's
tests hold it against.

The small killeroo is `tpu_pbrt.scenes.make_killeroo_like(**SMALL)` (528
mesh triangles + the ground quad and the light quad, so it takes the
stream tracer) cut into 64-triangle treelets, rendered on the CPU twice:

- `killeroo_small.npz` (tests/test_torch_render.py): the fixed-batch loop
  (TPU_PBRT_REGEN=0), which traces the fused camera+shadow layout;
- `killeroo_small_pool.npz` (tests/test_torch_pool.py): the persistent
  pool (`PathIntegrator.pool_chunk`, TPU_PBRT_REGEN=1) with 256 slots
  (TPU_PBRT_POOL=256), with its wave count and telemetry counters.

The small crown is `crown_small_text` below: every directive
`make_crown_like` uses (the infinite light with a lat-long sky of the
same formula at 16x32, a glass mesh with per-vertex normals, a metal mesh
with `roughness`, one with `uroughness`/`vroughness`, a matte ground) on
1,682 triangles in 64-triangle treelets, 16x16 pixels, 4 spp, maxdepth 5.
The tests build it from the same text. Rendered the same two ways:

- `crown_small.npz` (tests/test_torch_envlight.py): the fixed batch;
- `crown_small_pool.npz` (tests/test_torch_envlight.py): the pool with
  256 slots, with its waves and counters.

The direct-lighting family (tests/test_torch_direct.py) renders through
the fixed-batch chunk loop, as the reference gives it. `DIRECT_CASES`
below names each golden's scene (the Cornell box of
`cornell_box_text` at 16x16, 4 spp, maxdepth 5, which takes the brute
feature intersector; or the small killeroo above), its integrator with
its parameters, and its sampler:

- `cornell_direct.npz`: `directlighting` (strategy "all");
- `cornell_direct_one.npz`: `directlighting` "one" under `sobol`;
- `cornell_ao.npz`: `ao` with a finite `maxdistance` and uniform
  hemisphere sampling, under `stratified`;
- `killeroo_direct.npz`: `directlighting` on the small killeroo (an area
  and a point light, so two light rows);
- `killeroo_ao.npz`: `ao` with a finite `maxdistance` on the small
  killeroo under `halton`.

Participating media and null interfaces (tests/test_torch_media.py):
`MEDIA_CASES` below, each a scene text of `media_text` (rendered through
the fixed batch, as the reference renders `volpath` and any scene with
null surfaces):

- `vol_beer`, `vol_no_medium`, `vol_fog_shadow`: the three scenes of
  tests/test_media.py::TestVolPath (a camera inside an absorbing fog, a
  medium-free scene, a scattering fog under a point light) at 8x8;
- `null_cube_volpath`, `null_quad_path`: TestNullInterface's scenes (a
  scattering medium in a `Material "none"` cube under `volpath`; a null
  quad between an area light and the floor under `path`, which takes the
  split layout) at 8x8;
- `furnace_g05`: TestVolumeFurnace at g 0.5 (a camera inside a fog
  filled emitting sphere, the reference's 4,096-triangle tessellation,
  so the stream tracer runs) at 8x8;
- `grid_null_cube`: a seeded 8^3 grid medium (ratio and delta tracking)
  in the null cube, at 8x8;
- `cloud_small`: `tpu_pbrt_torch.scenes.make_cloud_like` at n_theta=12,
  n_phi=24 (the sky, both other lights, the null container of a
  homogeneous medium) at 16x16, 4 spp, in 64-triangle treelets;
- `furnace_g05_rr_off`, `cloud_small_rr_off`: the same two scenes with
  Russian roulette off (`"float rrthreshold" [0]`). The reference's
  roulette scales a survivor so that its beta lands on 1 or 1 - 2^-24 by
  the last bits, and a second roll at the same depth compares that with
  1; these two goldens hold everything else to the port exactly.

The light-transport integrators (tests/test_torch_{bdpt,sppm,mlt}.py):
`LT_CASES` below, each a scene of `lt_api` with its integrator and
parameters, at maxdepth 5 unless the scene text says otherwise:

- `bdpt_cornell`: the Cornell box of the direct goldens under `bdpt`
  (the brute feature intersector);
- `bdpt_env`, `bdpt_distant`: tests/test_bdpt.py's environment-lit and
  distant-lit scenes (a glass or plastic sphere of the reference's
  4,096-triangle tessellation on a matte plane, maxdepth 3) at 8x8, 8 spp;
- `bdpt_caustic`: `tpu_pbrt_torch.scenes.make_caustic_like` at
  n_theta=12, n_phi=24 (the glass blob, the ground, the quad area light
  and the point light) at 16x16, 4 spp, in 64-triangle treelets;
- `sppm_cornell`, `sppm_caustic`: the same two scenes under `sppm`, 4
  iterations of 4,096 photons;
- `mlt_cornell`: the Cornell box under `mlt` at maxdepth 3, 512 chains
  from 4,096 bootstrap samples, 32 mutations per pixel.

Scene breadth (tests/test_torch_breadth.py): `BREADTH_CASES` below, the
small tessellation of `tpu_pbrt_torch.scenes.make_breadth_like`
(`BREADTH_SMALL`: every shape, eight object instances of a 528-triangle
blob, the spot, goniometric, projection and infinite lights) at 16x16,
4 spp, through the pool with 256 slots, once per camera and filter:
`breadth_perspective` (gaussian), `breadth_realistic` (mitchell, the
built-in doublet), `breadth_orthographic` (triangle) and
`breadth_environment` (sinc). The reference's `plymesh` cannot compile,
so its scene declares the blob as the `trianglemesh` of the arrays read
back from the PLY file (`jax_breadth_api`).

The JAX renders alone take longer here than the port's test budget
allows (most of it compiling), so the tests read these files instead.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py \
        [fixed|pool|crown|crown_pool|<a DIRECT_CASES, MEDIA_CASES, LT_CASES or
         BREADTH_CASES name>|direct|media|lt|breadth|all]

It rewrites the named golden(s) (default: all; "direct": every
DIRECT_CASES golden; "media": every MEDIA_CASES golden; "lt": every
LT_CASES golden; "breadth": every BREADTH_CASES golden) and records the commit of the JAX package it rendered
with.
"""

import json
import os
import subprocess
import sys

#: the scene every consumer of the goldens uses (also read by the tests)
SMALL = dict(res=16, spp=4, n_theta=12, n_phi=24, maxdepth=5)
LEAF_TRIS = 64
#: pool slots of the pool golden
POOL = 256
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "killeroo_small.npz")
OUT_POOL = os.path.join(HERE, "killeroo_small_pool.npz")
OUT_CROWN = os.path.join(HERE, "crown_small.npz")
OUT_CROWN_POOL = os.path.join(HERE, "crown_small_pool.npz")
TARGETS = ("fixed", "pool", "crown", "crown_pool")
#: the Cornell box of the direct-lighting goldens
CORNELL = dict(res=16, spp=4, maxdepth=5)
#: golden name -> (scene, integrator, integrator parameters, sampler)
DIRECT_CASES = {
    "cornell_direct": ("cornell", "directlighting", (), "zerotwosequence"),
    "cornell_direct_one": ("cornell", "directlighting", (("string strategy", ["one"]),), "sobol"),
    "cornell_ao": ("cornell", "ao", (("float maxdistance", [0.5]), ("bool cossample", [False])),
                   "stratified"),
    "killeroo_direct": ("killeroo", "directlighting", (), "zerotwosequence"),
    "killeroo_ao": ("killeroo", "ao", (("float maxdistance", [0.5]),), "halton"),
}


#: the null cube of tests/test_media.py::TestNullInterface
NULL_CUBE = (
    'Shape "trianglemesh" "integer indices" '
    "[0 1 2 0 2 3  4 6 5 4 7 6  0 4 1 1 4 5  2 6 3 3 6 7  1 5 2 2 5 6  0 3 7 0 7 4] "
    '"point P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1  -1 1 -1  1 1 -1  1 1 1  -1 1 1]'
)


def _grid_density_text() -> str:
    """A seeded 8^3 density grid (a soft ball plus noise), as scene text."""
    import numpy as np

    rng = np.random.default_rng(8)
    c = (np.arange(8) + 0.5) / 8 - 0.5
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    dens = np.clip(1.2 - 3.0 * (x * x + y * y + z * z) + rng.uniform(-0.2, 0.2, x.shape), 0, None)
    return " ".join(f"{v:.3f}" for v in dens.reshape(-1))


#: the integrator parameter of the `_rr_off` goldens: Russian roulette off
RR_OFF = ("float rrthreshold", [0.0])


def media_api(name: str, parse_string, pbrt_init, Options, cloud_api, **kw):
    """The parsed scene (up to WorldEnd) of MEDIA_CASES[name], through
    either package's parse_string/pbrt_init/Options; cloud_api(**CLOUD_SMALL,
    **kw) builds the small cloud; kw goes to pbrt_init."""
    base = name[: -len("_rr_off")] if name.endswith("_rr_off") else name
    if base == "cloud_small":
        api = cloud_api(**CLOUD_SMALL, **kw)
    else:
        api = parse_string(media_text(base).rsplit("WorldEnd", 1)[0],
                           pbrt_init(Options(quiet=True), **kw))
    if name != base:
        api.render_options.integrator_params.add(*RR_OFF)
    return api


def media_text(name: str) -> str:
    """The whole scene text of MEDIA_CASES[name] (the small cloud excepted)."""
    head = ('Sampler "halton" "integer pixelsamples" [16]\nPixelFilter "box"\n'
            'Film "image" "integer xresolution" [8] "integer yresolution" [8] '
            '"string filename" [""]\n')
    if name == "vol_beer":
        return ('Integrator "volpath" "integer maxdepth" [3]\n' + head + """
LookAt 0 0 -3  0 0 0  0 1 0
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.4 0.4 0.4] "rgb sigma_s" [0 0 0]
MediumInterface "" "fog"
Camera "perspective" "float fov" [50]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-4 -4 0  -4 4 0  4 4 0  4 -4 0]
AttributeEnd
WorldEnd
""")
    if name == "vol_no_medium":
        return ('Integrator "volpath" "integer maxdepth" [2]\n' + head + """
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Translate 0 1.8 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-0.6 0 -0.6  0.6 0 -0.6  0.6 0 0.6  -0.6 0 0.6]
AttributeEnd
Material "matte" "rgb Kd" [0.7 0.6 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-2 -2 2  2 -2 2  2 2 2  -2 2 2]
WorldEnd
""")
    if name == "vol_fog_shadow":
        return ('Integrator "volpath" "integer maxdepth" [3]\n' + head + """
LookAt 0 0 -3  0 0 0  0 1 0
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.01 0.01 0.01] "rgb sigma_s" [0.4 0.4 0.4] "float g" [0.0]
MediumInterface "" "fog"
Camera "perspective" "float fov" [50]
WorldBegin
LightSource "point" "rgb I" [20 20 20] "point from" [0 2 0]
Material "matte" "rgb Kd" [0.1 0.1 0.1]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-9 -9 4  9 -9 4  9 9 4  -9 9 4]
WorldEnd
""")
    if name in ("null_cube_volpath", "grid_null_cube"):
        # (the grid medium is made inside the world block, so it sits in
        # world space, on the cube)
        if name == "null_cube_volpath":
            medium = ('MakeNamedMedium "cloud" "string type" "homogeneous" "rgb sigma_a" '
                      '[0.05 0.05 0.05] "rgb sigma_s" [0.8 0.8 0.8] "float g" [0.0]')
        else:
            medium = ('MakeNamedMedium "cloud" "string type" "heterogeneous" "integer nx" [8] '
                      '"integer ny" [8] "integer nz" [8] "float density" ['
                      + _grid_density_text() + '] "rgb sigma_a" [0.3 0.3 0.3] '
                      '"rgb sigma_s" [2.0 2.0 2.0] "float g" [0.3] '
                      '"point p0" [-1 -1 -1] "point p1" [1 1 1]')
        return ('Integrator "volpath" "integer maxdepth" [3]\n' + head + f"""
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
{medium if name == "null_cube_volpath" else ""}
WorldBegin
{medium if name == "grid_null_cube" else ""}
LightSource "point" "rgb I" [40 40 40] "point from" [0 3 0]
AttributeBegin
  Material "none"
  MediumInterface "cloud" ""
  {NULL_CUBE}
AttributeEnd
WorldEnd
""")
    if name == "null_quad_path":
        return ('Integrator "path" "integer maxdepth" [3]\n' + head + """
LookAt 0 0.4 -3.5  0 -0.4 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 10 10]
  Translate 0 2 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-0.8 0 -0.8  0.8 0 -0.8  0.8 0 0.8  -0.8 0 0.8]
AttributeEnd
AttributeBegin
  Material "none"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-1.5 0.5 -1.5  1.5 0.5 -1.5  1.5 0.5 1.5  -1.5 0.5 1.5]
AttributeEnd
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-2 -1 -2  2 -1 -2  2 -1 2  -2 -1 2]
WorldEnd
""")
    assert name == "furnace_g05", name
    return ('Integrator "volpath" "integer maxdepth" [12]\n' + head + """
LookAt 0 0 0  0 0 1  0 1 0
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0 0 0] "rgb sigma_s" [0.25 0.25 0.25] "float g" [0.5]
MediumInterface "" "fog"
Camera "perspective" "float fov" [60]
WorldBegin
AttributeBegin
  Material "matte" "rgb Kd" [0 0 0]
  AreaLightSource "diffuse" "rgb L" [2 2 2] "bool twosided" ["true"]
  Shape "sphere" "float radius" [5]
AttributeEnd
WorldEnd
""")


#: the media goldens (tests/test_torch_media.py), rendered from media_text
#: or, for the small cloud, jax_cloud_api
MEDIA_CASES = ("vol_beer", "vol_no_medium", "vol_fog_shadow", "null_cube_volpath",
               "null_quad_path", "furnace_g05", "grid_null_cube", "cloud_small",
               "furnace_g05_rr_off", "cloud_small_rr_off")
#: the small cloud of the media goldens
CLOUD_SMALL = dict(res=16, spp=4, maxdepth=5, n_theta=12, n_phi=24)


#: the small caustic of the light-transport goldens
CAUSTIC_SMALL = dict(res=16, spp=4, maxdepth=5, n_theta=12, n_phi=24)
_SPPM_SMALL = (("integer numiterations", [4]), ("integer photonsperiteration", [4096]),
               ("float radius", [-1.0]))
#: light-transport golden name -> (scene, integrator, integrator parameters)
LT_CASES = {
    "bdpt_cornell": ("cornell", "bdpt", ()),
    "bdpt_env": ("env", "bdpt", ()),
    "bdpt_distant": ("distant", "bdpt", ()),
    "bdpt_caustic": ("caustic", "bdpt", ()),
    "sppm_cornell": ("cornell", "sppm", _SPPM_SMALL),
    "sppm_caustic": ("caustic", "sppm", _SPPM_SMALL),
    "mlt_cornell": ("cornell_md3", "mlt", (("integer chains", [512]),
                                           ("integer bootstrapsamples", [4096]),
                                           ("integer mutationsperpixel", [32]))),
}


#: scene breadth (tests/test_torch_breadth.py): the small tessellation of
#: tpu_pbrt_torch.scenes.make_breadth_like (BREADTH_SMALL) at 16x16x4,
#: name -> (camera, filter), through the pool with POOL slots
BREADTH_CASES = {
    "breadth_perspective": ("perspective", "gaussian"),
    "breadth_realistic": ("realistic", "mitchell"),
    "breadth_orthographic": ("orthographic", "triangle"),
    "breadth_environment": ("environment", "sinc"),
}
BREADTH_RES, BREADTH_SPP = 16, 4


def lt_scene_text(which: str, env_path: str = "", integrator: str = "bdpt", md: int = 3,
                  spp: int = 8, res: int = 8) -> str:
    """tests/test_bdpt.py's environment-lit ("env") and distant-lit
    ("distant") scenes, whole, at the given size."""
    light = (f'LightSource "infinite" "string mapname" ["{env_path}"]' if which == "env" else
             'LightSource "distant" "rgb L" [3 3 2.6] "point from" [2 5 -2] "point to" [0 0 0]')
    sphere_mat = ('Material "glass" "float eta" [1.5]' if which == "env" else
                  'Material "plastic" "rgb Kd" [0.3 0.1 0.1] "rgb Ks" [0.4 0.4 0.4]')
    return f"""
Integrator "{integrator}" "integer maxdepth" [{md}]
Sampler "zerotwosequence" "integer pixelsamples" [{spp}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}] "string filename" [""]
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
{light}
Material "matte" "rgb Kd" [0.6 0.55 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
{sphere_mat}
AttributeBegin
  Translate 0 0.8 0
  Shape "sphere" "float radius" [0.6]
AttributeEnd
WorldEnd
"""


def lt_api(name: str, scenes, parse_string, pbrt_init, Options, caustic_api, env_path, **kw):
    """The parsed scene (up to WorldEnd) of LT_CASES[name] through either
    package's modules; caustic_api(**CAUSTIC_SMALL, integrator=...) builds
    the small caustic, env_path names the crown's sky file; kw goes to the
    scene builder."""
    scene, integrator, params = LT_CASES[name]
    if scene.startswith("cornell"):
        md = 3 if scene == "cornell_md3" else CORNELL["maxdepth"]
        api = scenes.make_cornell(**dict(CORNELL, maxdepth=md), **kw)
    elif scene == "caustic":
        api = caustic_api(**CAUSTIC_SMALL, integrator=integrator, **kw)
    else:
        text = lt_scene_text(scene, env_path, integrator)
        api = parse_string(text.rsplit("WorldEnd", 1)[0], pbrt_init(Options(quiet=True), **kw))
    return configure(api, integrator, params)


def configure(api, integrator: str, params=(), sampler=None):
    """Set a parsed scene's integrator (with parameters given as
    (declaration, values) pairs) and sampler; works on either package's
    API object."""
    ro = api.render_options
    ro.integrator_name = integrator
    for decl, values in params:
        ro.integrator_params.add(decl, values)
    if sampler is not None:
        ro.sampler_name = sampler
    return api


def direct_case_api(scenes, name: str, device_kw=None):
    """The parsed scene of DIRECT_CASES[name], built with `scenes` (either
    package's scenes module); device_kw goes to the scene builder."""
    scene, integ, params, sampler = DIRECT_CASES[name]
    kw = dict(device_kw or {})
    if scene == "cornell":
        api = scenes.make_cornell(**CORNELL, **kw)
    else:
        api = scenes.make_killeroo_like(**SMALL, **kw)
    return configure(api, integ, params, sampler)


def crown_small_sky():
    """The crown's sky formula (the reference's `_crown_envmap_path`) at
    16x32: an (h, w, 3) f32 lat-long map."""
    import numpy as np

    h, w = 16, 32
    th = np.linspace(0, np.pi, h)[:, None]
    ph = np.linspace(0, 2 * np.pi, w)[None, :]
    sky = np.stack(
        [
            0.35 + 0.25 * np.cos(th) * np.ones_like(ph),
            0.45 + 0.30 * np.cos(th) * np.ones_like(ph),
            0.75 + 0.25 * np.cos(th) * np.ones_like(ph),
        ],
        axis=-1,
    ).astype(np.float32)
    d2 = (th - 0.45 * np.pi) ** 2 + (ph - 0.3 * np.pi) ** 2
    sun = np.exp(-d2 / 0.004)[..., None] * np.asarray([60.0, 50.0, 35.0])
    return (sky + sun).astype(np.float32)


def _blob(n_theta, n_phi, seed):
    """A displaced sphere with smooth vertex normals (the scenes'
    `_displaced_sphere`, written out here so the scene text does not
    depend on either package)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.02, 0.08, size=6)
    freqs = rng.integers(2, 9, size=(6, 2))
    th = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = np.ones_like(T)
    for a, (f1, f2) in zip(amps, freqs):
        r = r + a * np.sin(f1 * T) * np.cos(f2 * P)
    V = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T), r * np.sin(T) * np.sin(P)],
                 axis=-1).reshape(-1, 3)
    i = np.arange(n_theta - 1)[:, None]
    j = np.arange(n_phi)[None, :]
    a, b = i * n_phi + j, (i + 1) * n_phi + j
    c, e = (i + 1) * n_phi + (j + 1) % n_phi, i * n_phi + (j + 1) % n_phi
    F = np.stack([np.stack([a, b, c], -1), np.stack([a, c, e], -1)], axis=2).reshape(-1, 3)
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    N = np.zeros_like(V)
    for k in range(3):
        np.add.at(N, F[:, k], fn)
    N /= np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-20)
    return V, F, N


def _mesh_text(V, F, N) -> str:
    nums = lambda a: " ".join(repr(float(x)) for x in a.reshape(-1))  # noqa: E731
    idx = " ".join(str(int(x)) for x in F.reshape(-1))
    return (f'Shape "trianglemesh" "integer indices" [{idx}]'
            f' "point P" [{nums(V)}] "normal N" [{nums(N)}]\n')


def crown_small_text(env_path: str) -> str:
    """The small crown-class scene up to (not including) WorldEnd: the
    crown's camera, film and light setup with a 960-triangle glass blob
    and two 360-triangle metal blobs (1,682 triangles with the ground)."""
    return f"""
Integrator "path" "integer maxdepth" [5]
Sampler "zerotwosequence" "integer pixelsamples" [4]
PixelFilter "box"
Film "image" "integer xresolution" [16] "integer yresolution" [16] "string filename" [""]
LookAt 0 1.4 -3.6  0 0.4 0  0 1 0
Camera "perspective" "float fov" [39]
WorldBegin
LightSource "infinite" "string mapname" ["{env_path}"]
Material "matte" "rgb Kd" [0.45 0.42 0.38]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-8 -0.75 -8  -8 -0.75 8  8 -0.75 8  8 -0.75 -8]
Material "glass" "float eta" [1.5] "rgb Kr" [1 1 1] "rgb Kt" [1 1 1]
{_mesh_text(*_blob(16, 32, 7))}
AttributeBegin
Material "metal" "float roughness" [0.05]
Translate -1.7 -0.15 0.4
Scale 0.55 0.55 0.55
{_mesh_text(*_blob(10, 20, 11))}
AttributeEnd
AttributeBegin
Material "metal" "float roughness" [0.18] "float uroughness" [0.3] "float vroughness" [0.05]
Translate 1.7 -0.1 0.6
Scale 0.6 0.6 0.6
{_mesh_text(*_blob(10, 20, 23))}
AttributeEnd
"""


def jax_cloud_api(res, spp, maxdepth=5, n_theta=180, n_phi=360):
    """The port's cloud-class scene (`tpu_pbrt_torch.scenes.cloud_parts`:
    the same text, mesh arrays and sky file) parsed through the JAX
    package's API, up to (not including) WorldEnd."""
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init
    from tpu_pbrt.scene.paramset import ParamSet
    from tpu_pbrt_torch.scenes import _crown_envmap_path, cloud_parts

    head, (V, F, N), tail = cloud_parts(res, spp, maxdepth, n_theta, n_phi, _crown_envmap_path())
    api = parse_string(head, pbrt_init(Options(quiet=True)))
    ps = ParamSet()
    ps.add("integer indices", F.reshape(-1).tolist())
    ps.add("point P", V.reshape(-1).tolist())
    ps.add("normal N", N.reshape(-1).tolist())
    api.shape("trianglemesh", ps)
    return parse_string(tail, api)


def jax_caustic_api(res, spp, maxdepth=5, integrator="bdpt", params="", n_theta=180, n_phi=360):
    """The port's caustic-glass-class scene (`tpu_pbrt_torch.scenes.caustic_parts`:
    the same text and mesh arrays) parsed through the JAX package's API, up
    to (not including) WorldEnd."""
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init
    from tpu_pbrt.scene.paramset import ParamSet
    from tpu_pbrt_torch.scenes import caustic_parts

    head, (V, F, N), tail = caustic_parts(res, spp, maxdepth, n_theta, n_phi, integrator, params)
    api = parse_string(head, pbrt_init(Options(quiet=True)))
    ps = ParamSet()
    ps.add("integer indices", F.reshape(-1).tolist())
    ps.add("point P", V.reshape(-1).tolist())
    ps.add("normal N", N.reshape(-1).tolist())
    api.shape("trianglemesh", ps)
    return parse_string(tail, api)


def jax_breadth_api(res, spp, maxdepth=5, camera="perspective", filter="gaussian",
                    n_instances=8, n_theta=180, n_phi=360, n_height=257, n_curves=256,
                    subdiv_levels=4):
    """The port's scene-breadth stand-in (`tpu_pbrt_torch.scenes.breadth_parts`:
    the same text, PLY file and light maps) parsed through the JAX
    package's API, up to (not including) WorldEnd. The reference's
    `plymesh` cannot compile (its _tess_ply reads keys its read_ply does
    not return), so the blob inside `ObjectBegin "blob"` is declared as a
    `trianglemesh` of the arrays read back from the PLY file (float32
    positions and normals, as write_ply stores them): what `plymesh` means
    in pbrt-v3."""
    from tpu_pbrt_torch.scenes import breadth_parts

    head, ply, tail = breadth_parts(res, spp, maxdepth, camera, filter, n_instances, n_theta,
                                    n_phi, n_height, n_curves, subdiv_levels)
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init
    from tpu_pbrt.scene.paramset import ParamSet
    from tpu_pbrt.scene.plyreader import read_ply

    mesh = read_ply(ply)
    api = parse_string(head, pbrt_init(Options(quiet=True)))
    ps = ParamSet()
    ps.add("integer indices", mesh["indices"].reshape(-1).tolist())
    ps.add("point P", mesh["vertices"].reshape(-1).tolist())
    ps.add("normal N", mesh["normals"].reshape(-1).tolist())
    api.shape("trianglemesh", ps)
    return parse_string(tail, api)


def _commit(root: str) -> str:
    try:
        head = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"], capture_output=True,
                              text=True, check=True).stdout.strip()
        dirty = subprocess.run(["git", "-C", root, "status", "--porcelain", "--", "tpu_pbrt"],
                               capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    return head + ("+dirty" if dirty else "")


def _render(regen: bool, crown: bool = False):
    os.environ["TPU_PBRT_REGEN"] = "1" if regen else "0"
    os.environ["TPU_PBRT_POOL"] = str(POOL) if regen else "0"
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    from tpu_pbrt import config
    from tpu_pbrt.scenes import compile_api, make_killeroo_like

    config.reload()
    if crown:
        import tempfile

        from tpu_pbrt.scene.api import Options, parse_string, pbrt_init
        from tpu_pbrt.utils.imageio import write_image

        with tempfile.TemporaryDirectory() as tmp:
            env = os.path.join(tmp, "sky.pfm")
            write_image(env, crown_small_sky())
            api = parse_string(crown_small_text(env), pbrt_init(Options(quiet=True)))
            scene, integ = compile_api(api)
    else:
        scene, integ = compile_api(make_killeroo_like(**SMALL))
    assert "tstream" in scene.dev, "the small scenes must take the stream tracer"
    return scene, integ.render(scene)


def _write(path, scene, res, commit, pool: bool):
    import numpy as np

    extra = {}
    if pool:
        assert res.stats["pool"] == POOL and res.stats["regen"]
        extra = dict(
            n_waves=np.int64(res.stats["n_waves"]),
            pool=np.int64(res.stats["pool"]),
            mean_wave_occupancy=np.float64(res.stats["mean_wave_occupancy"]),
            counters=np.array(json.dumps(res.stats["telemetry"]["counters"], sort_keys=True)),
        )
    np.savez_compressed(
        path,
        image=np.asarray(res.image, np.float32),
        rays_traced=np.int64(res.rays_traced),
        n_tris=np.int64(scene.n_tris),
        n_treelets=np.int64(scene.dev["tstream"].n_treelets),
        jax_commit=np.array(commit),
        **extra,
    )
    print(f"wrote {path}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}"
          + (f", waves {res.stats['n_waves']}, counters {res.stats['telemetry']['counters']}"
             if pool else ""))


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    names = (TARGETS + tuple(DIRECT_CASES) + MEDIA_CASES + tuple(LT_CASES)
             + tuple(BREADTH_CASES) + ("direct", "media", "lt", "breadth", "all"))
    if which not in names:
        raise SystemExit(f"usage: {sys.argv[0]} [{'|'.join(names)}]")
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)

    commit = _commit(root)
    for target, path in zip(TARGETS, (OUT, OUT_POOL, OUT_CROWN, OUT_CROWN_POOL)):
        if which in (target, "all"):
            pool = target.endswith("pool")
            scene, res = _render(regen=pool, crown=target.startswith("crown"))
            _write(path, scene, res, commit, pool)
    for name in DIRECT_CASES:
        if which in (name, "direct", "all"):
            _write_direct(name, commit)
    for name in MEDIA_CASES:
        if which in (name, "media", "all"):
            _write_media(name, commit)
    for name in LT_CASES:
        if which in (name, "lt", "all"):
            _write_lt(name, commit)
    for name in BREADTH_CASES:
        if which in (name, "breadth", "all"):
            _write_breadth(name, commit)


def _write_media(name: str, commit: str) -> None:
    import time

    import numpy as np

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    from tpu_pbrt import config, scenes
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init

    config.reload()
    api = media_api(name, parse_string, pbrt_init, Options, jax_cloud_api)
    scene, integ = scenes.compile_api(api)
    t0 = time.perf_counter()
    res = integ.render(scene)
    path = os.path.join(HERE, f"{name}.npz")
    np.savez_compressed(
        path,
        image=np.asarray(res.image, np.float32),
        rays_traced=np.int64(res.rays_traced),
        n_tris=np.int64(scene.n_tris),
        jax_commit=np.array(commit),
    )
    print(f"wrote {path}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _write_lt(name: str, commit: str) -> None:
    import time

    import numpy as np

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    from tpu_pbrt import config, scenes
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init

    config.reload()
    api = lt_api(name, scenes, parse_string, pbrt_init, Options, jax_caustic_api,
                 scenes._crown_envmap_path())
    scene, integ = scenes.compile_api(api)
    t0 = time.perf_counter()
    res = integ.render(scene)
    path = os.path.join(HERE, f"{name}.npz")
    np.savez_compressed(
        path,
        image=np.asarray(res.image, np.float32),
        rays_traced=np.int64(res.rays_traced),
        n_tris=np.int64(scene.n_tris),
        jax_commit=np.array(commit),
    )
    print(f"wrote {path}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _write_breadth(name: str, commit: str) -> None:
    import time

    import numpy as np

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    os.environ["TPU_PBRT_REGEN"] = "1"
    os.environ["TPU_PBRT_POOL"] = str(POOL)
    from tpu_pbrt import config, scenes
    from tpu_pbrt_torch.scenes import BREADTH_SMALL

    config.reload()
    camera, filt = BREADTH_CASES[name]
    scene, integ = scenes.compile_api(jax_breadth_api(BREADTH_RES, BREADTH_SPP, camera=camera,
                                                      filter=filt, **BREADTH_SMALL))
    t0 = time.perf_counter()
    res = integ.render(scene)
    assert res.stats["pool"] == POOL and res.stats["regen"]
    path = os.path.join(HERE, f"{name}.npz")
    np.savez_compressed(
        path,
        image=np.asarray(res.image, np.float32),
        rays_traced=np.int64(res.rays_traced),
        n_tris=np.int64(scene.n_tris),
        n_waves=np.int64(res.stats["n_waves"]),
        jax_commit=np.array(commit),
    )
    print(f"wrote {path}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}, "
          f"waves {res.stats['n_waves']}, {time.perf_counter() - t0:.1f} s", flush=True)


def _write_direct(name: str, commit: str) -> None:
    import numpy as np

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    from tpu_pbrt import config, scenes

    config.reload()
    scene, integ = scenes.compile_api(direct_case_api(scenes, name))
    assert ("tstream" in scene.dev) == name.startswith("killeroo")
    res = integ.render(scene)
    path = os.path.join(HERE, f"{name}.npz")
    np.savez_compressed(
        path,
        image=np.asarray(res.image, np.float32),
        rays_traced=np.int64(res.rays_traced),
        n_tris=np.int64(scene.n_tris),
        jax_commit=np.array(commit),
    )
    print(f"wrote {path}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}",
          flush=True)


if __name__ == "__main__":
    main()
