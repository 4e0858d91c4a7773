"""Built-in scenes (port of tpu_pbrt/scenes.py: the Cornell box, the
killeroo-class mesh and the crown-class scene), and the cloud-class,
caustic-glass-class and scene-breadth scenes.

Same scene text and the same procedural meshes and sky as the reference,
driven through the port's API, so both packages compile identical worlds.
The reference has no cloud, caustic or breadth scene: `cloud_parts`,
`caustic_parts` and `breadth_parts` hold their text and meshes, which the
port parses here and the JAX reference's generators (under
tests/torch_golden/) parse through the JAX package's API.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_pbrt_torch.scene.api import Options, PbrtAPI, parse_string, pbrt_init
from tpu_pbrt_torch.scene.paramset import ParamSet


def cornell_box_text(res=256, spp=16, integrator="directlighting", maxdepth=5, filename="",
                     sampler="zerotwosequence"):
    """The Cornell box: area light + Lambertian walls and blocks."""
    return f'''
Integrator "{integrator}" "integer maxdepth" [{maxdepth}]
Sampler "{sampler}" "integer pixelsamples" [{spp}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}] "string filename" ["{filename}"]
LookAt 0.5 0.5 -1.4  0.5 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
# floor (normal +y)
Material "matte" "rgb Kd" [0.73 0.73 0.73]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [0 0 0  0 0 1  1 0 1  1 0 0]
# ceiling (normal -y)
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [0 1 0  1 1 0  1 1 1  0 1 1]
# back wall (normal -z)
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [0 0 1  0 1 1  1 1 1  1 0 1]
# left wall, red (normal +x)
Material "matte" "rgb Kd" [0.65 0.05 0.05]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [0 0 0  0 1 0  0 1 1  0 0 1]
# right wall, green (normal -x)
Material "matte" "rgb Kd" [0.12 0.45 0.15]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [1 0 0  1 0 1  1 1 1  1 1 0]
# short block
Material "matte" "rgb Kd" [0.73 0.73 0.73]
AttributeBegin
Translate 0.65 0.15 0.3
Rotate -18 0 1 0
Scale 0.15 0.15 0.15
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3  4 6 5 4 7 6  0 4 1 1 4 5  2 6 3 3 6 7  1 5 2 2 5 6  0 3 7 0 7 4]
  "point P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1  -1 1 -1  1 1 -1  1 1 1  -1 1 1]
AttributeEnd
# tall block
AttributeBegin
Translate 0.3 0.3 0.65
Rotate 15 0 1 0
Scale 0.15 0.3 0.15
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3  4 6 5 4 7 6  0 4 1 1 4 5  2 6 3 3 6 7  1 5 2 2 5 6  0 3 7 0 7 4]
  "point P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1  -1 1 -1  1 1 -1  1 1 1  -1 1 1]
AttributeEnd
# light (faces -y, just below ceiling)
AttributeBegin
AreaLightSource "diffuse" "rgb L" [15 11 5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [0.35 0.998 0.35  0.65 0.998 0.35  0.65 0.998 0.65  0.35 0.998 0.65]
AttributeEnd
WorldEnd
'''


def make_cornell(res=256, spp=16, integrator="directlighting", maxdepth=5, options=None,
                 sampler="zerotwosequence", device=None) -> PbrtAPI:
    """Parse the Cornell box up to (not including) WorldEnd."""
    api = pbrt_init(options or Options(quiet=True), device=device)
    text = cornell_box_text(res, spp, integrator, maxdepth, sampler=sampler)
    parse_string(text.rsplit("WorldEnd", 1)[0], api, render=False)
    return api


def _displaced_sphere(n_theta=180, n_phi=360, seed=7):
    """Procedural blobby mesh, ~(n_theta-1)*n_phi*2 triangles, with shading
    normals — a killeroo-class triangle count with curvature everywhere."""
    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.02, 0.08, size=6)
    freqs = rng.integers(2, 9, size=(6, 2))
    th = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = np.ones_like(T)
    for a, (f1, f2) in zip(amps, freqs):
        r = r + a * np.sin(f1 * T) * np.cos(f2 * P)
    x = r * np.sin(T) * np.cos(P)
    y = r * np.cos(T)
    z = r * np.sin(T) * np.sin(P)
    V = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    i = np.arange(n_theta - 1)[:, None]
    j = np.arange(n_phi)[None, :]
    a = i * n_phi + j
    b = (i + 1) * n_phi + j
    c = (i + 1) * n_phi + (j + 1) % n_phi
    e = i * n_phi + (j + 1) % n_phi
    F = np.stack([np.stack([a, b, c], -1), np.stack([a, c, e], -1)], axis=2)
    F = F.reshape(-1, 3).astype(np.int64)
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    N = np.zeros_like(V)
    for k in range(3):
        np.add.at(N, F[:, k], fn)
    N /= np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-20)
    return V, F, N


def make_killeroo_like(res=512, spp=64, integrator="path", maxdepth=5,
                       n_theta=180, n_phi=360, options=None, device=None) -> PbrtAPI:
    """killeroo-simple stand-in: one ~128k-triangle matte mesh over a ground
    plane, one area light + point fill, path integrator. Parsed up to
    (not including) WorldEnd; compile with scene.compiler.compile_scene."""
    api = pbrt_init(options or Options(quiet=True), device=device)
    parse_string(
        f'''
Integrator "{integrator}" "integer maxdepth" [{maxdepth}]
Sampler "zerotwosequence" "integer pixelsamples" [{spp}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}] "string filename" [""]
LookAt 0 1.2 -3.4  0 0.3 0  0 1 0
Camera "perspective" "float fov" [38]
WorldBegin
AttributeBegin
AreaLightSource "diffuse" "rgb L" [18 17 15]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-1 2.98 -1  1 2.98 -1  1 2.98 1  -1 2.98 1]
AttributeEnd
LightSource "point" "rgb I" [4 4 5] "point from" [2.5 2 -2.5]
Material "matte" "rgb Kd" [0.82 0.78 0.75]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-6 -0.72 -6  -6 -0.72 6  6 -0.72 6  6 -0.72 -6]
Material "matte" "rgb Kd" [0.35 0.30 0.25]
''',
        api,
        render=False,
    )
    V, F, N = _displaced_sphere(n_theta, n_phi)
    ps = ParamSet()
    ps.add("integer indices", F.reshape(-1).tolist())
    ps.add("point P", V.reshape(-1).tolist())
    ps.add("normal N", N.reshape(-1).tolist())
    api.shape("trianglemesh", ps)
    return api


#: the directory of the port's generated scene files (gitignored)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         ".torch_build")


def _publish(path: str, write) -> str:
    """Write a generated scene file once: `write(tmp)` fills a temporary
    file that then replaces `path` whole (concurrent writers each publish
    a complete file)."""
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp{os.path.splitext(path)[1]}"
    write(tmp)
    os.replace(tmp, path)
    return path


#: where the port writes its copy of the crown's procedural sky
CROWN_ENV_PATH = os.path.join(BUILD_DIR, "crown_env.pfm")


def crown_sky(h: int = 64, w: int = 128) -> np.ndarray:
    """The crown's procedural HDR sky (a gradient and a warm sun disk) as
    an (h, w, 3) f32 lat-long map: the reference's formula, at any size."""
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
    sun_dir = (0.45 * np.pi, 0.3 * np.pi)
    d2 = (th - sun_dir[0]) ** 2 + (ph - sun_dir[1]) ** 2
    sun = np.exp(-d2 / 0.004)[..., None] * np.asarray([60.0, 50.0, 35.0])
    return (sky + sun).astype(np.float32)


def _crown_envmap_path(path: str = CROWN_ENV_PATH) -> str:
    """The crown's 64x128 sky as a PFM file, written once (by the port's
    own imageio, byte for byte the reference's refimg/crown_env.pfm)."""
    from tpu_pbrt_torch.utils.imageio import write_image

    return _publish(path, lambda tmp: write_image(tmp, crown_sky()))


def _add_mesh(api: PbrtAPI, V, F, N) -> None:
    ps = ParamSet()
    ps.add("integer indices", F.reshape(-1).tolist())
    ps.add("point P", V.reshape(-1).tolist())
    ps.add("normal N", N.reshape(-1).tolist())
    api.shape("trianglemesh", ps)


def make_crown_like(res=512, spp=64, maxdepth=5, options=None, n_theta=500, n_phi=1000,
                    device=None) -> PbrtAPI:
    """crown-class stand-in: a >= 1M-triangle displaced mesh in glass, two
    metal-GGX side pieces (one anisotropic), a matte ground and the HDR
    sky as an infinite light sampled from its 2D CDF. Parsed up to (not
    including) WorldEnd."""
    api = pbrt_init(options or Options(quiet=True), device=device)
    env = _crown_envmap_path()
    parse_string(
        f"""
Integrator "path" "integer maxdepth" [{maxdepth}]
Sampler "zerotwosequence" "integer pixelsamples" [{spp}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}] "string filename" [""]
LookAt 0 1.4 -3.6  0 0.4 0  0 1 0
Camera "perspective" "float fov" [39]
WorldBegin
LightSource "infinite" "string mapname" ["{env}"]
Material "matte" "rgb Kd" [0.45 0.42 0.38]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-8 -0.75 -8  -8 -0.75 8  8 -0.75 8  8 -0.75 -8]
Material "glass" "float eta" [1.5] "rgb Kr" [1 1 1] "rgb Kt" [1 1 1]
""",
        api,
        render=False,
    )
    _add_mesh(api, *_displaced_sphere(n_theta, n_phi))
    parse_string(
        """
AttributeBegin
Material "metal" "float roughness" [0.05]
Translate -1.7 -0.15 0.4
Scale 0.55 0.55 0.55
""",
        api,
        render=False,
    )
    _add_mesh(api, *_displaced_sphere(140, 280, seed=11))
    parse_string(
        """
AttributeEnd
AttributeBegin
Material "metal" "float roughness" [0.18] "float uroughness" [0.3] "float vroughness" [0.05]
Translate 1.7 -0.1 0.6
Scale 0.6 0.6 0.6
""",
        api,
        render=False,
    )
    _add_mesh(api, *_displaced_sphere(140, 280, seed=23))
    parse_string("AttributeEnd\n", api, render=False)
    return api


#: the cloud's homogeneous medium: optical depth about 5 across the blob
CLOUD_MEDIUM = ('MakeNamedMedium "cloud" "string type" "homogeneous" '
                '"rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [2.5 2.5 2.5] "float g" [0.5]')


def cloud_parts(res, spp, maxdepth, n_theta, n_phi, env_path):
    """The cloud-class scene as (text up to the container, the container's
    (V, F, N) arrays, the closing text): the killeroo's camera, ground,
    quad area light and point light, the crown's HDR sky as an infinite
    light, and the killeroo's displaced sphere as a `Material "none"`
    container holding CLOUD_MEDIUM (`MediumInterface "cloud" ""`), under
    `volpath` with `zerotwosequence`. The sphere's faces wind inward, so
    its winding and normals are reversed: the interface's inside is then
    the blob's interior."""
    head = f"""
Integrator "volpath" "integer maxdepth" [{maxdepth}]
Sampler "zerotwosequence" "integer pixelsamples" [{spp}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}] "string filename" [""]
LookAt 0 1.2 -3.4  0 0.3 0  0 1 0
Camera "perspective" "float fov" [38]
WorldBegin
LightSource "infinite" "string mapname" ["{env_path}"]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [18 17 15]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-1 2.98 -1  1 2.98 -1  1 2.98 1  -1 2.98 1]
AttributeEnd
LightSource "point" "rgb I" [4 4 5] "point from" [2.5 2 -2.5]
Material "matte" "rgb Kd" [0.82 0.78 0.75]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-6 -0.72 -6  -6 -0.72 6  6 -0.72 6  6 -0.72 -6]
{CLOUD_MEDIUM}
AttributeBegin
Material "none"
MediumInterface "cloud" ""
"""
    V, F, N = _displaced_sphere(n_theta, n_phi)
    return head, (V, np.ascontiguousarray(F[:, ::-1]), -N), "AttributeEnd\n"


def make_cloud_like(res=256, spp=16, maxdepth=5, n_theta=180, n_phi=360, options=None,
                    device=None) -> PbrtAPI:
    """cloud-class stand-in (`cloud.pbrt`: VolPathIntegrator in a
    homogeneous medium): `cloud_parts` at the killeroo's 128,880-triangle
    container. Parsed up to (not including) WorldEnd."""
    api = pbrt_init(options or Options(quiet=True), device=device)
    head, mesh, tail = cloud_parts(res, spp, maxdepth, n_theta, n_phi, _crown_envmap_path())
    parse_string(head, api, render=False)
    _add_mesh(api, *mesh)
    parse_string(tail, api, render=False)
    return api


def caustic_parts(res, spp, maxdepth, n_theta, n_phi, integrator="bdpt", params=""):
    """The caustic-glass-class scene as (text up to the glass mesh, the
    mesh's (V, F, N) arrays, the closing text): the killeroo's camera,
    matte ground and quad area light, a point light behind the blob that
    the glass focuses onto the ground in front of it (a point-light
    caustic behind a specular chain, which a unidirectional path tracer
    cannot render), and the killeroo's displaced sphere as `Material
    "glass"` (eta 1.5), its winding and normals reversed (the sphere's
    faces wind inward) so that the dielectric sees the outside as
    outside. `zerotwosequence`, box filter, no infinite light;
    `integrator` ("bdpt", "sppm" or "mlt") takes maxdepth and `params`,
    more integrator parameters as scene text."""
    head = f"""
Integrator "{integrator}" "integer maxdepth" [{maxdepth}] {params}
Sampler "zerotwosequence" "integer pixelsamples" [{spp}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}] "string filename" [""]
LookAt 0 1.2 -3.4  0 0.3 0  0 1 0
Camera "perspective" "float fov" [38]
WorldBegin
AttributeBegin
AreaLightSource "diffuse" "rgb L" [18 17 15]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-1 2.98 -1  1 2.98 -1  1 2.98 1  -1 2.98 1]
AttributeEnd
LightSource "point" "rgb I" [30 28 24] "point from" [-2.5 1.8 3.5]
Material "matte" "rgb Kd" [0.82 0.78 0.75]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-6 -0.72 -6  -6 -0.72 6  6 -0.72 6  6 -0.72 -6]
AttributeBegin
Material "glass" "float eta" [1.5]
"""
    V, F, N = _displaced_sphere(n_theta, n_phi)
    return head, (V, np.ascontiguousarray(F[:, ::-1]), -N), "AttributeEnd\n"


def make_caustic_like(res=256, spp=16, maxdepth=5, integrator="bdpt", params="", n_theta=180,
                      n_phi=360, options=None, device=None) -> PbrtAPI:
    """caustic-glass-class stand-in (pbrt-v3-scenes' `caustic-glass`, under
    BDPT, SPPM or MLT): `caustic_parts` at the killeroo's 128,880-triangle
    glass blob. Parsed up to (not including) WorldEnd."""
    api = pbrt_init(options or Options(quiet=True), device=device)
    head, mesh, tail = caustic_parts(res, spp, maxdepth, n_theta, n_phi, integrator, params)
    parse_string(head, api, render=False)
    _add_mesh(api, *mesh)
    parse_string(tail, api, render=False)
    return api


def gonio_map(h: int = 32, w: int = 64) -> np.ndarray:
    """The breadth scene's goniometric diagram: an (h, w, 3) lat-long map
    (theta from the light's +Y axis), brighter toward the equator with
    eight lobes in phi."""
    th = (np.arange(h) + 0.5)[:, None] / h * np.pi
    ph = (np.arange(w) + 0.5)[None, :] / w * 2 * np.pi
    lobe = 0.25 + np.sin(th) ** 2 * (0.6 + 0.4 * np.cos(8 * ph))
    return (lobe[..., None] * np.asarray([1.0, 0.9, 0.75])).astype(np.float32)


def projection_map(n: int = 64) -> np.ndarray:
    """The breadth scene's projected picture: an (n, n, 3) colored
    checkerboard inside a bright frame."""
    i = np.arange(n)
    check = ((i[:, None] // 8 + i[None, :] // 8) % 2).astype(np.float64)
    img = np.stack([0.3 + 0.7 * check, 0.3 + 0.5 * (1 - check), 0.4 + 0.2 * check], -1)
    edge = (np.minimum(i, n - 1 - i)[:, None] < 2) | (np.minimum(i, n - 1 - i)[None, :] < 2)
    img[edge] = 1.5
    return img.astype(np.float32)


def breadth_files(n_theta: int = 180, n_phi: int = 360) -> dict:
    """The breadth scene's generated files, written once under
    .torch_build/: the blob (`_displaced_sphere(n_theta, n_phi)` with its
    normals) as a binary PLY, and the goniometric and projection maps as
    PFM. Returns their paths as {"blob", "gonio", "proj"}."""
    from tpu_pbrt_torch.scene.plyreader import write_ply
    from tpu_pbrt_torch.utils.imageio import write_image

    suffix = "" if (n_theta, n_phi) == (180, 360) else f"_{n_theta}x{n_phi}"
    return {
        "blob": _publish(os.path.join(BUILD_DIR, f"breadth_blob{suffix}.ply"),
                         lambda t: write_ply(t, *_displaced_sphere(n_theta, n_phi))),
        "gonio": _publish(os.path.join(BUILD_DIR, "breadth_gonio.pfm"),
                          lambda t: write_image(t, gonio_map())),
        "proj": _publish(os.path.join(BUILD_DIR, "breadth_proj.pfm"),
                         lambda t: write_image(t, projection_map())),
    }


#: camera lines of the breadth scene, by camera type
BREADTH_CAMERAS = {
    "perspective": 'Camera "perspective" "float fov" [45]',
    "realistic": ('Camera "realistic" "float focusdistance" [5.2] '
                  '"float aperturediameter" [4]'),
    "orthographic": 'Camera "orthographic" "float screenwindow" [-3.4 3.4 -3.4 3.4]',
    "environment": 'Camera "environment"',
}
#: the small tessellation of the breadth scene (tests and goldens)
BREADTH_SMALL = dict(n_theta=12, n_phi=24, n_height=17, n_curves=16, subdiv_levels=2)


def _heightfield_text(n: int) -> str:
    x = np.linspace(0.0, 1.0, n)
    xx, yy = np.meshgrid(x, x)
    z = 0.05 * np.sin(6 * np.pi * xx) * np.cos(4 * np.pi * yy) + 0.03 * np.cos(10 * np.pi * xx * yy)
    vals = " ".join(f"{v:.6f}" for v in z.reshape(-1))
    return (f'Shape "heightfield2" "integer nu" [{n}] "integer nv" [{n}] "float Pz" [{vals}]')


def _curves_text(n: int) -> str:
    """n grass strands, one cubic Bezier segment each, on a square patch
    at the front right, seeded."""
    rng = np.random.default_rng(5)
    side = int(np.ceil(np.sqrt(n)))
    lines = []
    for k in range(n):
        x = 0.9 + 1.5 * ((k % side) + rng.uniform(0.2, 0.8)) / side
        z = -1.2 + 1.0 * ((k // side) + rng.uniform(0.2, 0.8)) / side
        h = rng.uniform(0.25, 0.5)
        bx, bz = rng.uniform(-0.15, 0.15, 2)
        pts = [x, -0.78, z, x, -0.78 + h / 3, z, x + bx / 2, -0.78 + 2 * h / 3, z + bz / 2,
               x + bx, -0.78 + h, z + bz]
        lines.append('Shape "curve" "point P" [' + " ".join(f"{v:.6f}" for v in pts)
                     + '] "float width0" [0.02] "float width1" [0.004]')
    return "\n".join(lines)


def breadth_parts(res, spp, maxdepth=5, camera="perspective", filter="gaussian", n_instances=8,
                  n_theta=180, n_phi=360, n_height=257, n_curves=256, subdiv_levels=4):
    """The breadth scene as (text up to the instanced blob's shape, the
    blob's PLY path, the text after it), its files written by
    breadth_files.

    Every shape of the reference: `n_instances` `ObjectInstance`s of one
    `ObjectBegin "blob"` (the killeroo's displaced sphere in plastic,
    declared between the two texts, each instance under its own rotation,
    scale and position), a `heightfield2` ground of n_height^2 heights, a
    `disk`, a `cylinder`, a `cone`, a `paraboloid` and a `hyperboloid`,
    a `loopsubdiv` tetrahedron at `subdiv_levels` and `n_curves` `curve`
    strands, in matte, plastic, metal and glass. Lights: a `spot` key
    light, a `goniometric` and a `projection` light with the maps of
    gonio_map / projection_map, and a dim constant `infinite` fill.
    `path` at `maxdepth` with `zerotwosequence`; `camera` is a key of
    BREADTH_CAMERAS, `filter` any pixel filter with its defaults."""
    files = breadth_files(n_theta, n_phi)
    head = f"""
Integrator "path" "integer maxdepth" [{maxdepth}]
Sampler "zerotwosequence" "integer pixelsamples" [{spp}]
PixelFilter "{filter}"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}] "string filename" [""]
LookAt 0 1.6 -4.4  0 0.0 1.2  0 1 0
{BREADTH_CAMERAS[camera]}
WorldBegin
LightSource "spot" "rgb I" [40 38 34] "point from" [2.5 4 -2] "point to" [0 -0.5 1] "float coneangle" [40] "float conedeltaangle" [10]
AttributeBegin
Translate -2.8 2.2 0.5
LightSource "goniometric" "rgb I" [6 6 7] "string mapname" ["{files['gonio']}"]
AttributeEnd
AttributeBegin
Translate 0.5 3.2 1.0
Rotate 90 1 0 0
LightSource "projection" "rgb I" [14 13 12] "float fov" [60] "string mapname" ["{files['proj']}"]
AttributeEnd
LightSource "infinite" "rgb L" [0.08 0.09 0.12]
AttributeBegin
Material "matte" "rgb Kd" [0.55 0.5 0.45]
Translate -6 -0.8 6
Rotate -90 1 0 0
Scale 12 12 1
{_heightfield_text(n_height)}
AttributeEnd
AttributeBegin
Material "matte" "rgb Kd" [0.2 0.45 0.15]
{_curves_text(n_curves)}
AttributeEnd
AttributeBegin
Material "metal" "float roughness" [0.08]
Translate -1.6 -0.45 -0.9
Scale 0.35 0.35 0.35
Shape "loopsubdiv" "integer levels" [{subdiv_levels}] "integer indices" [0 2 1  0 1 3  1 2 3  0 3 2] "point P" [1 1 1  -1 -1 1  -1 1 -1  1 -1 -1]
AttributeEnd
AttributeBegin
Material "matte" "rgb Kd" [0.7 0.2 0.15]
Translate -2.4 -0.8 3.0
Rotate -90 1 0 0
Shape "cylinder" "float radius" [0.25] "float zmin" [0] "float zmax" [0.8]
AttributeEnd
AttributeBegin
Material "plastic" "rgb Kd" [0.2 0.3 0.7] "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.1]
Translate -1.2 -0.8 3.0
Rotate -90 1 0 0
Shape "cone" "float radius" [0.3] "float height" [0.8]
AttributeEnd
AttributeBegin
Material "metal" "float roughness" [0.03]
Translate 0 -0.2 3.0
Rotate 90 1 0 0
Shape "paraboloid" "float radius" [0.35] "float zmin" [0] "float zmax" [0.6]
AttributeEnd
AttributeBegin
Material "glass" "float eta" [1.5]
Translate 1.2 -0.8 3.0
Rotate -90 1 0 0
Shape "hyperboloid" "point p1" [0.3 0 0] "point p2" [0 0.3 0.8]
AttributeEnd
AttributeBegin
Material "matte" "rgb Kd" [0.8 0.75 0.3]
Translate 2.4 -0.35 3.0
Rotate 180 0 1 0
Shape "disk" "float radius" [0.4]
AttributeEnd
ObjectBegin "blob"
Material "plastic" "rgb Kd" [0.5 0.3 0.2] "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.05]
"""
    uses = []
    for i in range(n_instances):
        row, col = divmod(i, 4)
        x = -2.1 + 1.4 * col + 0.35 * (row % 2)
        z = 0.2 + 1.3 * row
        uses.append(f"AttributeBegin\nTranslate {x:.3f} -0.38 {z:.3f}\nRotate {37 * i} 0 1 0\n"
                    f"Scale {0.42 + 0.02 * (i % 3):.3f} {0.42 + 0.02 * (i % 3):.3f} "
                    f'{0.42 + 0.02 * (i % 3):.3f}\nObjectInstance "blob"\nAttributeEnd')
    tail = "ObjectEnd\n" + "\n".join(uses) + "\n"
    return head, files["blob"], tail


def make_breadth_like(res, spp, maxdepth=5, camera="perspective", filter="gaussian",
                      n_instances=8, n_theta=180, n_phi=360, n_height=257, n_curves=256,
                      subdiv_levels=4, options=None, device=None) -> PbrtAPI:
    """The scene-breadth stand-in (`breadth_parts`): every shape, object
    instances, a filter and a camera of choice and the spot, goniometric,
    projection and infinite lights; 1,178,624 triangles at the defaults
    (8 x 128,880 instanced blob triangles, a 131,072-triangle heightfield,
    7,296 quadric, 1,024 subdivision and 8,192 curve triangles). The blob
    is a `Shape "plymesh"` of the PLY file breadth_files writes. Parsed up
    to (not including) WorldEnd."""
    api = pbrt_init(options or Options(quiet=True), device=device)
    head, ply, tail = breadth_parts(res, spp, maxdepth, camera, filter, n_instances, n_theta,
                                    n_phi, n_height, n_curves, subdiv_levels)
    parse_string(head + f'Shape "plymesh" "string filename" ["{ply}"]\n' + tail, api,
                 render=False)
    return api


def compile_api(api: PbrtAPI):
    """Compile the world accumulated so far (WorldEnd's compile step without
    the render or the state reset) -> (CompiledScene, integrator)."""
    from tpu_pbrt_torch.integrators import make_integrator
    from tpu_pbrt_torch.scene.compiler import compile_scene

    scene = compile_scene(api)
    integ = make_integrator(
        api.render_options.integrator_name, api.render_options.integrator_params, scene,
        api.options,
    )
    return scene, integ
