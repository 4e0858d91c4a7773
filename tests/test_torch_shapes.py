"""The port's shapes and object instances against the JAX package's.

- Each tessellator of tpu_pbrt_torch/scene/compiler.py against the
  reference's function of the same name on the same parameters: the
  object-space vertices, shading normals and uvs equal bit for bit (both
  sides run the same float64 numpy).
- PLY files: the port's `write_ply` (binary little endian) and files the
  test writes in ascii and binary big endian (with uvs and a quad face,
  which the reader fans into two triangles) read by the port's
  `read_ply` equal to the reference's `read_ply`.
- `plymesh`: the reference's `_tess_ply` reads keys its own `read_ply`
  does not return and cannot compile, so the port's `plymesh` is held
  against the reference's `trianglemesh` of the same arrays (what
  `plymesh` means in pbrt-v3): every compiled table of the small breadth
  scene (tpu_pbrt_torch.scenes.BREADTH_SMALL, eight `ObjectInstance`s of
  a PLY blob, every other shape and the spot, goniometric, projection and
  infinite lights) equals the reference's through the bridge, and the
  port compiles both spellings to equal tables.
- Object instances on their own: nested transforms around `ObjectBegin`
  and each `ObjectInstance`, every table equal.
- A shape name the reference does not know is skipped with a warning on
  both sides.
"""

import os
import sys

import numpy as np
import pytest

import jax
import torch

from tpu_pbrt import config as jconfig
from tpu_pbrt.scene import compiler as jc
from tpu_pbrt.scene import plyreader as jply
from tpu_pbrt.scene.api import Options as JOptions
from tpu_pbrt.scene.api import parse_string as jparse_string
from tpu_pbrt.scene.api import pbrt_init as jpbrt_init
from tpu_pbrt.scene.paramset import ParamSet as JParamSet
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.scene import compiler as tc
from tpu_pbrt_torch.scene import plyreader as tply
from tpu_pbrt_torch.scene.api import Options as TOptions
from tpu_pbrt_torch.scene.api import parse_string, pbrt_init
from tpu_pbrt_torch.scene.bridge import flat_tables, tables_from_numpy
from tpu_pbrt_torch.scene.paramset import ParamSet as TParamSet
from tpu_pbrt_torch.scenes import BREADTH_SMALL, make_breadth_like

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))

_TETRA = [("integer indices", [0, 2, 1, 0, 1, 3, 1, 2, 3, 0, 3, 2]),
          ("point P", [1, 1, 1, -1, -1, 1, -1, 1, -1, 1, -1, -1])]
#: shape -> parameter lists handed to both packages' ParamSet
SHAPES = {
    "trianglemesh": [("integer indices", [0, 1, 2, 0, 2, 3]),
                     ("point P", [0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0]),
                     ("normal N", [0, 0, 1, 0, 0.6, 0.8, 0, 0, 1, 0.6, 0, 0.8]),
                     ("float uv", [0, 0, 1, 0, 1, 1, 0, 1])],
    "sphere": [("float radius", [0.7]), ("float zmin", [-0.3]), ("float phimax", [270])],
    "disk": [("float height", [0.2]), ("float radius", [1.5]), ("float innerradius", [0.4]),
             ("float phimax", [300])],
    "cylinder": [("float radius", [0.4]), ("float zmin", [-0.5]), ("float zmax", [1.2])],
    "cone": [("float radius", [0.6]), ("float height", [1.3]), ("float phimax", [200])],
    "paraboloid": [("float radius", [0.8]), ("float zmin", [0.1]), ("float zmax", [0.9])],
    "hyperboloid": [("point p1", [0.3, 0, -0.5]), ("point p2", [0, 0.4, 0.8]),
                    ("float phimax", [330])],
    "heightfield2": [("integer nu", [5]), ("integer nv", [4]),
                     ("float Pz", list(np.round(np.sin(np.arange(20) * 0.7), 4)))],
    "loopsubdiv": [("integer levels", [3])] + _TETRA,
    "curve": [("point P", [0, 0, 0, 0.3, 0.5, 0, 0.2, 1, 0.3, 0, 1.5, 0.1, -0.3, 2, 0,
                           -0.2, 2.4, -0.2, 0, 3, 0]),
              ("float width0", [0.1]), ("float width1", [0.02])],
    "curve_axis_tangent": [("point P", [0, 0, 0, 0, 0, 1, 0, 0, 2, 0, 0, 3]),
                           ("float width", [0.05])],
}


def _params(cls, spec):
    ps = cls()
    for decl, vals in spec:
        ps.add(decl, list(vals))
    return ps


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tessellator_matches_reference(shape):
    name = shape.split("_")[0]
    got = tc._TESSELLATORS[name](_params(TParamSet, SHAPES[shape]), ".")
    want = jc._TESSELATORS[name](_params(JParamSet, SHAPES[shape]), ".")
    assert len(got[0]) > 0
    for g, w, what in zip(got, want, ("verts", "normals", "uvs")):
        if w is None:
            assert g is None, what
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


def _ply_ascii(path, V, F, uv):
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(V)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property float u\nproperty float v\n"
                f"element face {len(F)}\nproperty list uchar int vertex_indices\nend_header\n")
        for p, t in zip(V, uv):
            f.write(" ".join(repr(float(x)) for x in (*p, *t)) + "\n")
        for fc in F:
            f.write(f"{len(fc)} " + " ".join(map(str, fc)) + "\n")


def _ply_big_endian(path, V, F, uv):
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_big_endian 1.0\nelement vertex {len(V)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property float s\nproperty float t\n"
                 f"element face {len(F)}\nproperty list uchar int vertex_indices\n"
                 "end_header\n").encode("ascii"))
        f.write(np.hstack([V, uv]).astype(">f4").tobytes())
        for fc in F:
            f.write(np.uint8(len(fc)).tobytes() + np.asarray(fc, ">i4").tobytes())


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii", "binary_big_endian"])
def test_ply_round_trip_matches_reference(fmt, tmp_path):
    rng = np.random.default_rng(3)
    # f32-representable values, which every format stores exactly
    V = rng.uniform(-1, 1, (7, 3)).astype(np.float32).astype(np.float64)
    N = V / np.linalg.norm(V, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (7, 2)).astype(np.float32).astype(np.float64)
    tris = [[0, 1, 2], [2, 3, 4], [4, 5, 6]]
    path = str(tmp_path / f"m_{fmt}.ply")
    if fmt == "binary_little_endian":
        tply.write_ply(path, V, np.asarray(tris), N)
    elif fmt == "ascii":
        _ply_ascii(path, V, tris + [[0, 2, 4, 6]], uv)
    else:
        _ply_big_endian(path, V, tris + [[1, 3, 5, 6]], uv)
    got, want = tply.read_ply(path), jply.read_ply(path)
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["vertices"], V)
    assert len(got["indices"]) == (3 if fmt == "binary_little_endian" else 5)
    assert (got["normals"] is not None) == (fmt == "binary_little_endian")
    assert (got["uvs"] is not None) == (fmt != "binary_little_endian")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same(ref_dev: dict, got_dev: dict):
    ref, got = flat_tables(ref_dev), flat_tables(got_dev)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]), err_msg=k)


def _leaf64():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PBRT_LEAF_TRIS", "64")
    mp.setattr(tcfg, "leaf_tris", 64)
    jconfig.reload()
    return mp


@pytest.fixture(scope="module")
def breadth_small():
    """The small breadth scene compiled by the reference (`trianglemesh`
    blob) and by the port (`plymesh` blob and `trianglemesh` blob)."""
    sys.path.insert(0, os.path.join(HERE, "torch_golden"))
    try:
        from make_golden import jax_breadth_api
    finally:
        sys.path.pop(0)
    mp = _leaf64()
    try:
        sj = jc.compile_scene(jax_breadth_api(16, 4, **BREADTH_SMALL))
        st_ply = tc.compile_scene(make_breadth_like(16, 4, **BREADTH_SMALL, device="cpu"))
        text_mesh = _trianglemesh_spelling()
        st_mesh = tc.compile_scene(parse_string(text_mesh, pbrt_init(TOptions(quiet=True),
                                                                     device="cpu")))
    finally:
        mp.undo()
        jconfig.reload()
    return sj, st_ply, st_mesh


def _trianglemesh_spelling():
    """The small breadth scene's text with the blob as the trianglemesh of
    the PLY file's arrays."""
    from tpu_pbrt_torch.scenes import breadth_parts

    head, ply, tail = breadth_parts(16, 4, **BREADTH_SMALL)
    m = tply.read_ply(ply)

    def arr(a):
        return " ".join(repr(float(x)) for x in a.reshape(-1))

    shape = (f'Shape "trianglemesh" "integer indices" [{" ".join(map(str, m["indices"].reshape(-1)))}]'
             f' "point P" [{arr(m["vertices"])}] "normal N" [{arr(m["normals"])}]\n')
    return head + shape + tail


def test_plymesh_instances_tables_equal_reference(breadth_small):
    """Every table of the small breadth scene (the `plymesh` blob in eight
    object instances) equals the reference's (its `trianglemesh` blob)."""
    sj, st, _ = breadth_small
    assert st.n_tris == sj.n_tris == 8 * 528 + 512 + 7296 + 64 + 16 * 32
    assert "tstream" in st.dev and "light_atlas" in st.dev
    _assert_same(tables_from_numpy(jax.tree.map(np.asarray, sj.dev), "cpu"), st.dev)
    assert st.dev["light"]["type"].tolist() == [1, 5, 6, 4]


def test_plymesh_and_trianglemesh_spellings_compile_equal(breadth_small):
    _, st_ply, st_mesh = breadth_small
    assert st_ply.n_tris == st_mesh.n_tris
    _assert_same(st_mesh.dev, st_ply.dev)


_INSTANCES = """
Integrator "path" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [1]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 1 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
WorldBegin
LightSource "point" "rgb I" [5 5 5] "point from" [0 3 -3]
AttributeBegin
Rotate 30 0 0 1
Translate 0.2 0 0
ObjectBegin "pair"
Material "plastic" "rgb Kd" [0.3 0.4 0.5]
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
Translate 0 0 0.5
Scale 0.5 0.5 0.5
Shape "sphere" "float radius" [0.8]
ObjectEnd
AttributeEnd
AttributeBegin
Translate -2 0 1
ObjectInstance "pair"
AttributeEnd
AttributeBegin
Translate 2 0.5 1
Rotate 45 0 1 0
Scale 1 -1 1
ObjectInstance "pair"
AttributeEnd
Shape "disk" "float radius" [4] "float height" [-1]
"""


def test_object_instances_tables_equal_reference():
    """Instances under nested transforms (one of them mirrored, which
    flips the shading normals) expand to the reference's triangles."""
    sj = jc.compile_scene(jparse_string(_INSTANCES, jpbrt_init(JOptions(quiet=True))))
    st = tc.compile_scene(parse_string(_INSTANCES, pbrt_init(TOptions(quiet=True),
                                                             device="cpu")))
    assert st.n_tris == sj.n_tris == 2 * (1 + 64 * 32 * 2) + 128
    _assert_same(tables_from_numpy(jax.tree.map(np.asarray, sj.dev), "cpu"), st.dev)
    api = parse_string(_INSTANCES + "WorldEnd\n", render=True, device="cpu")
    assert np.isfinite(api.result.image).all() and api.result.image.max() > 0


def test_unknown_shape_is_skipped_with_a_warning(monkeypatch):
    text = _INSTANCES.replace('Shape "disk"', 'Shape "nurbs" "integer nu" [4]\nShape "disk"')
    warned = []
    monkeypatch.setattr(tc, "Warning", warned.append)
    jwarned = []
    monkeypatch.setattr(jc, "Warning", jwarned.append)
    sj = jc.compile_scene(jparse_string(text, jpbrt_init(JOptions(quiet=True))))
    st = tc.compile_scene(parse_string(text, pbrt_init(TOptions(quiet=True), device="cpu")))
    assert warned == jwarned and any('"nurbs"' in w for w in warned)
    assert st.n_tris == sj.n_tris
    _assert_same(tables_from_numpy(jax.tree.map(np.asarray, sj.dev), "cpu"), st.dev)
