"""The port's cameras (tpu_pbrt_torch/cameras/) against the JAX package's.

- make_camera: the raster-to-camera and camera-to-world matrices, the
  lens radius and focal distance of the perspective, orthographic,
  environment and realistic cameras (the realistic camera's thin-lens
  proxy included) equal the reference's bit for bit; an unknown camera
  name takes "perspective" with a warning on both sides.
- compile_lens: the focused element stack and the exit-pupil table of
  the built-in doublet and of a prescription the test writes (both
  sides run the same float64 numpy) equal the reference's; the test's
  prescription parses to the reference's rows, and "aperturediameter"
  rescales (or, past the stop's bound, leaves) the stop as the
  reference does.
- generate_rays on 4,096 seeded raster points and lens samples: the
  orthographic camera with and without a thin lens, the environment
  camera, the realistic camera (the doublet stopped down, the doublet
  wide open, and the test's prescription) and the perspective camera
  with a thin lens. Origins and directions agree to 1e-5 absolute (the
  two libraries' sin/cos/sqrt may round an ulp apart; the JAX side runs
  op by op), the weights to 1e-5 relative, and the realistic camera's
  vignetting mask (weight > 0) exactly, with vignetted and passing lanes
  both present.
- Film.physical_extent equals the reference's.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt import cameras as jcam
from tpu_pbrt.cameras import realistic as jreal
from tpu_pbrt.core import transform as jxf
from tpu_pbrt.core.film import Film as JFilm
from tpu_pbrt.scene.paramset import ParamSet as JParamSet
from tpu_pbrt_torch import cameras as tcam
from tpu_pbrt_torch.cameras import realistic as treal
from tpu_pbrt_torch.core import transform as txf
from tpu_pbrt_torch.core.film import Film as TFilm
from tpu_pbrt_torch.scene.paramset import ParamSet as TParamSet

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

N = 4096
RES = (48, 32)
FILM_DIAG = 0.035

#: a pbrt lens prescription (radius, thickness, eta, aperture diameter in
#: mm, front to rear): a cemented doublet, an air gap and the stop
PRESCRIPTION = """# test lens
  35.0   4.0  1.62   18.0
 -28.0   1.5  1.72   18.0
 180.0   6.0  1.0    16.0   # rear of the doublet
   0.0  30.0  0.0    10.0
"""

#: case -> (camera name, its parameters)
CASES = {
    "orthographic": ("orthographic", [("float screenwindow", [-2, 2, -1.5, 1.5])]),
    "orthographic_lens": ("orthographic", [("float lensradius", [0.05]),
                                           ("float focaldistance", [3.0])]),
    "environment": ("environment", []),
    "perspective_lens": ("perspective", [("float fov", [50]), ("float lensradius", [0.04]),
                                         ("float focaldistance", [4.0])]),
    "realistic": ("realistic", [("float focusdistance", [5.2]),
                                ("float aperturediameter", [4])]),
    "realistic_wide": ("realistic", [("float focusdistance", [2.0]),
                                     ("float aperturediameter", [30])]),
    "realistic_lensfile": ("realistic", [("string lensfile", ["lens.dat"]),
                                         ("float focusdistance", [3.0]),
                                         ("float aperturediameter", [6])]),
}


def _params(cls, spec):
    ps = cls()
    for decl, vals in spec:
        ps.add(decl, list(vals))
    return ps


@pytest.fixture(scope="module")
def lens_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lens")
    (d / "lens.dat").write_text(PRESCRIPTION)
    return str(d)


def _look_at(xf):
    return xf.look_at([0.3, 1.2, -4.0], [0.0, 0.2, 1.0], [0.0, 1.0, 0.0])


def _cameras(case, lens_dir):
    name, spec = CASES[case]
    jc = jcam.make_camera(name, _params(JParamSet, spec), _look_at(jxf), RES, (0.0, 1.0),
                          film_diag=FILM_DIAG, scene_dir=lens_dir)
    tc = tcam.make_camera(name, _params(TParamSet, spec), _look_at(txf), RES, (0.0, 1.0),
                          film_diag=FILM_DIAG, scene_dir=lens_dir, device="cpu")
    return jc, tc


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_camera_matches_reference(case, lens_dir):
    jc, tc = _cameras(case, lens_dir)
    assert tc.cam_type == jc.cam_type
    np.testing.assert_array_equal(tc.raster_to_camera.numpy(), np.asarray(jc.raster_to_camera))
    np.testing.assert_array_equal(tc.camera_to_world.numpy(), np.asarray(jc.camera_to_world))
    assert tc.lens_radius == float(jc.lens_radius)
    assert tc.focal_distance == float(jc.focal_distance)
    assert (tc.lens is None) == (jc.lens is None)
    if jc.lens is not None:
        for f in ("z_apex", "radius", "eta_ratio", "ap2", "pupil"):
            np.testing.assert_array_equal(np.asarray(getattr(tc.lens, f)),
                                          np.asarray(getattr(jc.lens, f)), err_msg=f)
        for f in ("rear_z", "rear_ap", "film_diag"):
            assert getattr(tc.lens, f) == getattr(jc.lens, f), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_rays_match_reference(case, lens_dir):
    jc, tc = _cameras(case, lens_dir)
    rng = np.random.default_rng(11)
    p_film = (rng.uniform(0, 1, (N, 2)) * np.asarray(RES)).astype(np.float32)
    u_lens = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    jo, jd, jw = (np.asarray(a) for a in jcam.generate_rays(jc, jnp.asarray(p_film.copy()),
                                                           jnp.asarray(u_lens.copy())))
    to, td, tw = (a.numpy() for a in tcam.generate_rays(tc, torch.from_numpy(p_film.copy()),
                                                       torch.from_numpy(u_lens.copy())))
    np.testing.assert_array_equal(tw > 0, jw > 0)
    ok = jw > 0
    np.testing.assert_allclose(to[ok], jo[ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(td[ok], jd[ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=0)
    if case.startswith("realistic"):
        assert 0 < int(ok.sum()) < N  # vignetted and passing lanes both
    else:
        assert ok.all()


def test_lens_prescription_and_aperture(lens_dir):
    path = f"{lens_dir}/lens.dat"
    rows = treal.parse_lens_file(path)
    np.testing.assert_array_equal(rows, jreal.parse_lens_file(path))
    assert rows.shape == (4, 4) and rows[3, 3] == pytest.approx(0.010)
    for ap in (0.004, 0.5):  # inside the stop's 10 mm, and past it (clamped to the stop)
        np.testing.assert_array_equal(treal.apply_aperture_diameter(rows, ap),
                                      jreal.apply_aperture_diameter(rows, ap))
    for rx in (rows, treal.builtin_doublet(ap_diam=0.004)):
        tl = treal.compile_lens(rx, 3.0, FILM_DIAG)
        jl = jreal.compile_lens(rx, 3.0, FILM_DIAG)
        for f in ("z_apex", "radius", "eta_ratio", "ap2", "pupil"):
            np.testing.assert_array_equal(np.asarray(getattr(tl, f)), np.asarray(getattr(jl, f)),
                                          err_msg=f)
        assert (tl.rear_z, tl.rear_ap, tl.film_diag) == (jl.rear_z, jl.rear_ap, jl.film_diag)
    with pytest.raises(ValueError):
        treal.parse_lens_file(__file__)


def test_unknown_camera_takes_perspective(monkeypatch):
    warned, jwarned = [], []
    monkeypatch.setattr(tcam, "Warning", warned.append)
    monkeypatch.setattr(jcam, "Warning", jwarned.append)
    spec = [("float fov", [35])]
    tc = tcam.make_camera("fisheye", _params(TParamSet, spec), _look_at(txf), RES)
    jc = jcam.make_camera("fisheye", _params(JParamSet, spec), _look_at(jxf), RES)
    assert warned == jwarned and len(warned) == 1
    assert tc.cam_type == jc.cam_type == tcam.CAM_PERSPECTIVE
    np.testing.assert_array_equal(tc.raster_to_camera.numpy(), np.asarray(jc.raster_to_camera))


@pytest.mark.parametrize("res,diag", [((48, 32), 35.0), ((64, 64), 50.0), ((20, 90), 24.0)])
def test_physical_extent_matches_reference(res, diag):
    assert TFilm(res, diagonal_mm=diag).physical_extent() == \
        JFilm(res, diagonal_mm=diag).physical_extent()
