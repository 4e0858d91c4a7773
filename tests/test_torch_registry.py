"""The integrator plugin registry (tpu_pbrt_torch/integrators/__init__.py)
against the reference's (tpu_pbrt/integrators/__init__.py): the built-in
names construct the same classes by name, a registered class is built
for its name, a registered name overrides a built-in one, and an unknown
name raises PbrtError listing the available names, as the reference's
Error does."""

import pytest
import torch

from tpu_pbrt import integrators as rint
from tpu_pbrt.utils.error import PbrtError as RefPbrtError
from tpu_pbrt_torch import integrators as tint
from tpu_pbrt_torch.scene.api import parse_string
from tpu_pbrt_torch.scenes import compile_api, make_cornell
from tpu_pbrt_torch.utils.error import PbrtError

torch.set_num_threads(1)

#: the built-in names and the class each builds, in both packages
BUILTIN = {"path": "PathIntegrator", "tpupath": "PathIntegrator",
           "directlighting": "DirectLightingIntegrator", "whitted": "WhittedIntegrator",
           "ao": "AOIntegrator", "volpath": "VolPathIntegrator", "bdpt": "BDPTIntegrator",
           "sppm": "SPPMIntegrator", "mlt": "MLTIntegrator"}


@pytest.fixture
def registry(monkeypatch):
    """An empty registry for the test, restored after it."""
    monkeypatch.setattr(tint, "_REGISTRY", {})
    return tint._REGISTRY


@pytest.fixture(scope="module")
def cornell():
    return compile_api(make_cornell(res=8, spp=1, integrator="path", device="cpu"))[0]


class _Probe:
    def __init__(self, params, scene, options):
        self.params, self.scene, self.options = params, scene, options


@pytest.mark.parametrize("name", sorted(BUILTIN))
def test_builtin_names(name, cornell, registry):
    assert name in tint.PORTED and name in tint.available()
    integ = tint.make_integrator(name, cornell.integrator_params, cornell, None)
    assert type(integ).__name__ == BUILTIN[name]


def test_register_builds_the_class_by_name(cornell, registry):
    tint.register_integrator("probe", _Probe)
    assert "probe" in tint.available()
    integ = tint.make_integrator("probe", cornell.integrator_params, cornell, "opts")
    assert isinstance(integ, _Probe) and integ.scene is cornell and integ.options == "opts"
    tint.check_ported("probe")


def test_registered_name_overrides_builtin(cornell, registry, monkeypatch):
    """A registered name wins over the built-in of the same name, in both
    packages (the reference updates its built-ins with the registry)."""
    monkeypatch.setattr(rint, "_REGISTRY", {})
    tint.register_integrator("whitted", _Probe)
    rint.register_integrator("whitted", _Probe)
    got = tint.make_integrator("whitted", cornell.integrator_params, cornell, None)
    want = rint.make_integrator("whitted", cornell.integrator_params, cornell, None)
    assert isinstance(got, _Probe) and isinstance(want, _Probe)
    assert type(tint.make_integrator("path", cornell.integrator_params, cornell, None)
                ).__name__ == "PathIntegrator"


def test_unknown_name_raises_listing_available(cornell, registry, monkeypatch):
    monkeypatch.setattr(rint, "_REGISTRY", {})
    tint.register_integrator("probe", _Probe)
    rint.register_integrator("probe", _Probe)
    with pytest.raises(PbrtError) as got:
        tint.make_integrator("nosuch", cornell.integrator_params, cornell, None)
    with pytest.raises(RefPbrtError) as want:
        rint.make_integrator("nosuch", cornell.integrator_params, None, None)
    for msg in (str(got.value), str(want.value)):
        assert 'Integrator "nosuch" unknown or not implemented' in msg
        assert "'probe'" in msg and "'path'" in msg and "'sppm'" in msg
    assert str(tint.available()) in str(got.value)


def test_scene_file_selects_a_registered_integrator(registry):
    """`Integrator "name"` in a scene file compiles through the registry;
    an unknown name fails the compile with the listing."""
    text = ('Integrator "{}"\nSampler "random" "integer pixelsamples" [1]\n'
            'Film "image" "integer xresolution" [4] "integer yresolution" [4]\n'
            'Camera "perspective"\nWorldBegin\nLightSource "point" "rgb I" [1 1 1]\n'
            'Shape "sphere"\n')
    tint.register_integrator("probe", _Probe)
    scene, integ = compile_api(parse_string(text.format("probe"), device="cpu"))
    assert isinstance(integ, _Probe) and integ.scene is scene
    with pytest.raises(PbrtError, match="Available"):
        compile_api(parse_string(text.format("nosuch"), device="cpu"))
