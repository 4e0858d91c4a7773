"""Material plugin factories.

Capability match for pbrt-v3 src/materials/ and api.cpp MakeMaterial: every
material type resolves its parameters (textures included) at directive time
against the then-active texture scope, producing a MaterialRecord whose
params dict holds texture nodes. The scene compiler lowers records into the
SoA material table (type enum + parameter/texture-id slots) consumed by the
wavefront shading kernel.

Parameter names and defaults follow the corresponding Create*Material
factories (e.g. matte: Kd=0.5, sigma=0; glass: Kr=1 Kt=1 eta=1.5; metal:
copper eta/k, roughness=0.01; uber/substrate/plastic/translucent/mix/
mirror/fourier/hair/disney/subsurface/kdsubsurface per upstream).
"""

from __future__ import annotations

import numpy as np

from tpu_pbrt_torch.core.spectrum import NAMED_SPECTRA_RGB
from tpu_pbrt_torch.scene.paramset import TextureParams
from tpu_pbrt_torch.utils.error import Warning


def make_material(name: str, tp: TextureParams, api=None, scene_dir: str = "."):
    from tpu_pbrt_torch.scene.api import MaterialRecord

    p = {}
    if name in ("", "none"):
        return MaterialRecord("none", {})
    if name == "matte":
        p["Kd"] = tp.get_spectrum_texture("Kd", 0.5)
        p["sigma"] = tp.get_float_texture("sigma", 0.0)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "plastic":
        p["Kd"] = tp.get_spectrum_texture("Kd", 0.25)
        p["Ks"] = tp.get_spectrum_texture("Ks", 0.25)
        p["roughness"] = tp.get_float_texture("roughness", 0.1)
        p["remaproughness"] = tp.find_one_bool("remaproughness", True)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "metal":
        p["eta"] = tp.get_spectrum_texture("eta", NAMED_SPECTRA_RGB["metal-cu-eta"])
        p["k"] = tp.get_spectrum_texture("k", NAMED_SPECTRA_RGB["metal-cu-k"])
        p["roughness"] = tp.get_float_texture("roughness", 0.01)
        p["uroughness"] = tp.get_float_texture_or_none("uroughness")
        p["vroughness"] = tp.get_float_texture_or_none("vroughness")
        p["remaproughness"] = tp.find_one_bool("remaproughness", True)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "glass":
        p["Kr"] = tp.get_spectrum_texture("Kr", 1.0)
        p["Kt"] = tp.get_spectrum_texture("Kt", 1.0)
        p["eta"] = tp.get_float_texture("eta", tp.find_one_float("index", 1.5))
        p["uroughness"] = tp.get_float_texture("uroughness", 0.0)
        p["vroughness"] = tp.get_float_texture("vroughness", 0.0)
        p["remaproughness"] = tp.find_one_bool("remaproughness", True)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "mirror":
        p["Kr"] = tp.get_spectrum_texture("Kr", 0.9)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "translucent":
        p["Kd"] = tp.get_spectrum_texture("Kd", 0.25)
        p["Ks"] = tp.get_spectrum_texture("Ks", 0.25)
        p["reflect"] = tp.get_spectrum_texture("reflect", 0.5)
        p["transmit"] = tp.get_spectrum_texture("transmit", 0.5)
        p["roughness"] = tp.get_float_texture("roughness", 0.1)
        p["remaproughness"] = tp.find_one_bool("remaproughness", True)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "uber":
        p["Kd"] = tp.get_spectrum_texture("Kd", 0.25)
        p["Ks"] = tp.get_spectrum_texture("Ks", 0.25)
        p["Kr"] = tp.get_spectrum_texture("Kr", 0.0)
        p["Kt"] = tp.get_spectrum_texture("Kt", 0.0)
        p["roughness"] = tp.get_float_texture("roughness", 0.1)
        p["uroughness"] = tp.get_float_texture_or_none("uroughness")
        p["vroughness"] = tp.get_float_texture_or_none("vroughness")
        p["eta"] = tp.get_float_texture("eta", tp.find_one_float("index", 1.5))
        p["opacity"] = tp.get_spectrum_texture("opacity", 1.0)
        p["remaproughness"] = tp.find_one_bool("remaproughness", True)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "substrate":
        p["Kd"] = tp.get_spectrum_texture("Kd", 0.5)
        p["Ks"] = tp.get_spectrum_texture("Ks", 0.5)
        p["uroughness"] = tp.get_float_texture("uroughness", 0.1)
        p["vroughness"] = tp.get_float_texture("vroughness", 0.1)
        p["remaproughness"] = tp.find_one_bool("remaproughness", True)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "mix":
        p["amount"] = tp.get_spectrum_texture("amount", 0.5)
        m1 = tp.find_one_string("namedmaterial1", "")
        m2 = tp.find_one_string("namedmaterial2", "")
        named = api.graphics_state.named_materials if api is not None else {}
        if m1 not in named or m2 not in named:
            Warning(f'Named material(s) "{m1}"/"{m2}" for mix material not found; using matte')
            return make_material("matte", tp, api, scene_dir)
        p["material1"] = named[m1]
        p["material2"] = named[m2]
    elif name == "fourier":
        p["bsdffile"] = tp.find_one_string("bsdffile", "")
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "hair":
        p["sigma_a"] = tp.get_spectrum_texture_or_none("sigma_a")
        p["color"] = tp.get_spectrum_texture_or_none("color")
        p["eumelanin"] = tp.get_float_texture_or_none("eumelanin")
        p["pheomelanin"] = tp.get_float_texture_or_none("pheomelanin")
        p["eta"] = tp.get_float_texture("eta", 1.55)
        p["beta_m"] = tp.get_float_texture("beta_m", 0.3)
        p["beta_n"] = tp.get_float_texture("beta_n", 0.3)
        p["alpha"] = tp.get_float_texture("alpha", 2.0)
    elif name == "disney":
        p["color"] = tp.get_spectrum_texture("color", 0.5)
        for fname, dflt in [
            ("metallic", 0.0), ("eta", 1.5), ("roughness", 0.5), ("speculartint", 0.0),
            ("anisotropic", 0.0), ("sheen", 0.0), ("sheentint", 0.5), ("clearcoat", 0.0),
            ("clearcoatgloss", 1.0), ("spectrans", 0.0), ("flatness", 0.0), ("difftrans", 1.0),
        ]:
            p[fname] = tp.get_float_texture(fname, dflt)
        p["scatterdistance"] = tp.get_spectrum_texture("scatterdistance", 0.0)
        p["thin"] = tp.find_one_bool("thin", False)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name in ("subsurface", "kdsubsurface"):
        if name == "subsurface":
            p["preset"] = tp.find_one_string("name", "")
            p["sigma_a"] = tp.get_spectrum_texture("sigma_a", np.array([0.0011, 0.0024, 0.014]))
            p["sigma_s"] = tp.get_spectrum_texture("sigma_prime_s", np.array([2.55, 3.21, 3.77]))
            p["scale"] = tp.find_one_float("scale", 1.0)
            p["g"] = tp.find_one_float("g", 0.0)
        else:
            p["Kd"] = tp.get_spectrum_texture("Kd", 0.5)
            p["mfp"] = tp.get_spectrum_texture("mfp", 1.0)
        p["eta"] = tp.get_float_texture("eta", 1.33)
        p["Kr"] = tp.get_spectrum_texture("Kr", 1.0)
        p["Kt"] = tp.get_spectrum_texture("Kt", 1.0)
        p["uroughness"] = tp.get_float_texture("uroughness", 0.0)
        p["vroughness"] = tp.get_float_texture("vroughness", 0.0)
        p["remaproughness"] = tp.find_one_bool("remaproughness", True)
        p["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    else:
        Warning(f'Material "{name}" unknown. Using "matte".')
        return make_material("matte", tp, api, scene_dir)
    from tpu_pbrt_torch.scene.api import MaterialRecord as MR

    return MR(name, p)
