"""The pbrt scene-description API state machine.

Capability match for pbrt-v3 src/core/api.{h,cpp}: pbrtInit/pbrtCleanup,
the CTM stack (Translate/Rotate/.../LookAt/CoordinateSystem), attribute and
transform stacks, object instancing, named materials/media, texture
registration, and the Make* plugin-factory seam (string-dispatched plugin
registries) through which the `tpupath` integrator is selected by unmodified
.pbrt scene files.

Port note: a copy of tpu_pbrt/scene/api.py whose WorldEnd compiles and
renders with this package (scene/compiler.py, integrators/), and
whose entry points take a `device` ("cuda" unless the caller passes
"cpu"; see config.resolve_device).

State-machine rules (matching pbrt's APISTATE checks): directives are only
legal in the Options block (before WorldBegin) or the World block, and this
is enforced with pbrt's error messages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from tpu_pbrt_torch.core import transform as xf
from tpu_pbrt_torch.core.transform import Transform
from tpu_pbrt_torch.scene.paramset import ParamSet, TextureParams
from tpu_pbrt_torch.utils.error import Error, Warning, set_quiet

# -- active-transform bits (pbrt api.cpp) ---------------------------------
MAX_TRANSFORMS = 2
START_TRANSFORM_BITS = 1 << 0
END_TRANSFORM_BITS = 1 << 1
ALL_TRANSFORMS_BITS = (1 << MAX_TRANSFORMS) - 1

_STATE_UNINIT, _STATE_OPTIONS, _STATE_WORLD = 0, 1, 2


class TransformSet:
    """Pair of CTMs (start/end time) for animated transforms."""

    __slots__ = ("t",)

    def __init__(self, t=None):
        self.t = t if t is not None else [Transform(), Transform()]

    def copy(self):
        return TransformSet([Transform(x.m, x.m_inv) for x in self.t])

    def __getitem__(self, i):
        return self.t[i]

    def __setitem__(self, i, v):
        self.t[i] = v

    def is_animated(self):
        return not np.allclose(self.t[0].m, self.t[1].m)

    def inverse(self):
        return TransformSet([x.inverse() for x in self.t])


@dataclass
class MaterialRecord:
    """A material captured at directive time with textures resolved
    against the then-active texture scope (pbrt MakeMaterial)."""

    type: str
    params: Dict[str, Any] = field(default_factory=dict)
    name: str = ""  # for named materials


@dataclass
class ShapeRecord:
    type: str
    params: ParamSet
    object_to_world: TransformSet
    reverse_orientation: bool
    material: Optional[MaterialRecord]
    area_light: Optional[ParamSet]
    area_light_to_world: Optional[Transform]
    inside_medium: str
    outside_medium: str
    scene_dir: str
    area_light_name: str = ""  # AreaLightSource type of area_light


@dataclass
class LightRecord:
    type: str
    params: ParamSet
    light_to_world: Transform
    medium: str
    scene_dir: str


@dataclass
class InstanceUse:
    name: str
    instance_to_world: TransformSet


@dataclass
class MediumRecord:
    type: str
    params: ParamSet
    medium_to_world: Transform


@dataclass
class GraphicsState:
    float_textures: Dict[str, Any] = field(default_factory=dict)
    spectrum_textures: Dict[str, Any] = field(default_factory=dict)
    named_materials: Dict[str, MaterialRecord] = field(default_factory=dict)
    current_material: MaterialRecord = field(
        default_factory=lambda: MaterialRecord("matte", {"Kd": ("const", np.array([0.5, 0.5, 0.5]))})
    )
    area_light: Optional[ParamSet] = None
    area_light_name: str = ""
    reverse_orientation: bool = False
    current_inside_medium: str = ""
    current_outside_medium: str = ""

    def copy(self):
        g = GraphicsState(
            float_textures=dict(self.float_textures),
            spectrum_textures=dict(self.spectrum_textures),
            named_materials=dict(self.named_materials),
            current_material=self.current_material,
            area_light=self.area_light,
            area_light_name=self.area_light_name,
            reverse_orientation=self.reverse_orientation,
            current_inside_medium=self.current_inside_medium,
            current_outside_medium=self.current_outside_medium,
        )
        return g


@dataclass
class RenderOptions:
    """Everything accumulated before/within the world block
    (pbrt api.cpp RenderOptions)."""

    transform_start_time: float = 0.0
    transform_end_time: float = 1.0
    filter_name: str = "box"
    filter_params: ParamSet = field(default_factory=ParamSet)
    film_name: str = "image"
    film_params: ParamSet = field(default_factory=ParamSet)
    sampler_name: str = "halton"
    sampler_params: ParamSet = field(default_factory=ParamSet)
    accelerator_name: str = "bvh"
    accelerator_params: ParamSet = field(default_factory=ParamSet)
    integrator_name: str = "path"
    integrator_params: ParamSet = field(default_factory=ParamSet)
    camera_name: str = "perspective"
    camera_params: ParamSet = field(default_factory=ParamSet)
    camera_to_world: TransformSet = field(default_factory=TransformSet)
    named_media: Dict[str, MediumRecord] = field(default_factory=dict)
    camera_medium: str = ""
    shapes: List[ShapeRecord] = field(default_factory=list)
    lights: List[LightRecord] = field(default_factory=list)
    instances: Dict[str, List[ShapeRecord]] = field(default_factory=dict)
    instance_uses: List[InstanceUse] = field(default_factory=list)
    have_scattering_media: bool = False


@dataclass
class Options:
    """CLI options (pbrt core/pbrt.h Options struct)."""

    n_threads: int = 0
    quick_render: bool = False
    quiet: bool = False
    verbose: bool = False
    image_file: str = ""
    crop_window: Optional[tuple] = None  # (x0,x1,y0,y1)
    mesh_shape: Optional[tuple] = None  # ranks of the render mesh (parallel/mesh.py)
    spp_chunk: int = 0  # TPU-specific: samples per chunk (0 = auto)
    checkpoint_path: str = ""  # TPU-specific: film checkpoint for resume
    checkpoint_every: int = 0  # chunks between checkpoint writes (0 = off)
    multihost: bool = False  # join a process group from the environment


class PbrtAPI:
    """The directive state machine. One instance per parse
    (pbrt uses globals; we keep it instantiable for tests)."""

    def __init__(self, options: Optional[Options] = None, device=None):
        from tpu_pbrt_torch.config import resolve_device

        self.options = options or Options()
        #: torch device every compile/render of this API's scenes uses
        self.device = resolve_device(device)
        self.state = _STATE_UNINIT
        self.cur_transform = TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems: Dict[str, TransformSet] = {}
        self.render_options = RenderOptions()
        self.graphics_state = GraphicsState()
        self.pushed_graphics_states: List[GraphicsState] = []
        self.pushed_transforms: List[TransformSet] = []
        self.pushed_active_transform_bits: List[int] = []
        self.current_instance: Optional[List[ShapeRecord]] = None
        self.scene_dir = "."
        self.scene: Any = None  # set by world_end
        #: submit/step seam (tpu_pbrt/serve): when True, WorldEnd compiles
        #: the scene and builds the integrator but does NOT run the
        #: render-to-completion loop — the pair lands in `self.compiled`
        #: for a scheduler (the render service) to drive chunk by chunk
        self.defer_render = False
        self.compiled: Any = None  # (CompiledScene, integrator) when deferred

    # -- state checks -----------------------------------------------------
    def _verify_initialized(self, func):
        if self.state == _STATE_UNINIT:
            Error(f"pbrtInit() must be before calling \"{func}()\". Ignoring.")

    def _verify_options(self, func):
        self._verify_initialized(func)
        if self.state == _STATE_WORLD:
            Error(f"Options cannot be set inside world block; \"{func}\" not allowed. Ignoring.")

    def _verify_world(self, func):
        self._verify_initialized(func)
        if self.state == _STATE_OPTIONS:
            Error(f"Scene description must be inside world block; \"{func}\" not allowed. Ignoring.")

    def _for_active_transforms(self, fn: Callable[[Transform], Transform]):
        for i in range(MAX_TRANSFORMS):
            if self.active_transform_bits & (1 << i):
                self.cur_transform[i] = fn(self.cur_transform[i])

    # -- init/cleanup -----------------------------------------------------
    def init(self):
        if self.state != _STATE_UNINIT:
            Error("pbrtInit() has already been called.")
        self.state = _STATE_OPTIONS
        set_quiet(self.options.quiet)

    def cleanup(self):
        if self.state == _STATE_UNINIT:
            Error("pbrtCleanup() called without pbrtInit().")
        elif self.state == _STATE_WORLD:
            Error("pbrtCleanup() called while inside world block.")
        self.state = _STATE_UNINIT

    # -- transforms -------------------------------------------------------
    def identity(self):
        self._verify_initialized("Identity")
        self._for_active_transforms(lambda t: Transform())

    def translate(self, dx, dy, dz):
        self._verify_initialized("Translate")
        self._for_active_transforms(lambda t: t * xf.translate([dx, dy, dz]))

    def rotate(self, angle, ax, ay, az):
        self._verify_initialized("Rotate")
        self._for_active_transforms(lambda t: t * xf.rotate(angle, [ax, ay, az]))

    def scale(self, sx, sy, sz):
        self._verify_initialized("Scale")
        self._for_active_transforms(lambda t: t * xf.scale(sx, sy, sz))

    def look_at(self, ex, ey, ez, lx, ly, lz, ux, uy, uz):
        self._verify_initialized("LookAt")
        # LookAt gives camera-to-world; CTM becomes world-to-camera
        self._for_active_transforms(lambda t: t * xf.look_at([ex, ey, ez], [lx, ly, lz], [ux, uy, uz]).inverse())

    def concat_transform(self, m16):
        self._verify_initialized("ConcatTransform")
        m = np.asarray(m16, dtype=np.float64).reshape(4, 4).T  # column-major in file
        self._for_active_transforms(lambda t: t * Transform(m))

    def transform(self, m16):
        self._verify_initialized("Transform")
        m = np.asarray(m16, dtype=np.float64).reshape(4, 4).T
        self._for_active_transforms(lambda t: Transform(m))

    def coordinate_system(self, name):
        self._verify_initialized("CoordinateSystem")
        self.named_coordinate_systems[name] = self.cur_transform.copy()

    def coord_sys_transform(self, name):
        self._verify_initialized("CoordSysTransform")
        if name in self.named_coordinate_systems:
            self.cur_transform = self.named_coordinate_systems[name].copy()
        else:
            Warning(f'Couldn\'t find named coordinate system "{name}"')

    def active_transform_all(self):
        self.active_transform_bits = ALL_TRANSFORMS_BITS

    def active_transform_start(self):
        self.active_transform_bits = START_TRANSFORM_BITS

    def active_transform_end(self):
        self.active_transform_bits = END_TRANSFORM_BITS

    def transform_times(self, start, end):
        self._verify_options("TransformTimes")
        self.render_options.transform_start_time = start
        self.render_options.transform_end_time = end

    # -- options ----------------------------------------------------------
    def pixel_filter(self, name, params):
        self._verify_options("PixelFilter")
        self.render_options.filter_name = name
        self.render_options.filter_params = params

    def film(self, name, params):
        self._verify_options("Film")
        self.render_options.film_name = name
        self.render_options.film_params = params

    def sampler(self, name, params):
        self._verify_options("Sampler")
        self.render_options.sampler_name = name
        self.render_options.sampler_params = params

    def accelerator(self, name, params):
        self._verify_options("Accelerator")
        self.render_options.accelerator_name = name
        self.render_options.accelerator_params = params

    def integrator(self, name, params):
        self._verify_options("Integrator")
        self.render_options.integrator_name = name
        self.render_options.integrator_params = params

    def camera(self, name, params):
        self._verify_options("Camera")
        self.render_options.camera_name = name
        self.render_options.camera_params = params
        self.render_options.camera_to_world = self.cur_transform.inverse()
        self.named_coordinate_systems["camera"] = self.render_options.camera_to_world.copy()
        self.render_options.camera_medium = self.graphics_state.current_outside_medium

    def make_named_medium(self, name, params):
        self._verify_initialized("MakeNamedMedium")
        mtype = params.find_one_string("type", "")
        if not mtype:
            Error('No parameter string "type" found in MakeNamedMedium')
        self.render_options.named_media[name] = MediumRecord(mtype, params, self.cur_transform[0])
        self.render_options.have_scattering_media = True

    def medium_interface(self, inside, outside):
        self._verify_initialized("MediumInterface")
        self.graphics_state.current_inside_medium = inside
        self.graphics_state.current_outside_medium = outside
        self.render_options.have_scattering_media = True

    # -- world block ------------------------------------------------------
    def world_begin(self):
        self._verify_options("WorldBegin")
        self.state = _STATE_WORLD
        self.cur_transform = TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems["world"] = self.cur_transform.copy()

    def attribute_begin(self):
        self._verify_world("AttributeBegin")
        self.pushed_graphics_states.append(self.graphics_state.copy())
        self.pushed_transforms.append(self.cur_transform.copy())
        self.pushed_active_transform_bits.append(self.active_transform_bits)

    def attribute_end(self):
        self._verify_world("AttributeEnd")
        if not self.pushed_graphics_states:
            Error("Unmatched AttributeEnd encountered.")
        self.graphics_state = self.pushed_graphics_states.pop()
        self.cur_transform = self.pushed_transforms.pop()
        self.active_transform_bits = self.pushed_active_transform_bits.pop()

    def transform_begin(self):
        self._verify_world("TransformBegin")
        self.pushed_transforms.append(self.cur_transform.copy())
        self.pushed_active_transform_bits.append(self.active_transform_bits)

    def transform_end(self):
        self._verify_world("TransformEnd")
        if not self.pushed_transforms:
            Error("Unmatched TransformEnd encountered.")
        self.cur_transform = self.pushed_transforms.pop()
        self.active_transform_bits = self.pushed_active_transform_bits.pop()

    def texture(self, name, type_name, tex_name, params):
        self._verify_world("Texture")
        from tpu_pbrt_torch.scene import textures as tex_mod

        tp = TextureParams(params, ParamSet(), self.graphics_state.float_textures, self.graphics_state.spectrum_textures)
        if type_name == "float":
            if name in self.graphics_state.float_textures:
                Warning(f'Texture "{name}" being redefined')
            t = tex_mod.make_float_texture(tex_name, self.cur_transform[0], tp, self.scene_dir)
            if t is not None:
                self.graphics_state.float_textures[name] = t
        elif type_name in ("color", "spectrum"):
            if name in self.graphics_state.spectrum_textures:
                Warning(f'Texture "{name}" being redefined')
            t = tex_mod.make_spectrum_texture(tex_name, self.cur_transform[0], tp, self.scene_dir)
            if t is not None:
                self.graphics_state.spectrum_textures[name] = t
        else:
            Error(f'Texture type "{type_name}" unknown.')

    def material(self, name, params):
        self._verify_world("Material")
        from tpu_pbrt_torch.scene import materials as mat_mod

        tp = TextureParams(ParamSet(), params, self.graphics_state.float_textures, self.graphics_state.spectrum_textures)
        self.graphics_state.current_material = mat_mod.make_material(name, tp, self, self.scene_dir)

    def make_named_material(self, name, params):
        self._verify_world("MakeNamedMaterial")
        from tpu_pbrt_torch.scene import materials as mat_mod

        mat_type = params.find_one_string("type", "")
        if not mat_type:
            Error('No parameter string "type" found in MakeNamedMaterial')
        tp = TextureParams(ParamSet(), params, self.graphics_state.float_textures, self.graphics_state.spectrum_textures)
        if name in self.graphics_state.named_materials:
            Warning(f'Named material "{name}" redefined.')
        rec = mat_mod.make_material(mat_type, tp, self, self.scene_dir)
        rec.name = name
        self.graphics_state.named_materials[name] = rec

    def named_material(self, name):
        self._verify_world("NamedMaterial")
        if name not in self.graphics_state.named_materials:
            Error(f'NamedMaterial "{name}" unknown.')
        self.graphics_state.current_material = self.graphics_state.named_materials[name]

    def light_source(self, name, params):
        self._verify_world("LightSource")
        self.render_options.lights.append(
            LightRecord(name, params, self.cur_transform[0], self.graphics_state.current_outside_medium, self.scene_dir)
        )

    def area_light_source(self, name, params):
        self._verify_world("AreaLightSource")
        self.graphics_state.area_light = params
        self.graphics_state.area_light_name = name

    def shape(self, name, params):
        self._verify_world("Shape")
        rec = ShapeRecord(
            type=name,
            params=params,
            object_to_world=self.cur_transform.copy(),
            reverse_orientation=self.graphics_state.reverse_orientation,
            material=self.graphics_state.current_material,
            area_light=self.graphics_state.area_light,
            area_light_to_world=self.cur_transform[0] if self.graphics_state.area_light is not None else None,
            inside_medium=self.graphics_state.current_inside_medium,
            outside_medium=self.graphics_state.current_outside_medium,
            scene_dir=self.scene_dir,
            area_light_name=self.graphics_state.area_light_name,
        )
        if self.current_instance is not None:
            if self.graphics_state.area_light is not None:
                Warning("Area lights not supported with object instancing; ignoring.")
                rec.area_light = None
            self.current_instance.append(rec)
        else:
            self.render_options.shapes.append(rec)

    def reverse_orientation(self):
        self._verify_world("ReverseOrientation")
        self.graphics_state.reverse_orientation = not self.graphics_state.reverse_orientation

    def object_begin(self, name):
        self._verify_world("ObjectBegin")
        self.attribute_begin()
        if self.current_instance is not None:
            Error("ObjectBegin called inside of instance definition")
        self.render_options.instances[name] = []
        self.current_instance = self.render_options.instances[name]

    def object_end(self):
        self._verify_world("ObjectEnd")
        if self.current_instance is None:
            Error("ObjectEnd called outside of instance definition")
        self.current_instance = None
        self.attribute_end()

    def object_instance(self, name):
        self._verify_world("ObjectInstance")
        if self.current_instance is not None:
            Error("ObjectInstance can't be called inside instance definition")
        if name not in self.render_options.instances:
            Error(f'Unable to find instance named "{name}"')
        self.render_options.instance_uses.append(InstanceUse(name, self.cur_transform.copy()))

    def world_end(self, render: bool = True):
        self._verify_world("WorldEnd")
        while self.pushed_graphics_states:
            Warning("Missing end to AttributeBegin")
            self.pushed_graphics_states.pop()
            self.pushed_transforms.pop()
            self.pushed_active_transform_bits.pop()
        while self.pushed_transforms:
            Warning("Missing end to TransformBegin")
            self.pushed_transforms.pop()
            self.pushed_active_transform_bits.pop()
        self.state = _STATE_OPTIONS
        result = None
        if render:
            from tpu_pbrt_torch.scene.compiler import compile_scene
            from tpu_pbrt_torch.integrators import make_integrator

            self.scene = compile_scene(self, device=self.device)
            integrator = make_integrator(self.render_options.integrator_name,
                                         self.render_options.integrator_params, self.scene, self.options)
            if self.defer_render:
                # serve seam: hand the compiled pair to the caller's
                # scheduler instead of running to completion here
                self.compiled = result = (self.scene, integrator)
            else:
                self.result = result = integrator.render(self.scene)
        # reset world state for a possible next frame (pbrt api.cpp WorldEnd:
        # fresh RenderOptions, identity CTM, default graphics state); the
        # completed frame stays inspectable via last_render_options
        prev = self.last_render_options = self.render_options
        self.render_options = RenderOptions(
            transform_start_time=prev.transform_start_time,
            transform_end_time=prev.transform_end_time,
        )
        self.graphics_state = GraphicsState()
        self.cur_transform = TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems.clear()
        return result


# -- module-level convenience entry points --------------------------------

def pbrt_init(options: Optional[Options] = None, device=None) -> PbrtAPI:
    api = PbrtAPI(options, device=device)
    api.init()
    return api


def pbrt_cleanup(api: PbrtAPI):
    api.cleanup()


def parse_string(contents: str, api: Optional[PbrtAPI] = None, render: bool = False,
                 device=None) -> PbrtAPI:
    from tpu_pbrt_torch.scene.parser import parse_tokens
    from tpu_pbrt_torch.scene.lexer import Tokenizer

    if api is None:
        api = pbrt_init(device=device)
    parse_tokens(Tokenizer(contents), api, render=render)
    return api


def parse_file(path: str, api: Optional[PbrtAPI] = None, render: bool = False,
               device=None) -> PbrtAPI:
    from tpu_pbrt_torch.scene.parser import parse_tokens
    from tpu_pbrt_torch.scene.lexer import Tokenizer

    if api is None:
        api = pbrt_init(device=device)
    api.scene_dir = os.path.dirname(os.path.abspath(path))
    parse_tokens(Tokenizer.from_file(path), api, render=render)
    return api


def render_file(path: str, options: Optional[Options] = None, device=None):
    """pbrt main(): parse + render, returns the integrator result."""
    api = pbrt_init(options, device=device)
    parse_file(path, api, render=True)
    return getattr(api, "result", None)


def compile_file(path: str, options: Optional[Options] = None, device=None):
    """Parse + compile a .pbrt scene file WITHOUT rendering it: returns
    (CompiledScene, integrator) — the resident-scene unit the render
    service caches and schedules (submit/step instead of
    run-to-completion)."""
    api = pbrt_init(options, device=device)
    api.defer_render = True
    parse_file(path, api, render=True)
    if api.compiled is None:
        from tpu_pbrt_torch.utils.error import Error

        Error(f"scene file {path!r} has no WorldEnd; nothing to compile")
    return api.compiled


def compile_string(contents: str, options: Optional[Options] = None, device=None):
    """compile_file for in-memory scene text (the JSONL daemon's inline
    submit payload)."""
    api = pbrt_init(options, device=device)
    api.defer_render = True
    parse_string(contents, api, render=True)
    if api.compiled is None:
        from tpu_pbrt_torch.utils.error import Error

        Error("scene text has no WorldEnd; nothing to compile")
    return api.compiled
