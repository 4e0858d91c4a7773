"""The port stands alone: it imports neither JAX nor the JAX package.

- A fresh interpreter imports every module of tpu_pbrt_torch and renders
  tiny scenes on the CPU (`path`, and `directlighting`, `whitted` and
  `ao` under the sobol, halton and stratified samplers, and `volpath`
  through a homogeneous and a grid medium in a null-material cube, which
  runs core/media.py and integrators/volpath.py); afterwards no `jax*`
  and no `tpu_pbrt.` module may be loaded.
- A scan of the port's sources finds no import that names either; the
  media modules are named one by one, and the host modules the port
  keeps as copies of the reference's (`COPIES`) are its code line for
  line.
- With no GPU, the entry points' default device (CUDA) raises instead of
  falling back to the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import tpu_pbrt_torch
from tpu_pbrt_torch.config import resolve_device

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(tpu_pbrt_torch.__file__))

_CHILD = r'''
import importlib, pkgutil, sys
import tpu_pbrt_torch
for m in pkgutil.walk_packages(tpu_pbrt_torch.__path__, "tpu_pbrt_torch."):
    importlib.import_module(m.name)
from tpu_pbrt_torch import parse_string
api = parse_string("""
Integrator "path" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [1]
Film "image" "integer xresolution" [4] "integer yresolution" [4]
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [1 1 1] "point from" [0 0 -2]
Material "matte"
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
WorldEnd
""", render=True, device="cpu")
assert api.result.image.shape == (4, 4, 3) and api.result.image.max() > 0
from tpu_pbrt_torch import scenes
for integ, sampler in (("directlighting", "sobol"), ("whitted", "halton"), ("ao", "stratified")):
    scene, ig = scenes.compile_api(scenes.make_cornell(res=4, spp=2, integrator=integ,
                                                       sampler=sampler, device="cpu"))
    assert ig.render(scene).image.max() > 0
for medium in ('"string type" "homogeneous" "rgb sigma_a" [0.1 0.1 0.1] "rgb sigma_s" [1 1 1]',
               '"string type" "heterogeneous" "integer nx" [2] "integer ny" [2] "integer nz" [2] '
               '"float density" [1 0.5 1 0.5 1 0.5 1 0.5] '
               '"point p0" [-1 -1 -1] "point p1" [1 1 1]'):
    api = parse_string(f"""
Integrator "volpath" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [2]
Film "image" "integer xresolution" [4] "integer yresolution" [4]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
MakeNamedMedium "m" {medium}
LightSource "point" "rgb I" [20 20 20] "point from" [0 3 0]
AttributeBegin
Material "none"
MediumInterface "m" ""
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3  4 6 5 4 7 6  0 4 1 1 4 5  2 6 3 3 6 7  1 5 2 2 5 6  0 3 7 0 7 4]
  "point P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1  -1 1 -1  1 1 -1  1 1 1  -1 1 1]
AttributeEnd
WorldEnd
""", render=True, device="cpu")
    assert api.result.image.max() > 0
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "tpu_pbrt.")) or n == "tpu_pbrt")
print("FOREIGN", bad)
'''


def test_port_imports_and_renders_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout[-2000:]


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_source_names_jax_or_the_reference():
    seen = 0
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            seen += 1
            for name in _imported_names(os.path.join(dirpath, fn)):
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "tpu_pbrt"), f"{fn} imports {name}"
    assert seen > 20


@pytest.mark.parametrize("module", ["core/media.py", "integrators/volpath.py", "accel/packet.py",
                                    "accel/traverse.py", "accel/wide.py",
                                    "analysis/hbmcheck.py"])
def test_media_modules_name_neither_jax_nor_the_reference(module):
    names = list(_imported_names(os.path.join(PKG, module)))
    assert "torch" in names
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "tpu_pbrt"), f"{module} imports {name}"


#: host modules the port keeps as its own copies of the reference's (the
#: copy's import of the port's error helpers is the one line that differs)
COPIES = ["scene/plyreader.py", "shapes/loopsubdiv.py"]
#: host modules the port keeps as copies of the reference's code: the same
#: statements, the port's package named where the reference names its own;
#: their docstrings and comments drop the reference's change history
CODE_COPIES = ["utils/clock.py", "obs/trace.py", "obs/flight.py", "obs/metrics.py",
               "chaos/__init__.py", "serve/queue.py", "obs/health.py", "obs/__main__.py",
               "fleet/router.py", "load/workload.py", "load/gates.py", "load/__main__.py",
               "load/__init__.py", "load/replay.py"]
#: the port's own additions to a code copy, taken out before the
#: comparison: LocalReplica takes the service's device (CUDA unless the
#: caller names the CPU), which the reference's single-backend service
#: does not need; the load replay builds its services on the CPU, where
#: the stub films live
PORT_ADDITIONS = {"fleet/router.py": ["        device=None,\n", "device=device, "],
                  "load/replay.py": ['device="cpu",']}


def _code(src: str) -> str:
    """The module's statements without docstrings or comments."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIES + CODE_COPIES)
def test_host_copies_match_the_reference_and_import_neither(module):
    names = list(_imported_names(os.path.join(PKG, module)))
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "tpu_pbrt"), f"{module} imports {name}"
    with open(os.path.join(PKG, module)) as f:
        ours = f.read().replace("tpu_pbrt_torch.", "tpu_pbrt.")
    for added in PORT_ADDITIONS.get(module, []):
        assert added in ours, f"{module}: the port's addition {added!r} moved"
        ours = ours.replace(added, "")
    with open(os.path.join(ROOT, "tpu_pbrt", module)) as f:
        theirs = f.read()
    if module in CODE_COPIES:
        assert _code(ours) == _code(theirs), f"{module} is no longer the reference's code"
    else:
        assert ours == theirs, f"{module} is no longer the reference's code"


#: functions the port keeps as copies of the reference's, statement for
#: statement: module -> (the reference's module, function names)
FUNCTION_COPIES = {
    "analysis/protocheck.py": ("analysis/protocheck.py", ("_pragma_lines", "_shallow_walk")),
}


def _function_code(path, names):
    with open(path) as f:
        tree = ast.parse(f.read())
    found = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names}
    assert set(found) == set(names), f"{path}: {set(names) - set(found)} missing"
    out = {}
    for name, node in found.items():
        node.body = node.body[1:] if (node.body and isinstance(node.body[0], ast.Expr)
                                      and isinstance(node.body[0].value, ast.Constant)) else node.body
        node.returns = None
        for a in node.args.args:
            a.annotation = None
        out[name] = ast.dump(node)
    return out


@pytest.mark.parametrize("module", sorted(FUNCTION_COPIES))
def test_function_copies_match_the_reference(module):
    """hbmcheck's helpers taken from protocheck are the reference's code,
    statement for statement (the port's pragma regexes under the
    reference's names)."""
    ref_module, names = FUNCTION_COPIES[module]
    ours = _function_code(os.path.join(PKG, module), names)
    theirs = _function_code(os.path.join(ROOT, "tpu_pbrt", ref_module), names)
    for name in names:
        assert ours[name] == theirs[name], f"{module}::{name} is no longer the reference's code"


def test_default_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpu_pbrt_torch.parse_string("", device=None)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_names_neither_jax_nor_the_reference():
    """The GPU smoke script drives the port alone: no import of jax, jaxlib
    or the JAX package anywhere in it (function-level imports included)."""
    names = list(_imported_names(os.path.join(ROOT, "chip_smoke.py")))
    assert "torch" in names and any(n.startswith("tpu_pbrt_torch") for n in names)
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "tpu_pbrt"), \
            f"chip_smoke.py imports {name}"
