"""tpu_pbrt_torch — the PyTorch/CUDA port of tpu_pbrt.

A second package beside the JAX reference (tpu_pbrt/, unchanged): it
parses .pbrt scenes, compiles them to flat tensors and renders them with
the wavefront integrators (path, directlighting, whitted, ao) on a CUDA
device, the stream tracer's two dense stages running as hand-written
Hopper kernels (kernels/, csrc/).
It imports torch and numpy only. Entry points run on CUDA unless the
caller passes device="cpu".

Layers: scene/ (front-end + compiler), accel/ (BVH build, treelets,
stream tracer), kernels/ + csrc/ (CUDA kernels and their plain
versions), core/ (sampling, film, BSDF, lights), cameras/, integrators/.
"""

__version__ = "0.1.0"

from tpu_pbrt_torch.scene.api import (  # noqa: F401
    parse_file,
    parse_string,
    pbrt_cleanup,
    pbrt_init,
    render_file,
)
from tpu_pbrt_torch.scene.compiler import compile_scene  # noqa: F401
