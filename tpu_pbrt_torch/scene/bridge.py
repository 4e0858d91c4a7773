"""Scene tables between numpy and the port's device tables.

`upload` turns the compiler's numpy tables into the tensors the renderer
reads. `tables_from_numpy` does the same for the JAX package's compiled
scene tables (`CompiledScene.dev` after the caller has converted every
leaf to numpy): it picks the tables this package reads and returns them
in the port's layout, so a test can drive the port on exactly the
reference's tables — the counterpart of carrying a model's weights
across. This module imports neither framework of the reference; the
caller does the conversion to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pbrt_torch.accel.treelet import TreeletPack, pack_from_numpy
from tpu_pbrt_torch.core.bxdf import DISNEY_COLUMNS, HAIR_COLUMNS, MAT_COLUMNS, MIX_COLUMNS
from tpu_pbrt_torch.core.media import MediumTable
from tpu_pbrt_torch.core.sampling import Distribution2D

#: per-light columns the port reads (per material: bxdf.MAT_COLUMNS, and
#: bxdf.MIX_COLUMNS, DISNEY_COLUMNS, HAIR_COLUMNS where a scene has a mix,
#: a disney or a hair material)
LIGHT_KEYS = ("type", "p", "L", "dir", "cos0", "cos1", "tri", "twosided", "area", "w2l", "img",
              "tri_v")
#: top-level tables the port reads (when present)
DEV_KEYS = (
    "tri_verts", "tri_normals", "tri_uvs", "tri_mat", "tri_light",
    "world_center", "world_radius", "n_lights", "tri_sh16", "tri_verts9T",
    "envmap", "env_w2l", "tri_med_in", "tri_med_out", "light_atlas", "tri_difT", "tex_atlas",
    "tri_verts1", "tri_verts1_9T", "tri_tanT",
)


def _tensor(a, device):
    return torch.from_numpy(np.array(a, order="C")).to(device)


def upload(tab: dict, device) -> dict:
    """Numpy tables (as compile_scene builds them) -> device tables:
    arrays become tensors, "tstream" becomes a TreeletPack, "env_distr"
    (its six tables in field order) a Distribution2D, "media" (its eight
    fields in order) a MediumTable, nested dicts recurse."""
    out = {}
    for k, v in tab.items():
        if k == "tstream":
            out[k] = pack_from_numpy(v, device)
        elif k == "env_distr":
            out[k] = Distribution2D(*(_tensor(a, device) for a in v))
        elif k == "media":
            out[k] = MediumTable(*(_tensor(a, device) for a in v))
        elif isinstance(v, dict):
            out[k] = upload(v, device)
        else:
            out[k] = _tensor(v, device)
    return out


def pack_tables(tp) -> dict:
    """The reference's TreeletPack (numpy leaves) -> the table dict that
    treelet.pack_from_numpy uploads."""
    return {
        "top_bmin": tp.top.child_bmin,
        "top_bmax": tp.top.child_bmax,
        "top_idx": tp.top.child_idx,
        "featT": tp.featT,
        "center": tp.center,
        "offset": tp.offset,
        "count": tp.count,
    }


def treelet_pack_from_numpy(tp, device) -> TreeletPack:
    """The reference's TreeletPack (numpy leaves) -> the port's TreeletPack."""
    return pack_from_numpy(pack_tables(tp), device)


def tables_from_numpy(dev_np: dict, device) -> dict:
    """The JAX package's compiled tables (numpy leaves) -> the port's
    device tables, holding exactly the keys compile_scene produces."""
    tab = {k: dev_np[k] for k in DEV_KEYS if k in dev_np}
    tab["mat"] = {k: dev_np["mat"][k]
                  for k in MAT_COLUMNS + MIX_COLUMNS + DISNEY_COLUMNS + HAIR_COLUMNS
                  if k in dev_np["mat"]}
    tab["light"] = {k: dev_np["light"][k] for k in LIGHT_KEYS}
    if "tstream" in dev_np:
        tab["tstream"] = pack_tables(dev_np["tstream"])
    if "bfeat" in dev_np:
        tab["bfeat"] = {"feat": dev_np["bfeat"]["feat"], "center": dev_np["bfeat"]["center"]}
    if "media" in dev_np:
        tab["media"] = tuple(getattr(dev_np["media"], f) for f in MediumTable._fields)
    if "env_distr" in dev_np:
        tab["env_distr"] = tuple(getattr(dev_np["env_distr"], f) for f in Distribution2D._fields)
    return upload(tab, device)


def flat_tables(dev: dict, prefix: str = "") -> dict:
    """Device tables -> {dotted name: numpy array}, for comparisons."""
    out = {}
    for k, v in dev.items():
        name = f"{prefix}{k}"
        if isinstance(v, TreeletPack):
            parts = {
                "top.child_bmin": v.top.child_bmin, "top.child_bmax": v.top.child_bmax,
                "top.child_idx": v.top.child_idx, "featT": v.featT, "center": v.center,
                "offset": v.offset, "count": v.count,
            }
            out.update({f"{name}.{p}": x.detach().cpu().numpy() for p, x in parts.items()})
        elif isinstance(v, (Distribution2D, MediumTable)):
            out.update({f"{name}.{p}": x.detach().cpu().numpy() for p, x in v._asdict().items()})
        elif isinstance(v, dict):
            out.update(flat_tables(v, name + "."))
        else:
            out[name] = v.detach().cpu().numpy()
    return out
