"""Record the torch ops a real run of the port dispatches.

The reference analyses the jaxpr of each entry point: a static program,
traced without running it. The port has no such program. Its waves read
host values (traversal iterations, compaction sizes, the deposit's width)
and branch on them, so fake or meta tensors cannot run them. This module
records what a real run dispatches instead: `OpRecorder` is a
`TorchDispatchMode` that logs every aten op with its name, its input and
output shapes, dtypes and devices, the Python frame of the port that
called it, and the wave it ran in (the integrator's loop reads,
`accel/stream.py::WAVES.loop_reads`, mark the waves). A seeded render
makes the record deterministic.

Beside the aten ops it logs:
- each kernel wrapper call (kernels/flush.py::flush_chunk,
  kernels/expand.py::expand) as ONE op named after the kernel. The
  kernels are bound through ctypes, so on CUDA no dispatch mode sees a
  launch; the wrappers announce themselves through
  `kernels.kernel_call`. On the CPU the ops of the plain version that
  the wrapper runs are not recorded: they are the kernel's body;
- each host read of a tensor (`.item()`, `.tolist()`, `bool()`, `int()`,
  `float()`, `.numpy()`, `.cpu()`), through a `TorchFunctionMode`; the
  aten ops such a read dispatches (`_local_scalar_dense`, a
  device-to-host copy) are marked `nested` so a sync counts once;
- each tensor made of host data (`torch.tensor`, `torch.as_tensor` of a
  Python number, list or array): on CUDA a copy the host waits for. A
  record on the CPU counts it too, as the card would;
- copies between host and device (`_to_copy` / `copy_` across devices)
  and ops whose output size depends on the data (`nonzero`,
  `masked_select`, `unique`, a boolean index): each of these waits for
  the device on CUDA.

Records keep tensor identities (`uid`) so that a later pass can follow a
value from op to op (analysis/cost.py's dtype round trips and sorted
index streams).
"""

from __future__ import annotations

import gc
import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
_SELF = os.path.abspath(__file__)
_KERNELS = os.path.join(_PKG, "kernels") + os.sep
_TORCH = os.path.dirname(torch.__file__)

#: torch functions that read a tensor's value on the host
_HOST_READS = {
    torch.Tensor.item: "item",
    torch.Tensor.tolist: "tolist",
    torch.Tensor.__bool__: "bool",
    torch.Tensor.__int__: "int",
    torch.Tensor.__float__: "float",
    torch.Tensor.__index__: "index",
    torch.Tensor.numpy: "numpy",
    torch.Tensor.cpu: "cpu",
}

#: torch functions that make a tensor of host data: on CUDA a copy the host
#: waits for (counted on the CPU too, as the card would count it)
_UPLOADS = (torch.tensor, torch.as_tensor, torch.asarray)

#: the ops whose caller a record keeps by default: the copies and gathers
#: the cost findings name (besides the float64 and one-element ops the
#: audit reads, whose caller is always kept)
FRAME_OPS = frozenset({"_to_copy", "to", "clone", "contiguous", "copy_", "repeat", "expand_copy",
                       "tile", "index", "index_select", "gather", "take", "take_along_dim",
                       "embedding"})

#: aten ops whose output size depends on the values (a device sync on CUDA)
_SHAPE_SYNCS = {"nonzero", "masked_select", "_unique2", "unique_dim", "unique_consecutive",
                "unique", "repeat_interleave", "nonzero_static"}


class TensorMeta(NamedTuple):
    """What a record keeps of one tensor argument or result."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str
    uid: int
    #: a zero-dim host tensor beside device tensors: a Python number the
    #: caller passed
    scalar: bool = False
    #: whether it is laid out contiguously (False: a view that a copy
    #: would have to relayout)
    contiguous: bool = True
    #: some stride is 0 (an expanded, broadcast view)
    broadcast: bool = False
    #: elements of the data a broadcast view repeats (its dims of nonzero
    #: stride); 0 when not broadcast
    base: int = 0

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize


@dataclass
class OpRecord:
    """One recorded op. kind: "op" (an aten op), "kernel" (a kernel
    wrapper call), "host_read" (a read of a tensor's value on the host),
    "upload" (a tensor made of host data)."""

    name: str
    kind: str
    ins: Tuple[TensorMeta, ...]
    outs: Tuple[TensorMeta, ...]
    #: the non-tensor arguments, in order (ints, floats, dims, dtypes)
    params: Tuple[Any, ...] = ()
    frame: str = ""
    wave: int = 0
    #: a host-to-device or device-to-host copy, or an op whose output size
    #: depends on the data: the device waits on CUDA
    sync: str = ""
    #: dispatched inside a host read (its own sync is the read's)
    nested: bool = False
    #: a kernel wrapper's arguments (tensor references), for its work count
    args: Optional[tuple] = field(default=None, repr=False)


def _is_ours(filename: str) -> bool:
    """A frame of the port's own code: the package, less this module and
    the kernel wrappers (a kernel's record names its caller)."""
    return filename.startswith(_PKG) and filename != _SELF and not filename.startswith(_KERNELS)


class OpRecorder:
    """Record every op a block of code dispatches (see module doc).

        with OpRecorder() as rec:
            integ.pool_chunk(...)
        rec.records  # [OpRecord, ...] in dispatch order

    frames=True looks up every op's caller; a set of op names (the default,
    FRAME_OPS) looks it up for those ops only, and for the ops with a
    float64 operand or a one-element result (and every kernel call, host
    read and upload)."""

    def __init__(self, frames=FRAME_OPS):
        self.frames = frames
        self.records: List[OpRecord] = []
        self._uids: Dict[int, Tuple[Any, int]] = {}
        self._next_uid = 0
        self._quiet = 0
        self._reading = 0
        self._code_ours: Dict[Any, bool] = {}
        self._dispatch = _DispatchMode(self)
        self._function = _FunctionMode(self)
        from tpu_pbrt_torch.accel import stream

        self._waves = stream.WAVES
        self._wave0 = 0

    # -- lifetime ------------------------------------------------------
    def __enter__(self) -> "OpRecorder":
        from tpu_pbrt_torch import kernels

        if kernels.OBSERVER is not None:
            raise RuntimeError("an OpRecorder is already recording")
        self._wave0 = self._waves.loop_reads
        # the identity map's weak references make every collection pass
        # walk the whole record: collect once afterwards instead
        self._gc = gc.isenabled()
        gc.disable()
        kernels.OBSERVER = self
        self._function.__enter__()
        self._dispatch.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        from tpu_pbrt_torch import kernels

        self._dispatch.__exit__(*exc)
        self._function.__exit__(*exc)
        kernels.OBSERVER = None
        if self._gc:
            gc.enable()

    # -- identities ----------------------------------------------------
    def uid(self, t: torch.Tensor) -> int:
        ent = self._uids.get(id(t))
        if ent is not None and ent[0]() is t:
            return ent[1]
        self._next_uid += 1
        self._uids[id(t)] = (weakref.ref(t), self._next_uid)
        return self._next_uid

    def meta(self, t: torch.Tensor, scalar: bool = False) -> TensorMeta:
        ent = self._uids.get(id(t))
        if ent is not None and ent[0]() is t:
            uid = ent[1]
        else:
            uid = self.uid(t)
        contiguous = t.is_contiguous()
        base = 0
        if not contiguous and 0 in t.stride() and t.numel() > 1:
            base = 1
            for n, st in zip(t.shape, t.stride()):
                base *= n if st else 1
        return TensorMeta(tuple(t.shape), t.dtype, t.device.type, uid, scalar, contiguous,
                          base > 0, base)

    # -- where -----------------------------------------------------------
    def caller(self) -> str:
        """`path:line function` of the innermost frame of the port's
        package (outside this module), or else of the innermost frame
        outside torch and this module (a caller's own code)."""
        f = sys._getframe(2)
        cache = self._code_ours
        first = None
        while f is not None:
            code = f.f_code
            ours = cache.get(code)
            if ours is None:
                ours = cache[code] = (os.path.relpath(code.co_filename, _REPO)
                                      if _is_ours(code.co_filename) else "")
            if ours:
                return f"{ours}:{f.f_lineno} {code.co_name}"
            if first is None and not code.co_filename.startswith((_TORCH, _SELF)):
                first = f
            f = f.f_back
        if first is None:
            return ""
        return f"{os.path.relpath(first.f_code.co_filename, _REPO)}:{first.f_lineno} " \
               f"{first.f_code.co_name}"

    def _wave(self) -> int:
        return self._waves.loop_reads - self._wave0

    # -- the kernel seam (kernels.kernel_call) ----------------------------
    def kernel_call(self, name: str, args: tuple):
        rec = self

        class _Call:
            def __enter__(self_):
                self_.frame = rec.caller()
                rec._quiet += 1

            def __exit__(self_, *exc):
                rec._quiet -= 1
                if exc[0] is None:
                    ins = tuple(rec.meta(a) for a in args if isinstance(a, torch.Tensor))
                    params = tuple(a for a in args if not isinstance(a, torch.Tensor))
                    rec.records.append(OpRecord(name, "kernel", ins, (), params, self_.frame,
                                                rec._wave(), args=args))
                return False

        return _Call()

    # -- queries --------------------------------------------------------
    def ops(self) -> List[OpRecord]:
        """The aten ops and kernel calls."""
        return [r for r in self.records if r.kind in ("op", "kernel")]

    def syncs(self) -> List[OpRecord]:
        """Every record that makes the host wait for the device on CUDA:
        the host reads, the uploads, the host-device copies and the
        data-sized ops that no host read or upload dispatched."""
        return [r for r in self.records
                if r.kind in ("host_read", "upload") or (r.sync and not r.nested)]

    def waves(self) -> int:
        """Loop reads seen since the recorder was entered (the waves of a
        pool chunk or of a fixed batch's bounce loop)."""
        return self._wave()


class _DispatchMode(TorchDispatchMode):
    def __init__(self, rec: OpRecorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = self.rec
        if rec._quiet:
            return out
        name = _NAMES.get(func)
        if name is None:
            name = _NAMES[func] = func._schema.name.split("::", 1)[-1]
        if name in _SKIP:
            return out
        ins, params = [], []
        for a in (*args, *kwargs.values()):
            if isinstance(a, torch.Tensor):
                ins.append(a)
            elif isinstance(a, (list, tuple)) and a and isinstance(a[0], (torch.Tensor,
                                                                        type(None))):
                ins.extend(x for x in a if isinstance(x, torch.Tensor))
            else:
                params.append(a)
        on_dev = any(t.device.type != "cpu" for t in ins)
        ins = tuple(rec.meta(t, scalar=on_dev and t.dim() == 0 and t.device.type == "cpu")
                    for t in ins)
        if isinstance(out, torch.Tensor):
            outs = (rec.meta(out),)
        elif isinstance(out, (list, tuple)):
            outs = tuple(rec.meta(t) for t in out if isinstance(t, torch.Tensor))
        else:
            outs = ()
        sync = ""
        if name in _SHAPE_SYNCS or (name == "index" and any(
                m.dtype == torch.bool for m in ins[1:])):
            sync = "shape"
        elif name in ("_to_copy", "copy_", "_copy_from", "to") and ins and outs:
            src = ins[-1].device if name == "copy_" else ins[0].device
            dst = outs[0].device
            if src != dst:
                sync = "d2h" if dst == "cpu" else "h2d"
        elif name == "_local_scalar_dense":
            sync = "d2h"
        frames = rec.frames
        # the caller of every op, of the named ops, or of the ops the
        # audit reads it for: float64 values and one-element results
        want = frames is True or (frames and (
            name in frames or any(m.dtype == torch.float64 for m in ins + outs)
            or (outs and all(m.numel <= 1 for m in outs))))
        frame = rec.caller() if want else ""
        rec.records.append(OpRecord(name, "op", ins, outs, tuple(params), frame,
                                    rec._wave(), sync, nested=rec._reading > 0))
        return out


#: aten op -> its base name ("add" for aten::add.Tensor)
_NAMES: Dict[Any, str] = {}
#: ops that only re-wrap a tensor (no data, no op on a device)
_SKIP = {"detach", "lift_fresh", "alias"}


class _FunctionMode(TorchFunctionMode):
    def __init__(self, rec: OpRecorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if func in _UPLOADS and args and not isinstance(args[0], torch.Tensor) and not rec._quiet:
            rec._reading += 1
            try:
                out = func(*args, **kwargs)
            finally:
                rec._reading -= 1
            rec.records.append(OpRecord(func.__name__, "upload", (), (rec.meta(out),), (),
                                        rec.caller(), rec._wave(), sync="h2d"))
            return out
        what = _HOST_READS.get(func)
        if what is None or rec._quiet or not args or not isinstance(args[0], torch.Tensor):
            return func(*args, **kwargs)
        t = args[0]
        rec.records.append(OpRecord(what, "host_read", (rec.meta(t),), (), (), rec.caller(),
                                    rec._wave(), sync="d2h"))
        rec._reading += 1
        try:
            return func(*args, **kwargs)
        finally:
            rec._reading -= 1
