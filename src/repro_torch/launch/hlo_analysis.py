"""Roofline terms of a step from its recorded collectives: the port of the
JAX package's ``launch/hlo_analysis.py``.

PyTorch has no HLO. The JAX module parses a compiled module's text for its
collectives and tensor shapes; the port records them while the code runs
instead, with two ``TorchDispatchMode``s:

* :class:`CollectiveTrace` records every collective the code issues: the
  ``_c10d_functional`` ops that DTensor's redistributions emit
  (all_gather_into_tensor, reduce_scatter_tensor, all_reduce,
  all_to_all_single) and the eager ``c10d`` ops behind ``dist.all_reduce``
  and its kin, each under JAX's five type names (all-gather, all-reduce,
  reduce-scatter, all-to-all, collective-permute for point-to-point) with
  its result bytes on this rank. Anything else (a broadcast) is recorded
  under its own op name. In eager PyTorch every loop trip runs and is
  recorded, so every op has loop depth 0 and ``loop_trips`` changes
  nothing; the parameter is kept for the JAX signature.
* :class:`ShapeTrace` records the (dtype, shape) of every op's output, the
  tensor shapes :func:`param_replica_bytes` buckets where JAX reads them
  from the HLO text.

:class:`Roofline` combines the recorded collective bytes with the analytic
FLOPs and bytes of ``roofline_model``, at the H100 peaks of
``roofline_model.H100_SXM``:

compute    = FLOPs / (chips × the compute dtype's peak)
memory     = HBM_bytes / (chips × 3.35 TB/s)
collective = this rank's collective bytes / 450 GB/s (one NVLink 4
             direction)
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .roofline_model import H100_SXM, peak_flops

HBM_BW = H100_SXM["hbm_bytes_per_s"]
LINK_BW = H100_SXM["nvlink_bytes_per_s"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# op name (namespace::name, without the overload) -> JAX's type
_TYPES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
}
# collectives of no JAX type, recorded under their own names
_OTHER = {"c10d::broadcast_", "c10d::reduce_", "c10d::gather_",
          "c10d::scatter_", "c10d::recv_any_source_",
          "_c10d_functional::broadcast", "_c10d_functional::broadcast_"}


# c10d's RedOpType, as an eager all-reduce's ``ReduceOp`` carries it
_RED_OPS = {0: "sum", 1: "avg", 2: "product", 3: "min", 4: "max",
            5: "band", 6: "bor", 7: "bxor", 8: "premul_sum"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _reduce_op(name: str, args) -> str:
    """'sum', 'max', ... of an all-reduce (the functional form's string,
    the eager form's ``ReduceOp``), else ''."""
    if name.startswith("_c10d_functional::all_reduce") and len(args) > 1:
        return str(args[1]).lower()
    if name.startswith("c10d::allreduce") and len(args) > 2:
        try:
            return _RED_OPS.get(int(args[2].op()), "")
        except (AttributeError, RuntimeError, TypeError):
            return ""
    return ""


def _defer(func, types) -> bool:
    """Let a DTensor op (or a higher-order op) run first: a mode sees an op
    before the subclass does, and the collectives of a DTensor op appear
    only once DTensor desugars it into local ops (as ``CommDebugMode``
    does)."""
    from torch.distributed.tensor import DTensor
    return isinstance(func, torch._ops.HigherOrderOperator) \
        or any(issubclass(t, DTensor) for t in types)


class CollectiveTrace(TorchDispatchMode):
    """Records the collectives issued while it is on (``with
    CollectiveTrace() as trace:``) in ``trace.ops``: dicts of ``type``
    (JAX's name), ``bytes`` (the result on this rank: a functional op's
    output, an eager op's output tensors, its first argument), ``depth``
    (0: eager runs every trip), ``op_name`` and ``reduce`` (an
    all-reduce's op)."""

    def __init__(self):
        super().__init__()
        self.ops: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _defer(func, types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in _TYPES or name in _OTHER:
            functional = name.startswith("_c10d_functional::")
            self.ops.append({
                "type": _TYPES.get(name, name),
                "bytes": _nbytes(out if functional else args[:1]),
                "depth": 0, "op_name": name,
                "reduce": _reduce_op(name, args)})
        return out


class ShapeTrace(TorchDispatchMode):
    """Records ``(dtype, shape)`` of every tensor an op returns while it is
    on, in ``trace.shapes``."""

    def __init__(self):
        super().__init__()
        self.shapes: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _defer(func, types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.shapes.extend((t.dtype, tuple(t.shape)) for t in _tensors(out))
        return out


def collective_ops(trace) -> list[dict]:
    """Every collective recorded: type, result bytes, loop depth (0),
    op name. ``trace`` is a :class:`CollectiveTrace` or its ``ops``."""
    return list(getattr(trace, "ops", trace))


def collective_bytes(trace, *, loop_trips: tuple[float, ...] = ()) -> dict:
    """Bytes by type and the count of collectives. ``loop_trips`` weighs an
    op at depth d by prod(loop_trips[:d]), as the JAX function does; every
    recorded op has depth 0 (eager runs each trip), so it weighs 1."""
    out = {c: 0.0 for c in _COLLECTIVES}
    out["count"] = 0
    for op in collective_ops(trace):
        mult = 1.0
        for t in loop_trips[:op["depth"]]:
            mult *= t
        out[op["type"]] = out.get(op["type"], 0.0) + op["bytes"] * mult
        out["count"] += 1
    return out


def _dtype_bytes(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(dtype)


def param_replica_bytes(shapes, param_shapes, m: int, l: int) -> dict:
    """Footprint of group- vs device-replicated parameter tensors among
    the ``(dtype, shape)`` pairs a :class:`ShapeTrace` recorded (one fused
    round): ``(m,) + s`` (one copy per group, the gradient-space engine's
    steady state) vs ``(m, l) + s`` (one copy per selected device per
    group, the model-averaging workflow), ``s`` each of ``param_shapes``
    (pass the distinctive ones, ndim >= 2: 1-D biases collide with
    activations). Returns ``{"m_bytes", "ml_bytes", "m_count",
    "ml_count"}``; a tensor counts once per op that returns it, so the
    totals show scaling, not the live set."""
    m_shapes = {(m,) + tuple(int(d) for d in s) for s in param_shapes}
    ml_shapes = {(m, l) + tuple(int(d) for d in s) for s in param_shapes}
    out = {"m_bytes": 0, "ml_bytes": 0, "m_count": 0, "ml_count": 0}
    for dtype, shape in shapes:
        shape = tuple(int(d) for d in shape)
        nbytes = _dtype_bytes(dtype)
        for d in shape:
            nbytes *= d
        if shape in ml_shapes:
            out["ml_bytes"] += nbytes
            out["ml_count"] += 1
        elif shape in m_shapes:
            out["m_bytes"] += nbytes
            out["m_count"] += 1
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # analytic, global per step (XLA-fallback)
    flops_ideal: float           # analytic with block-skipping attention
    hbm_bytes: float             # analytic, global per step
    coll_bytes: dict             # recorded on one rank, every trip
    chips: int
    model_flops: float = 0.0     # 6·N·D convention
    compute_dtype: str = "bf16"  # whose peak t_compute divides by

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * peak_flops(self.compute_dtype))

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(v for k, v in self.coll_bytes.items()
                         if k != "count"))

    @property
    def t_collective(self) -> float:
        # the recorded bytes are one rank's; its link carries them
        return self.total_coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_xla": self.flops,
            "flops_ideal": self.flops_ideal,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_dtype": self.compute_dtype,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def analyze(trace, *, chips: int, analytic,
            loop_trips: tuple[float, ...] = (),
            compute_dtype: str = "bf16") -> Roofline:
    """The recorded collectives with the analytic compute/memory model
    (``analytic``: ``roofline_model.AnalyticRoofline``). PyTorch has no
    compiled module to ask for cost counters, so the JAX artifact's
    ``raw_cost_analysis`` has no counterpart."""
    return Roofline(flops=analytic.flops_xla,
                    flops_ideal=analytic.flops_ideal,
                    hbm_bytes=analytic.hbm_bytes,
                    coll_bytes=collective_bytes(trace,
                                                loop_trips=loop_trips),
                    chips=chips, model_flops=analytic.model_flops,
                    compute_dtype=compute_dtype)
