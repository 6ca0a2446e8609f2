"""Sharding rules: logical axis names → mesh placements.

Port of src/repro/distrib/sharding.py. Models are written against
*logical* axis names; a ShardingRules object resolves them to the active
mesh's axes. With no active rules (one device, the serving and SPDC
paths) every constraint returns its tensor itself and parameters are
plain tensors, so those paths launch the same kernels and give the same
numbers as without this module.

Logical names:
  "batch"   → the data-parallel axes (("pod","data") multi-pod, ("data",)
              single-pod, () on one device)
  "model"   → the tensor-parallel axis
  "seq"     → sequence sharding of the residual stream (mapped to "model")
  "heads", "kv_heads" → "model" where the heads divide over it
  "qseq"    → the sequence-parallel attention fallback axis
  "fsdp"    → the parameter-only data axes (ZeRO-3 style)
  None      → replicated

Fallback policy (DESIGN.md §5), as the reference's: head-sharded
attention when num_heads % model_size == 0, else sequence-parallel
attention (Q sharded on seq, KV gathered).

The mesh is a `torch.distributed.device_mesh.DeviceMesh`, and a sharded
tensor a DTensor. `resolve` gives the reference's PartitionSpec entries
as a plain tuple (None, an axis name, or a tuple of axis names per
tensor dimension); `placements` turns them into one DTensor placement per
mesh dimension (Shard(tensor dim) or Replicate()). Where the reference
relies on GSPMD to insert collectives at a with_sharding_constraint,
`constrain` redistributes a DTensor to the resolved placements, and the
collectives are DTensor's (ROADMAP §C).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

@dataclass(frozen=True)
class ShardingRules:
    mesh: object | None = None  # a DeviceMesh
    batch_axes: tuple[str, ...] = ()
    model_axis: str | None = None
    fsdp_axes: tuple[str, ...] = ()  # param-only second axis (ZeRO-3 style)
    # resolved per config when the step is built:
    shard_heads: bool = True  # False => sequence-parallel attention
    shard_kv: bool = False    # kv heads sharded (only when divisible)
    shard_seq: bool = True    # residual-stream sequence sharding

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return axis_size(self.mesh, self.model_axis)

    def resolve(self, *names) -> tuple:
        """Map logical names to the reference's PartitionSpec entries, as
        `tuple(PartitionSpec(...))` gives them: a one-axis tuple becomes
        its axis name."""
        out = []
        for nm in names:
            if nm == "batch":
                out.append(self.batch_axes if self.batch_axes else None)
            elif nm == "model":
                out.append(self.model_axis)
            elif nm == "seq":
                out.append(self.model_axis if self.shard_seq else None)
            elif nm == "heads":
                out.append(self.model_axis if self.shard_heads else None)
            elif nm == "kv_heads":
                out.append(self.model_axis if self.shard_kv else None)
            elif nm == "fsdp":
                out.append(self.fsdp_axes if self.fsdp_axes else None)
            elif nm == "qseq":
                out.append(None if self.shard_heads else self.model_axis)
            elif nm is None:
                out.append(None)
            else:
                raise ValueError(f"unknown logical axis {nm!r}")
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in out)

    def placements(self, *names) -> tuple:
        """One DTensor placement per mesh dimension for a tensor whose
        dimensions carry `names`: Shard(d) where a mesh axis appears in
        dimension d's entry, Replicate() where it appears in none. Several
        mesh axes on one dimension shard it in mesh order, as a
        PartitionSpec's tuple entry does."""
        from torch.distributed.tensor import Replicate, Shard

        if self.mesh is None:
            raise ValueError("placements need a mesh")
        spec = self.resolve(*names)
        found = {}
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            for axis in axes:
                if axis in found:
                    raise ValueError(f"mesh axis {axis!r} shards dimensions "
                                     f"{found[axis]} and {dim}")
                found[axis] = dim
        return tuple(Shard(found[axis]) if axis in found else Replicate()
                     for axis in self.mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along one named axis of a DeviceMesh."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


#: the active rules: a context variable, as the reference's, so that a
#: model call on another thread (a serving thread during a sharded run)
#: sees none. The autograd engine runs a CUDA backward on a thread of its
#: own, whose context holds no rules: a checkpointed body that reads them
#: in its recomputation is bound to them with `with_rules`.
_RULES: contextvars.ContextVar[ShardingRules | None] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


def current_rules() -> ShardingRules | None:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def with_rules(fn):
    """fn bound to the rules active now: it runs under them wherever it is
    called, as a checkpointed body's recomputation in the backward is;
    fn itself where none are active."""
    rules = current_rules()
    if rules is None:
        return fn

    def bound(*args, **kwargs):
        with use_rules(rules):
            return fn(*args, **kwargs)

    return bound


def make_rules(
    mesh,
    *,
    num_heads: int | None = None,
    num_kv_heads: int | None = None,
    use_fsdp: bool = True,
) -> ShardingRules:
    """Build rules from a mesh with axes ⊆ {pod, data, model, servers}."""
    if mesh is None:
        return ShardingRules()
    names = mesh.mesh_dim_names
    batch = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else None
    msize = axis_size(mesh, model) if model else 1
    shard_heads = True
    if num_heads is not None and model and num_heads % msize != 0:
        shard_heads = False
    shard_kv = bool(
        shard_heads and num_kv_heads and model and num_kv_heads % msize == 0
    )
    # FSDP/ZeRO over all data-parallel axes, pod included (the reference's
    # reasoning: at ≥340B params, sharding state across pods is the
    # difference between fitting and not)
    fsdp = tuple(a for a in ("pod", "data") if a in names) if use_fsdp else ()
    return ShardingRules(
        mesh=mesh, batch_axes=batch, model_axis=model, fsdp_axes=fsdp,
        shard_heads=shard_heads, shard_kv=shard_kv,
    )


def is_sharded(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *names) -> torch.Tensor:
    """Redistribute x to the placements `names` resolve to under the
    active rules; x itself where no rules (or no mesh) are active. A plain
    tensor under active rules is taken as the same value on every rank
    (replicated), then redistributed."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    want = rules.placements(*names)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, rules.mesh,
                               [Replicate()] * rules.mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def distribute(x: torch.Tensor, *names) -> torch.Tensor:
    """The full tensor x (the same on every rank) as a DTensor placed by
    `names` under the active rules; x itself where none are active."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, rules.mesh, rules.placements(*names))


def plain_replicated():
    """DTensor's implicit_replication where rules are active (a plain
    tensor made inside a sharded step, a position range or a mask, counts
    as the same value on every rank), else nothing."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w. A sharded (B, S, d) activation goes as a batched product
    over B, so that DTensor never folds a batch and a sequence sharded
    over two mesh axes into one dimension (a strided shard, whose sizes
    it cannot work out on fake tensors); anything else is x @ w itself.
    Without active rules it is x @ w at once: the serving paths call this
    at every projection of every layer. A sharded decode token (B, 1, d)
    has its one-row sequence gathered first and goes as the (B, d)
    product an unsharded step runs, so that on one rank the two agree bit
    for bit."""
    if x.ndim == 3 and current_rules() is not None and is_sharded(x):
        if x.shape[1] == 1:
            from torch.distributed.tensor import Replicate, Shard

            x = x.redistribute(x.device_mesh, [
                Replicate() if pl == Shard(1) else pl for pl in x.placements])
            return (x.flatten(0, 1) @ w).unsqueeze(1)
        return torch.bmm(x, w.expand(x.shape[0], *w.shape))
    return x @ w


def gather(t: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """A local shard gathered along `dim` over the mesh axes that split it
    (innermost first, so a dimension split over (pod, data) comes back in
    order), differentiably: the backward hands each rank its shard's sum.
    For use inside `local_map`."""
    from torch.distributed._functional_collectives import (
        all_gather_tensor_autograd)

    for axis in reversed(axes):
        t = all_gather_tensor_autograd(t.contiguous(), dim, mesh.get_group(axis))
    return t


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed._functional_collectives import (
            all_reduce, wait_tensor)

        return wait_tensor(all_reduce(grad.contiguous(), "sum", ctx.group)), None


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """x itself, whose gradient is summed over `group` in the backward:
    for a value that every rank of the group holds whole but uses for its
    own part of a sum (inside `local_map`, where the placement declared
    for such an input would otherwise drop the other ranks' parts)."""
    return _SumGrads.apply(x, group)


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank; any other tensor as is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


__all__ = ["ShardingRules", "make_rules", "use_rules", "current_rules",
           "constrain", "distribute", "full", "is_sharded", "matmul",
           "plain_replicated", "gather", "sum_grads", "axis_size"]
