"""Per-device cost of one eagerly run step: flops, HBM bytes and
collectives, counted op by op on each rank's local shards.

The port's counterpart of src/repro/launch/hlo_cost.py. The reference
re-derives the roofline's three inputs from compiled, partitioned XLA
HLO, multiplying each while-loop body by its trip count because XLA's own
cost analysis visits a body once. The port has no compiled program: a
step runs eagerly, op by op, so `counting()` watches the ops that run
(with FakeTensorMode and a fake process group, nothing runs for real;
launch/dryrun.py) and every loop iteration is seen: trip counts are right
by construction. The three numbers, kept in the reference's `Cost`
fields:

  flops       — torch.utils.flop_counter's formula of each product on
                its LOCAL operands (the rank's shards), plus one flop an
                output element for every other op that computes, as the
                reference counts elementwise and reduce results.
                (FlopCounterMode itself, run above DTensor, counts the
                global product: on a (2, 4) mesh 8x the per-device count.)
  hbm_bytes   — result bytes plus operand bytes of the ops that
                materialise a value in device memory, the reference's
                MATERIALIZING set by aten name (products, gathers,
                scatters, copies, concatenations, pads, reductions,
                sorts, collectives, the flash kernel); standalone
                elementwise ops count as fused into their consumers, as
                the reference assumes of XLA:TPU. An in-place slice
                update moves twice the slice, not the buffer.
  collectives — counted by class with DTensor's CommDebugMode; each one's
                result bytes times the reference's wire multiplier (ring
                all-reduce 2x, the others 1x), split by the link its group
                spans (`coll_wire_link`: "nvlink" within one 8-GPU node,
                "network" across nodes; launch/roofline.py prices each).

The flash kernel (B6) is one fused op: its flops are the products of its
unmasked (query, key) pairs, its bytes q, k, v and the output once each;
the plain version it stands for on the CPU (and its materialised scores)
is not counted. Under autograd its backward is one fused op too, as the
gradient kernels run it on the card (csrc/flash_bwd.cu): its flops the
seven products of 2·D a pair those kernels run (S and dP twice, dV, dK,
dQ), its bytes q, k, v, the output, lse, the incoming gradient and the
three gradients once each; the plain gradient that gives the values here
is not counted. The split decode's halves under a mesh are
fused ops too: the partial's flops are its pairs over the rank's own
keys, its bytes q, the rank's K and V rows and the partials; the merge's
flops are a multiply-add per partial element, its bytes the partials
and the output. The partials' all-gather over the model axis between
them is a collective like any other.

`peak_live_bytes` is the largest total of live local tensors the
counting sees (the step's arguments included, as `live_bytes` sets them).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: ops that materialise their result in device memory (the reference's
#: MATERIALIZING, by aten name)
MATERIALIZING = {
    "mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
    "embedding", "index", "index_select", "gather", "take_along_dim",
    "scatter", "scatter_add", "scatter_reduce", "index_add", "clone",
    "cat", "stack", "constant_pad_nd", "sum", "mean", "amax", "amin", "max",
    "min", "logsumexp", "_softmax", "_log_softmax", "var_mean", "var",
    "sort", "topk", "cumsum", "_unsafe_view", "contiguous",
    "embedding_dense_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
}
#: in-place slice updates: twice the bytes written, never the buffer
INPLACE_SLICE = {"copy_", "index_put_", "index_put", "_index_put_impl_",
                 "slice_scatter", "select_scatter"}
#: ops that compute nothing: views, allocations, metadata
STRUCTURAL = {
    "empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "_to_copy", "to", "view", "_unsafe_view",
    "expand", "t", "transpose", "permute", "unsqueeze", "squeeze", "slice",
    "select", "as_strided", "split", "split_with_sizes", "unbind", "chunk",
    "reshape", "_reshape_alias", "unfold", "diagonal", "narrow",
    "new_empty", "new_empty_strided", "resize_", "set_",
}
#: collective class of each collective op, by name, and wire multipliers
COLLECTIVE = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
WIRE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}
#: GPUs a node holds: a group within one node talks over NVLink
GPUS_PER_NODE = 8


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    coll_bytes: dict = field(default_factory=dict)
    coll_wire: dict = field(default_factory=dict)
    #: wire bytes by the link they cross: "nvlink" or "network"
    coll_wire_link: dict = field(default_factory=dict)
    peak_live_bytes: float = 0.0

    @property
    def total_coll_wire(self) -> float:
        return float(sum(self.coll_wire.values()))

    def collective(self, kind: str, nbytes: float, link: str,
                   count: bool = True) -> None:
        """Record one collective of `nbytes` result bytes over `link`."""
        if count:
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        wire = nbytes * WIRE_MULT[kind]
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + nbytes
        self.coll_wire[kind] = self.coll_wire.get(kind, 0) + wire
        self.coll_wire_link[link] = self.coll_wire_link.get(link, 0) + wire


def tensor_bytes(t) -> int:
    """The bytes of t's distinct elements: an expanded (stride 0)
    dimension repeats its elements and counts once."""
    if not isinstance(t, torch.Tensor):
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def link_of(ranks) -> str:
    """"nvlink" where every rank of a group sits in one node, else
    "network"."""
    return ("nvlink" if len({r // GPUS_PER_NODE for r in ranks}) == 1
            else "network")


def _group_link(args) -> str:
    """The link of a functional collective's group (its name is the last
    string argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    if not names:
        return "network"
    return link_of(dist.get_process_group_ranks(_resolve_process_group(names[-1])))


def _flash_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head: query row i sits at key
    position i + sk - sq (right-aligned)."""
    total = 0
    for i in range(sq):
        pos = i + sk - sq
        hi = min(pos + 1, sk) if causal else sk
        lo = max(pos - window + 1, 0) if window is not None else 0
        total += max(hi - lo, 0)
    return total


class _Counter(TorchDispatchMode):
    """Counts each local op (the sharding propagator's shape-only runs
    excluded) into a Cost."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.paused = 0
        self.live = 0.0

    def keep_alive(self, t: torch.Tensor) -> None:
        nbytes = tensor_bytes(t)
        self.live += nbytes
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live)

        def release(counter=weakref.ref(self), nbytes=nbytes):
            c = counter()
            if c is not None:
                c.live -= nbytes

        weakref.finalize(t, release)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # counted as the local ops DTensor runs
        out = func(*args, **kwargs)
        if self.paused:
            return out
        name = func._overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type == "meta" for t in outs):
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        kind = COLLECTIVE.get(name)
        if kind is not None:
            # counts come from CommDebugMode; bytes and links from here
            self.cost.collective(kind, sum(tensor_bytes(t) for t in outs),
                                 _group_link(args), count=False)
            self.cost.hbm_bytes += (sum(tensor_bytes(t) for t in outs)
                                    + sum(tensor_bytes(t) for t in ins))
            return out
        if name in STRUCTURAL or func.is_view or name.startswith("sym_") \
                or name in ("wait_tensor", "device", "layout"):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.cost.flops += flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        else:
            self.cost.flops += float(sum(t.numel() for t in outs))
        if name in INPLACE_SLICE:
            src = ins[-1] if ins else None
            self.cost.hbm_bytes += 2.0 * tensor_bytes(src)
        elif name in MATERIALIZING:
            self.cost.hbm_bytes += (sum(tensor_bytes(t) for t in outs)
                                    + sum(tensor_bytes(t) for t in ins))
        if not func._schema.is_mutable:
            for t in outs:
                self.keep_alive(t)
        return out


@contextlib.contextmanager
def _skip_propagation(counter: _Counter):
    """DTensor's sharding propagator runs each new op once on global-shape
    fake tensors to learn its output's shape; those runs are not work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    original = ShardingPropagator._propagate_tensor_meta_non_cached

    def shape_only(self, op_schema):
        counter.paused += 1
        try:
            return original(self, op_schema)
        finally:
            counter.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = shape_only
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = original


@contextlib.contextmanager
def _fused_flash(counter: _Counter):
    """ops.flash_attention (and, under autograd, its backward),
    ops.flash_decode_partial and ops.flash_combine each counted as the
    one kernel it launches on the card (module docstring)."""
    from ..kernels import ops

    originals = {name: getattr(ops, name) for name in (
        "flash_attention", "flash_decode_partial", "flash_combine")}

    def fused(name, flops, operands):
        def run(*args, **kwargs):
            counter.paused += 1
            try:
                out = originals[name](*args, **kwargs)
            finally:
                counter.paused -= 1
            counter.cost.flops += flops(out, *args, **kwargs)
            counter.cost.hbm_bytes += sum(tensor_bytes(t) for t in
                                          (*operands(*args), out))
            counter.keep_alive(out)
            return out
        return run

    def attention_flops(out, q, k, v, *, causal=True, window=None, **_):
        b, hq, sq, d = q.shape
        return 4.0 * b * hq * d * _flash_pairs(sq, k.shape[2], causal, window)

    forward = fused("flash_attention", attention_flops,
                    lambda q, k, v: (q, k, v))

    class FusedGrad(torch.autograd.Function):
        """B6 under autograd: the forward as above; the backward the
        gradient kernels' one fused op, its values the plain gradient's."""

        @staticmethod
        def forward(ctx, q, k, v, causal, window, scale):
            ctx.save_for_backward(q, k, v)
            ctx.mask = (causal, window, scale)
            return forward(q, k, v, causal=causal, window=window, scale=scale)

        @staticmethod
        def backward(ctx, g):
            from ..kernels.flash_grad import flash_attention_backward

            q, k, v = ctx.saved_tensors
            causal, window, scale = ctx.mask
            counter.paused += 1
            try:
                grads = flash_attention_backward(q, k, v, g, causal, window,
                                                 scale)
            finally:
                counter.paused -= 1
            b, hq, sq, d = q.shape
            counter.cost.flops += 14.0 * b * hq * d * _flash_pairs(
                sq, k.shape[2], causal, window)
            # q, k, v and their gradients, the output and dO, the f32 lse
            counter.cost.hbm_bytes += (
                2 * sum(tensor_bytes(t) for t in (q, k, v))
                + 2 * tensor_bytes(g) + 4.0 * b * hq * sq)
            for t in grads:
                counter.keep_alive(t)
            return (*grads, None, None, None)

    def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return FusedGrad.apply(q, k, v, causal, window, scale)
        return forward(q, k, v, causal=causal, window=window, scale=scale)

    ops.flash_attention = flash_attention
    ops.flash_decode_partial = fused("flash_decode_partial", attention_flops,
                                     lambda q, k, v: (q, k, v))
    ops.flash_combine = fused("flash_combine",
                              lambda out, part, dtype: 2.0 * part.numel(),
                              lambda part, dtype: (part,))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def counting(live_bytes: float = 0.0):
    """Count everything run inside into the yielded Cost (module
    docstring); `live_bytes`: the local bytes already live (the step's
    arguments), where the live total starts."""
    from torch.distributed.tensor.debug import CommDebugMode

    cost = Cost()
    counter = _Counter(cost)
    counter.live = cost.peak_live_bytes = float(live_bytes)
    comm = CommDebugMode()
    with _skip_propagation(counter), _fused_flash(counter), comm, counter:
        yield cost
    for op, n in comm.get_comm_counts().items():
        kind = COLLECTIVE.get(getattr(op, "__name__", str(op)).split(".")[-1])
        if kind is not None:
            cost.coll_counts[kind] = cost.coll_counts.get(kind, 0) + n
