"""Roofline analysis from a counted step (no card required).

Port of src/repro/launch/roofline.py, for NVIDIA H100 SXM GPUs. Three
terms per (arch × shape × mesh), all in seconds:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = hbm_bytes_per_device / HBM_BW
    collective = Σ over links of wire bytes / that link's rate

The inputs come from launch/op_cost.py's count of one eagerly run step on
a fake process group of the mesh's size (the reference parses them from
XLA's partitioned HLO; its `parse_collectives` has no counterpart here:
the collectives are counted as they run, each with the link its group
spans). These are MODELLED times of a production mesh: the card's machine
has one GPU, so none of them is measured.

MODEL_FLOPS = 6·N·tokens for training (2 fwd + 4 bwd), 2·N·tokens for
inference, N = active params. The useful-compute ratio MODEL_FLOPS /
(flops·chips) exposes recomputation and redundancy; the roofline fraction
ideal_compute_time / max(term) is the score the reference reports.

Constants (H100 SXM, dense, at its 700 W limit):
  * PEAK_FLOPS 989e12 — bf16 tensor cores, dense (NVIDIA H100 data sheet).
  * HBM_BW 3.35e12 B/s — HBM3 (NVIDIA H100 data sheet).
  * NVLINK_BW 450e9 B/s — NVLink 4, 900 GB/s per GPU both ways, 450 GB/s
    each way, all to all inside an 8-GPU node (NVIDIA H100 data sheet;
    HGX H100 / NVSwitch).
  * NETWORK_BW 50e9 B/s — one 400 Gb/s NDR InfiniBand adapter a GPU
    across nodes (the HGX/DGX H100 reference design: ConnectX-7, 400 Gb/s
    = 50 GB/s each way).
A mesh axis of 16 spans two 8-GPU nodes, so its collectives cross the
network and are priced at the slower link.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

PEAK_FLOPS = 989e12  # bf16 / GPU, dense
HBM_BW = 3.35e12  # B/s per GPU
NVLINK_BW = 450e9  # B/s each way, inside a node
NETWORK_BW = 50e9  # B/s each way, across nodes
#: each link's rate; wire bytes of an unknown link pay the slowest
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    ideal_s: float
    roofline_fraction: float
    collectives: dict
    memory_stats: dict

    def to_dict(self):
        return asdict(self)


def collective_seconds(op_cost) -> float:
    """Wire bytes over each link's rate (module docstring); wire bytes of
    no recorded link are priced at the network's."""
    by_link = dict(op_cost.coll_wire_link)
    unplaced = op_cost.total_coll_wire - sum(by_link.values())
    if unplaced > 0:
        by_link["network"] = by_link.get("network", 0.0) + unplaced
    return sum(v / LINK_BW.get(k, NETWORK_BW) for k, v in by_link.items())


def analyze(
    *, arch: str, shape: str, mesh_name: str, chips: int, op_cost,
    memory_stats: dict, active_params: float, tokens: float, training: bool,
) -> Roofline:
    """op_cost: a launch.op_cost.Cost of one step, per device."""
    flops = float(op_cost.flops)
    nbytes = float(op_cost.hbm_bytes)
    coll_wire = op_cost.total_coll_wire
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = collective_seconds(op_cost)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mult = 6.0 if training else 2.0
    model_flops = mult * active_params * tokens
    total = flops * chips
    useful = model_flops / total if total else 0.0
    ideal_s = model_flops / (chips * PEAK_FLOPS)
    bound_s = max(terms.values())
    fraction = ideal_s / bound_s if bound_s > 0 else 0.0
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=nbytes,
        collective_wire_bytes=coll_wire,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        ideal_s=ideal_s, roofline_fraction=fraction,
        collectives={"counts": op_cost.coll_counts,
                     "result_bytes": op_cost.coll_bytes,
                     "wire_bytes": op_cost.coll_wire,
                     "wire_bytes_by_link": op_cost.coll_wire_link},
        memory_stats=memory_stats,
    )
