"""Perf variants on the dry run: one cell with config overrides, its
three modelled roofline terms beside a baseline record; and the SPDC
pipeline's relay programs.

Port of src/repro/launch/perf.py, over launch/dryrun.py (every number is
modelled, none measured):

    PYTHONPATH=src python -m repro_torch.launch.perf --arch tinyllama-1.1b \\
        --shape train_4k --set remat=none --set grad_accum=4 --tag tiny_noremat
    PYTHONPATH=src python -m repro_torch.launch.perf --spdc --relay exact \\
        --tag spdc_exact

A variant's baseline is the record `python -m repro_torch.launch.dryrun`
wrote for the same cell into --base (its default --out).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

from . import dryrun

RESULTS = Path(tempfile.gettempdir()) / "repro_torch_perf"
BASE = dryrun.RESULTS_DIR
TERMS = ("compute_s", "memory_s", "collective_s", "roofline_fraction")


def _coerce(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def run_variant(arch, shape_name, mesh_name, overrides, tag, *,
                base_dir: Path = BASE, out_dir: Path = RESULTS) -> dict:
    """The dry-run cell with the config's fields replaced by `overrides`,
    written under out_dir/tag; prints each term against the baseline
    record where there is one."""
    cfg = replace(dryrun.get_config(arch), **overrides)
    orig = dryrun.get_config
    dryrun.get_config = lambda name: cfg if name == arch else orig(name)
    try:
        rec = dryrun.run_cell(arch, shape_name, mesh_name, out_dir / tag)
    finally:
        dryrun.get_config = orig
    base_file = base_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    if base_file.exists():
        base = json.loads(base_file.read_text())
        print(f"[perf:{tag}] vs baseline:")
        for k in TERMS:
            b, v = base[k], rec[k]
            delta = (v - b) / b * 100 if b else float("nan")
            print(f"   {k:20s} {b:12.4f} -> {v:12.4f}  ({delta:+.1f}%)")
    return rec


def run_spdc_variant(mesh_name, relay, n, tag, *, out_dir: Path = RESULTS) -> dict:
    """The SPDC cell with relay program `relay` ("baseline", "exact" or
    "stream"), written as out_dir/tag.json."""
    rec = dryrun.run_spdc_cell(mesh_name, out_dir, n=n, program=relay, tag=tag)
    counts = rec["collectives"]["counts"]
    print(f"[perf:{tag}] compute={rec['compute_s']*1e3:.2f}ms "
          f"memory={rec['memory_s']*1e3:.2f}ms "
          f"collective={rec['collective_s']*1e3:.2f}ms "
          f"permutes={counts.get('collective-permute', 0)} "
          f"coll_wire={rec['collective_wire_bytes']/1e9:.3f}GB (modelled)")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--spdc", action="store_true")
    ap.add_argument("--exact-relay", action="store_true")
    ap.add_argument("--relay", choices=["baseline", "exact", "stream"])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--base", default=str(BASE))
    args = ap.parse_args(argv)
    if args.spdc:
        relay = args.relay or ("exact" if args.exact_relay else "baseline")
        run_spdc_variant(args.mesh, relay, args.n, args.tag,
                         out_dir=Path(args.out))
    else:
        overrides = {}
        for kv in args.set:
            k, v = kv.split("=", 1)
            overrides[k] = _coerce(v)
        run_variant(args.arch, args.shape, args.mesh, overrides, args.tag,
                    base_dir=Path(args.base), out_dir=Path(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
