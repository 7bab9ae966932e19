#!/usr/bin/env python
"""Recommend the compact-table capacities of an experiment from measured
occupancy.

Counterpart of tools/calibrate_capacity.py:71-179, with the port's own
config loader, datasets and synthetic scenes: numpy only, no device.  It
replays frames on the host, tracks each stage's active set through the
backbone's exact active-set transfer functions (SubM keeps the set; a
strided sparse conv dilates it by a k^nd binary max-pool at stride s, as
``ops/sparse_down.downsample_active_set`` does; the voxel backbone's extra
z-conv by a (3, 1, 1) pool at stride (2, 1, 1) with padding 0) and prints
the recommended ``reader.pillar_capacity`` / ``reader.voxel_capacity``
(and ``reader.cylinder_capacity`` for MVF) and
``backbone.stage_capacity_frac`` with a safety margin, in the JAX tool's
words.  The table capacities are the port's tuning knob: its per-frame
cost follows them, and an undersized one fails loudly (training) or is
repaired (serving).

    python -m pillarnext_tpu_torch.cli.calibrate_capacity --config <experiment.yaml> \\
        [--frames 32] [--points 200000] [--margin 1.3] [--root-path <dataset>]
    (or: pnx-torch-calibrate-capacity ...)

Without ``--root-path`` the frames are synthetic beam-structured scenes
(``utils/synth.lidar_like_points``, frame i from seed i); with it, the
first frames of the config's val dataset under that root.
"""

from __future__ import annotations

import argparse

import numpy as np


def pool_or(occ: np.ndarray, k: int, s: int) -> np.ndarray:
    """Binary max-pool (k^nd window, stride s, padding k // 2) of a 2-D or
    3-D occupancy bitmap: the dilated active set of a strided sparse conv."""
    p = k // 2
    nd = occ.ndim
    padded = np.zeros(tuple(d + 2 * p for d in occ.shape), bool)
    padded[tuple(slice(p, p + d) for d in occ.shape)] = occ
    oshape = tuple((d + 2 * p - k) // s + 1 for d in occ.shape)
    out = np.zeros(oshape, bool)
    for off in np.ndindex(*(k,) * nd):
        out |= padded[tuple(slice(o, o + od * s, s) for o, od in zip(off, oshape))]
    return out


def pool_or_z(occ: np.ndarray, k: int = 3, s: int = 2) -> np.ndarray:
    """The voxel backbone's extra z-only conv: (k, 1, 1) kernel, (s, 1, 1)
    stride, padding 0."""
    od = (occ.shape[0] - k) // s + 1
    out = np.zeros((od,) + occ.shape[1:], bool)
    for dz in range(k):
        out |= occ[dz:dz + od * s:s]
    return out


def round_up(n: int, q: int = 4096) -> int:
    return max(q, -(-n // q) * q)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Recommend table capacities from measured occupancy.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--margin", type=float, default=1.3)
    ap.add_argument("--root-path", default=None)
    return ap


def frames(cfg: dict, args):
    """(N, 3) xyz of each frame: the val dataset's under ``--root-path``,
    else synthetic scenes."""
    pc = [float(v) for v in cfg["model"]["reader"]["pc_range"]]
    if args.root_path:
        from pillarnext_tpu_torch.utils import builders

        dcfg = dict(cfg["data"]["val_dataset"], root_path=args.root_path)
        ds = builders.build_dataset(dcfg)
        for i in range(min(args.frames, len(ds))):
            yield np.asarray(ds.get(i, np.random.RandomState(i))["points"])[:, :3]
    else:
        from pillarnext_tpu_torch.utils.synth import lidar_like_points

        for i in range(args.frames):
            pts, mask = lidar_like_points(1, args.points, pc, seed=i)
            yield pts[0][mask[0]][:, :3]


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    from pillarnext_tpu_torch.utils.config import load_experiment

    cfg = load_experiment(args.config)
    rd = cfg["model"]["reader"]
    bb = cfg["model"].get("backbone") or {}
    pc = [float(v) for v in rd["pc_range"]]
    vs = [float(v) for v in rd["voxel_size"]]
    gw = int(round((pc[3] - pc[0]) / vs[0]))
    gh = int(round((pc[4] - pc[1]) / vs[1]))
    # a 3-D voxel reader (z bins comparable to x / y, against the pillar
    # readers' one full-height bin) tracks voxel occupancy
    three_d = "voxel_capacity" in rd or (pc[5] - pc[2]) / vs[2] > 4
    gd = int(round((pc[5] - pc[2]) / vs[2])) if three_d else 1
    strides = [int(s) for s in bb.get("ds_layer_strides", [])]
    kernels = [int(k) for k in bb.get("kernel_size", [3] * len(strides))]

    n_stage = len(strides) + (1 if three_d else 0)  # + the extra z-conv
    occ_max = 0
    stage_max = [0] * n_stage
    for xyz in frames(cfg, args):
        ix = np.floor((xyz[:, 0] - pc[0]) / vs[0]).astype(np.int64)
        iy = np.floor((xyz[:, 1] - pc[1]) / vs[1]).astype(np.int64)
        ok = (ix >= 0) & (ix < gw) & (iy >= 0) & (iy < gh)
        if three_d:
            iz = np.floor((xyz[:, 2] - pc[2]) / vs[2]).astype(np.int64)
            ok = ok & (iz >= 0) & (iz < gd)
            occ = np.zeros((gd, gh, gw), bool)
            occ[iz[ok], iy[ok], ix[ok]] = True
        else:
            occ = np.zeros((gh, gw), bool)
            occ[iy[ok], ix[ok]] = True
        occ_max = max(occ_max, int(occ.sum()))
        for i, (k, s) in enumerate(zip(kernels, strides)):
            if s > 1:
                occ = pool_or(occ, k, s)
            stage_max[i] = max(stage_max[i], int(occ.sum()))
        if three_d:
            occ = pool_or_z(occ)
            stage_max[len(strides)] = max(stage_max[len(strides)], int(occ.sum()))

    # MVF's second view: (phi, z) cylinder occupancy (models/mvf_encoder.py)
    if "cylinder_range" in rd:
        cyl = [float(v) for v in rd["cylinder_range"]]
        cvs = [float(v) for v in rd["cylinder_size"]]
        cw = int(round((cyl[3] - cyl[0]) / cvs[0]))
        ch = int(round((cyl[4] - cyl[1]) / cvs[1]))
        cyl_max = 0
        for xyz in frames(cfg, args):
            ok = np.ones(len(xyz), bool)
            for ax in range(3):
                ok &= (xyz[:, ax] >= pc[ax]) & (xyz[:, ax] < pc[ax + 3])
            q = xyz[ok]
            phi = np.arctan2(q[:, 1], q[:, 0]) / np.pi * 180.0
            uc = np.clip(np.floor((phi - cyl[0]) / cvs[0]).astype(np.int64), 0, cw - 1)
            vc = np.clip(np.floor((q[:, 2] - cyl[1]) / cvs[1]).astype(np.int64), 0, ch - 1)
            cyl_max = max(cyl_max, len(np.unique(vc * cw + uc)))
        print(f"max cylinder occupancy: {cyl_max} @{ch}x{cw}")
        print(f"recommended reader.cylinder_capacity: {round_up(int(cyl_max * args.margin))}  (margin {args.margin}x)")

    cap = round_up(int(occ_max * args.margin))
    knob = "reader.voxel_capacity" if three_d else "reader.pillar_capacity"
    grid = (gd, gh, gw) if three_d else (gh, gw)
    print(f"frames={args.frames}  grid={'x'.join(str(d) for d in grid)}")
    print(f"max {'voxel' if three_d else 'pillar'} occupancy: {occ_max}")
    print(f"recommended {knob}: {cap}  (margin {args.margin}x)")
    if n_stage:
        # a fraction may exceed 1.0: a 3-D strided conv's dilation can grow
        # the active set before its 8:1 merge wins
        fracs = [round(stage_max[i] * args.margin / cap, 3) for i in range(n_stage)]
        print("per-stage max active set:", stage_max)
        print(f"recommended backbone.stage_capacity_frac: {fracs}")
        print("(train overflow fails loudly; serving repairs via AdaptivePredictor — margins can be tight)")


if __name__ == "__main__":
    main()
